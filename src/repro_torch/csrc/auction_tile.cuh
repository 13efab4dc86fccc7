// Device code shared by the port's auction kernels (round_fused.cu,
// sweep_resolve.cu, segment_partials.cu): the tile shape of the resolve
// kernels, and the ordered same-winner group add that keeps every
// per-campaign sum in event order without float atomics.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace auction_tile {

constexpr int kLanes = 4;                    // scenario lanes per CTA
constexpr int kRows = 64;                    // rows per tile
constexpr int kThreads = kLanes * kRows;     // one thread per (lane, row)
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;                   // campaigns staged at a time
constexpr size_t kMaxSmem = 232448;          // per-block opt-in limit, sm_90

// One warp adds its 32 rows' prices onto the per-campaign running sums
// `acc` in row order. The rows with the same winner form a group
// (__match_any_sync); the group's lowest row adds the group's prices, read
// from `warp_prices` (one per row of the warp), in ascending row order, so
// acc[c] takes exactly the adds a sequential loop over the rows would make.
// Rows with a negative winner add nothing. All 32 threads of the warp must
// call it.
__device__ __forceinline__ void add_in_row_order(float* acc, int winner,
                                                 const float* warp_prices,
                                                 int lane) {
  const unsigned peers = __match_any_sync(0xffffffffu, winner);
  const unsigned lower = (1u << lane) - 1u;
  if (winner >= 0 && (peers & lower) == 0) {
    float a = acc[winner];
    for (unsigned m = peers; m != 0u; m &= m - 1u)
      a += warp_prices[__ffs(m) - 1];
    acc[winner] = a;
  }
}

}  // namespace auction_tile
