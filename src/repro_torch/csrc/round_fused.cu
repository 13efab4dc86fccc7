// Hand-written Hopper (sm_90a) kernels for one fused Algorithm-2 round.
//
// Replaces the Pallas TPU kernels of repro/kernels/auction_resolve/
// round_fused.py: `sweep_partials_pallas` (:301, body `_partials_kernel`
// :266 with `_resolve_tile` :66 and `_accumulate_partials` :92) and
// `round_fused_pallas` (:197, body `_round_kernel` :130 with `_predict_all`
// :110).
//
// What they compute. S scenario lanes share one (N, C) valuation matrix.
// For each lane s, a partials pass resolves the auctions of the events in
// the lane's window [lo[s], hi[s]) (bid = value * multiplier, eligible when
// active and bid > reserve, first or second price) and reduces the spends
// onto the canonical (S, G = 32, C) grid: parts[s, g, c] is the spend of
// campaign c over the events of canonical block g, added in event order.
// `predict_kernel` folds the rate partials over g in order and predicts the
// next cap-out per lane (c_next, no_cap, n_next). A round is partials over
// [n_hat, N), predict, partials over [n_hat, n_next); the last launch reads
// n_next from device memory, so a round needs no host round trip. Winners
// and prices never leave shared memory.
//
// What bounds it on the H100. A full-day pass (N=1e6, C=100, S=32) reads
// the 400 MB of valuations once from HBM: 0.12 ms at 3.35 TB/s. Issue is
// the higher floor: per (lane, row, campaign) a multiply, a compare and two
// selects (first price; a max and a select more for second price) and
// 9/32 of a shared load, 4.28 instructions for 3.2e9 elements, 0.41 ms at
// 128 thread-instructions a cycle on 132 SMs at 1.98 GHz (second price
// 0.60 ms). On an H100 the pass runs at about a third of that floor
// (chip_smoke.py); what holds the scan there (the compares and selects,
// which issue at half the multiplies' rate, the per-stage barriers) is not
// measured apart. A late-round
// pass (every lane's window the last half of one canonical block) is 1/64
// of the work, all of it in one block.
//
// What the design does about it (lane_resolve.cuh, the core shared with
// sweep_resolve.cu; a copy of the core written out in this source ran
// at the same speed on an H100, tools/core_written_out.py):
//  * the time of a pass follows the live rows: one launch of one CTA per
//    SM, whose CTAs read the windows and take work items of (canonical
//    block, up to 8 lanes), as many lanes as still give most SMs an item:
//    8 at a full-day pass (each row read from L2 four times), 1 when the
//    windows lie in one block (32 items at S=32);
//  * loads overlap the scan: TMA copies 512-row, 16-column stages into a
//    ring of three slots, each completing on its own mbarrier;
//  * a thread scans one row for all the item's lanes, so a 16-byte shared
//    load of four valuations feeds 4 * L bids and a broadcast load of four
//    multipliers four: (1 + L) / (4 L) shared loads an element;
//  * the ordered adds run over the next tile's stages: warp 8 + l adds
//    lane l's tile 32 rows at a time, each same-winner group's prices held
//    in registers, onto shared-memory running sums. No float atomics.
// Any C up to rf_max_campaigns() (a one-lane item's multipliers and
// running sums in shared memory) runs; an item takes fewer lanes as C
// grows. Built with --fmad=false so that (b - s_hat) / rate and the sums
// round as the reference rounds them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "auction_tile.cuh"
#include "lane_resolve.cuh"

namespace {

constexpr int kThreads = 256;               // predict_kernel
constexpr int kWarps = kThreads / 32;

// (v, i) := smaller value, then lower index (first minimum).
__device__ __forceinline__ void keep_min(float& v, int& i, float v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__global__ void __launch_bounds__(kThreads)
predict_kernel(const float* __restrict__ rate_parts,  // (S, G, C)
               const float* __restrict__ budgets,     // (S, C)
               const float* __restrict__ s_hat,       // (S, C)
               const uint8_t* __restrict__ act,       // (S, C) bool
               const int32_t* __restrict__ n_hat,     // (S,)
               int32_t* __restrict__ c_next,          // (S,)
               uint8_t* __restrict__ no_cap,          // (S,) bool
               int32_t* __restrict__ n_next,          // (S,)
               int C, int G, int n_events) {
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float denom = (float)max(n_events - n_hat[s], 1);

  float best = INFINITY;
  int arg = 0x7fffffff;
  for (int c = tid; c < C; c += kThreads) {
    const float* p = rate_parts + (size_t)s * G * C + c;
    float sum = p[0];
    for (int g = 1; g < G; ++g) sum = sum + p[(size_t)g * C];
    const float rate = sum / denom;
    const size_t sc = (size_t)s * C + c;
    float ttl = (act[sc] && rate > 0.0f) ? (budgets[sc] - s_hat[sc]) / rate
                                         : INFINITY;
    if (ttl < 0.0f) ttl = 0.0f;
    keep_min(best, arg, ttl, c);
  }
  for (int d = 16; d > 0; d >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, best, d);
    const int i2 = __shfl_xor_sync(0xffffffffu, arg, d);
    keep_min(best, arg, v2, i2);
  }
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = arg;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) keep_min(best, arg, red_v[w], red_i[w]);
    const bool none = isinf(best);
    const int step = (int)fminf(floorf(best), (float)n_events);
    c_next[s] = min(arg, C - 1);
    no_cap[s] = none ? 1 : 0;
    n_next[s] = none ? n_events : min(n_hat[s] + step, n_events);
  }
}

}  // namespace

extern "C" {

// One partials pass (the port of sweep_partials_pallas). `hi` may be null:
// the window then runs to the end of the log. Returns the cudaError_t of the
// launch.
int rf_sweep_partials(const float* values, const float* mult,
                      const uint8_t* act, const float* reserves,
                      const int32_t* lo, const int32_t* hi,
                      const uint8_t* alive, float* parts, int S, int n_local,
                      int C, int offset, int n_global, int block_size, int G,
                      int second_price, int skip_retired,
                      cudaStream_t stream) {
  lane_resolve::Args a{values, mult, act, reserves, lo, hi, alive, parts,
                       nullptr, nullptr, S, n_local, C, offset, n_global,
                       block_size, G, skip_retired, 0};
  return second_price ? lane_resolve::launch<true, false, false>(a, stream)
                      : lane_resolve::launch<false, false, false>(a, stream);
}

// The cap-out prediction from (S, G, C) rate partials (the port of
// _predict_all). Returns the cudaError_t of the launch.
int rf_predict(const float* rate_parts, const float* budgets,
               const float* s_hat, const uint8_t* act, const int32_t* n_hat,
               int32_t* c_next, uint8_t* no_cap, int32_t* n_next, int S,
               int C, int G, int n_events, cudaStream_t stream) {
  predict_kernel<<<S, kThreads, 0, stream>>>(rate_parts, budgets, s_hat, act,
                                             n_hat, c_next, no_cap, n_next, C,
                                             G, n_events);
  return (int)cudaGetLastError();
}

// Largest C the partials kernel takes: a one-lane item's multipliers and
// running sums in shared memory.
int rf_max_campaigns(void) { return lane_resolve::campaign_limit(); }

// The most lanes an item of the partials kernel takes at C campaigns (8, 4,
// 2 or 1; 0 past rf_max_campaigns()).
int rf_item_lanes(int C) {
  return lane_resolve::max_lanes(C, lane_resolve::kDynLimit);
}

}  // extern "C"
