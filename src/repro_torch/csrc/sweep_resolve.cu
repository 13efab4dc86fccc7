// Hand-written Hopper (sm_90a) kernel: S scenario lanes resolved against one
// shared valuation matrix.
//
// Replaces the Pallas TPU kernel `sweep_resolve_pallas` of
// repro/kernels/auction_resolve/sweep_resolve.py (:81, body `_kernel` :37).
//
// What it computes. For every lane s and event n: bid = values[n, c] *
// mult[s, c]; eligible = active & bid > reserve[s], with the activation an
// (S, C) mask or an (S, N, C) per-event mask; the winner is the first index
// of the largest eligible bid (-1 if none); first price pays the top bid,
// second price max(second-largest eligible bid, reserve); no sale pays 0.
// Out: winners (S, N) int32, prices (S, N) float32 and each lane's spend
// sums (S, C).
//
// What bounds it on the H100. It reads the (N, C) valuations once (400 MB at
// N=1e6, C=100) and writes winners and prices (256 MB at S=32): ~0.2 ms at
// 3.35 TB/s. Issue is the higher floor: 4.28 instructions a (lane, event,
// campaign) for first price (a multiply, a compare, two selects, 9/32 of a
// shared load), 3.2e9 of them at S=32, ~0.41 ms at 128 thread-instructions
// a cycle on 132 SMs at 1.98 GHz (second price ~0.60 ms).
//
// What the design does about it. The resolve core is round_fused.cu's
// partials pass (lane_resolve.cuh, shared by both sources) with every
// lane's window the whole log: one launch of one CTA per SM taking items
// of (canonical block g, up to 8 lanes), the rows staged by TMA through a
// ring of three slots and scanned one thread a row for all the item's
// lanes, warps 8 + l adding lane l's prices in row order onto the item's
// running sums over the next tile's stages. Here the core also stores each
// tile's winners and prices from shared memory, a 512-event row segment
// per lane, coalesced, spread over the next tile's stages like the adds.
// The spend sums are deterministic: each item adds its block's prices per
// campaign in event order into (S, G, C) partials, and `fold_kernel` folds
// them over g = 0 .. G-1 in order, as segments.fold_blocks does. The TPU
// kernel sums each tile as a tree, so the sums agree with it to float32
// tolerance, not bit for bit.
// The (S, N, C) mask is read from device memory per element, uncoalesced:
// it is off the main path.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_resolve.cuh"

namespace {

// sums[s, c] = parts[s, 0, c] + parts[s, 1, c] + ... in order of g.
__global__ void fold_kernel(const float* __restrict__ parts,   // (S, G, C)
                            float* __restrict__ sums,          // (S, C)
                            int S, int C, int G) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)S * C) return;
  const long long s = i / C, c = i % C;
  const float* p = parts + (size_t)s * G * C + c;
  float sum = p[0];
  for (int g = 1; g < G; ++g) sum = sum + p[(size_t)g * C];
  sums[i] = sum;
}

}  // namespace

extern "C" {

// Resolve S lanes; `per_event` says whether `act` is (S, N, C) or (S, C).
// `parts` is (S, G, C) scratch for the ordered block sums. Returns the
// cudaError_t of the launches.
int sr_sweep_resolve(const float* values, const float* mult,
                     const uint8_t* act, const float* reserves,
                     int32_t* winners, float* prices, float* parts,
                     float* sums, int S, int N, int C, int block_size, int G,
                     int second_price, int per_event, cudaStream_t stream) {
  using lane_resolve::launch;
  lane_resolve::Args a{values, mult, act, reserves, nullptr, nullptr,
                       nullptr, parts, winners, prices, S, N, C, 0, N,
                       block_size, G, 0, 0};
  int err = per_event
                ? (second_price ? launch<true, true, true>(a, stream)
                                : launch<false, true, true>(a, stream))
                : (second_price ? launch<true, true, false>(a, stream)
                                : launch<false, true, false>(a, stream));
  if (err != 0) return err;
  const long long cells = (long long)S * C;
  fold_kernel<<<(unsigned)((cells + 255) / 256), 256, 0, stream>>>(
      parts, sums, S, C, G);
  return (int)cudaGetLastError();
}

// Largest C the kernel takes: a one-lane item's multipliers and running sums
// in shared memory.
int sr_max_campaigns(void) { return lane_resolve::campaign_limit(); }

}  // extern "C"
