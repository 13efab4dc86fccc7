// Hand-written Hopper (sm_90a) kernel: event-ordered canonical partials of
// resolved auctions.
//
// Replaces no Pallas kernel. On the TPU this work is XLA's scatter-add
// (`jax.ops.segment_sum` in repro/core/segments.py:130,
// `partial_spend_sums`), which adds in event order. The port's plain version
// is `torch.Tensor.index_add_`: in event order on the CPU, with atomics in
// an order that changes from run to run on CUDA. Algorithm 2 turns a last-bit
// difference in a rate into another floor(time-to-live) and so another
// trajectory, so the CUDA path needs this kernel to give the CPU's bits.
//
// What it computes. S lanes of resolved events, winners (S, n) int32 (-1 =
// no sale) and prices (S, n) float32, the rows being global events
// [offset, offset + n). For lane s and canonical block g (block_size events
// each), parts[s, g, c] is the sum of the prices of the events of block g
// inside the lane's window [lo[s], hi[s]) that campaign c won, added in
// event order starting from 0.0: exactly the CPU's index_add_ (rows outside
// the window add an exact +0.0 there, so skipping them is exact).
//
// What bounds it on the H100. It reads each winner and price once (8 bytes
// per (lane, event): 256 MB at S=32, N=1e6, ~0.08 ms at 3.35 TB/s) and does
// one add per sale, so bytes bound it.
//
// What the design does about it. One warp (CTA) per (lane, block) walks its
// rows 32 at a time, four such loads in flight before they are added, with
// the block's C running sums in shared memory. The rows of 32 with the same
// winner are one __match_any_sync group whose lowest row adds the group's
// prices in row order (auction_tile.cuh's add_in_row_order), so every sum is
// added in event order and there are no float atomics. S * 32 warps keep
// all SMs busy at S=32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "auction_tile.cuh"

namespace {

constexpr int kBatch = 4;                     // 32-row loads in flight
constexpr size_t kStaticSmem = 32 * sizeof(float);

__global__ void __launch_bounds__(32)
segment_partials_kernel(const int32_t* __restrict__ winners,   // (S, n)
                        const float* __restrict__ prices,      // (S, n)
                        const int32_t* __restrict__ lo,        // (S,) global
                        const int32_t* __restrict__ hi,        // (S,) global
                        float* __restrict__ parts,             // (S, G, C)
                        int n, int C, int offset, int block_size, int G) {
  __shared__ float warp_prices[32];
  extern __shared__ float acc[];              // (C,) running sums
  const int s = blockIdx.x;
  const int g = blockIdx.y;
  const int lane = threadIdx.x;
  for (int c = lane; c < C; c += 32) acc[c] = 0.0f;
  __syncwarp();

  // this block's rows inside the lane's window and the slice, local index
  const long long g0 = (long long)g * block_size;
  const long long a = max(g0, (long long)max(lo[s], offset)) - offset;
  const long long b =
      min(min(g0 + block_size, (long long)hi[s]), (long long)offset + n) -
      offset;
  const int32_t* w_lane = winners + (size_t)s * n;
  const float* p_lane = prices + (size_t)s * n;
  for (long long base = a; base < b; base += 32 * kBatch) {
    int win[kBatch];
    float price[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const long long row = base + k * 32 + lane;
      win[k] = -1;
      price[k] = 0.0f;
      if (row < b) {
        win[k] = w_lane[row];
        price[k] = p_lane[row];
      }
      if (win[k] >= C) win[k] = -1;           // never index past the sums
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      warp_prices[lane] = price[k];
      __syncwarp();
      auction_tile::add_in_row_order(acc, win[k], warp_prices, lane);
      __syncwarp();
    }
  }

  float* out = parts + ((size_t)s * G + g) * C;
  for (int c = lane; c < C; c += 32) out[c] = acc[c];
}

}  // namespace

extern "C" {

// (S, G, C) event-ordered partials of each lane's window. Returns the
// cudaError_t of the launch.
int sp_segment_partials(const int32_t* winners, const float* prices,
                        const int32_t* lo, const int32_t* hi, float* parts,
                        int S, int n, int C, int offset, int block_size, int G,
                        cudaStream_t stream) {
  const size_t dyn = (size_t)C * sizeof(float);
  if (kStaticSmem + dyn > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(S, G);
  segment_partials_kernel<<<grid, 32, dyn, stream>>>(
      winners, prices, lo, hi, parts, n, C, offset, block_size, G);
  return (int)cudaGetLastError();
}

// Largest C whose running sums fit the kernel's shared memory.
int sp_max_campaigns(void) {
  return (int)((auction_tile::kMaxSmem - kStaticSmem) / sizeof(float));
}

}  // extern "C"
