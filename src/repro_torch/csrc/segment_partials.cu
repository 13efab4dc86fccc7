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
// one add per sale, so bytes bound it in principle. In practice the ordered
// adds do: every (s, g, c) sum is one ordered chain, so a (lane, block)'s
// rows are one warp's serial walk, ~8 warps an SM at S=32, and each 32-row
// step waits on a chain of shared-memory round trips. On the H100, staging
// the rows through the ring alone runs several times faster than the whole
// kernel, and grouping a step's rows by winner with __match_any_sync (the
// first design) was slower than the shared-memory masks used here.
//
// What the design does about it. One warp (CTA) per (lane, block), so all
// 1,024 chains at S=32 are resident at once. Loading is decoupled from
// adding: the chain's rows go through a ring of kStages chunks of kChunk
// (winner, price) rows in shared memory, copied by cp.async, 16 bytes at a
// time (the at most two partial 16-byte segments of a chunk, at a window's
// edges or a lane that starts off a 16-byte boundary, by 4-byte copies),
// so three chunks (12 KB, ~96 KB an SM) are in flight while the warp adds
// the fourth. The warp adds a chunk 32 rows at a time onto the block's C
// running sums in shared memory: the rows with the same winner are a group
// whose lowest row adds the group's prices in row order (add_steps). The
// groups come from shared-memory atomicOr masks, built for 4 steps at once
// when C <= 512 (20 bytes of shared memory a campaign) and step by step
// above (8 bytes), not from __match_any_sync. So every sum is added in
// event order and there are no float atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "auction_tile.cuh"

namespace {

constexpr int kChunk = 512;                   // rows per staged chunk
constexpr int kStages = 4;                    // chunks in the ring
constexpr int kSlot = kChunk + 4;             // + the up to 3 rows before a
                                              // chunk's 16-byte boundary
constexpr int kSteps = kChunk / 32;           // 32-row adds per chunk
constexpr size_t kRingBytes = (size_t)kStages * kSlot * 2 * 4;
// Steps whose masks are built at once: 4 while the sums and masks (20
// bytes a campaign) leave room for ~8 CTAs an SM, else 1 (8 bytes).
constexpr int kHoistMaxCampaigns = 512;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r1) of a lane's 4-byte column into a ring slot: dst[i] holds
// src[r0 - shift + i], where r0 - shift is the row at the 16-byte boundary
// at or below r0. Whole 16-byte segments inside [r0, r1) go by one copy,
// the partial ones element by element; nothing outside [r0, r1) is read.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long r0,
                                           long long r1, int shift,
                                           int lane) {
  const long long first = r0 - shift;
  const int n_seg = (int)((r1 - first + 3) / 4);
  for (int seg = lane; seg < n_seg; seg += 32) {
    const long long e0 = first + 4 * seg;
    if (e0 >= r0 && e0 + 4 <= r1) {
      cp_async16(dst + 4 * seg, src + e0);
    } else {
      for (int j = 0; j < 4; ++j)
        if (e0 + j >= r0 && e0 + j < r1)
          cp_async4(dst + 4 * seg + j, src + e0 + j);
    }
  }
}

// One warp adds kSub steps of 32 rows onto the running sums `acc` in row
// order: row 32k + lane has winner win[k] and price p[32k + lane]. Each row
// ORs its lane's bit into masks[k * C + winner], a shared-memory mask per
// (step, campaign) that is 0 between calls, so after one barrier every row
// reads its peers (the step's rows with its winner) without
// __match_any_sync, for all kSub steps at once. Then, step by step, the
// lowest row of each group adds the group's prices in row order and clears
// the mask: acc[c] takes exactly the adds a sequential loop over the rows
// would make, with no float atomics. Rows with a negative winner add
// nothing. All 32 lanes must call it.
template <int kSub>
__device__ __forceinline__ void add_steps(float* acc, unsigned* masks, int C,
                                          const int* win, const float* p,
                                          int lane) {
  const unsigned bit = 1u << lane, lower = bit - 1u;
#pragma unroll
  for (int k = 0; k < kSub; ++k)
    if (win[k] >= 0) atomicOr(&masks[k * C + win[k]], bit);
  __syncwarp();
  unsigned peers[kSub];
#pragma unroll
  for (int k = 0; k < kSub; ++k)
    peers[k] = win[k] >= 0 ? masks[k * C + win[k]] : 0u;
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kSub; ++k) {
    const int w = win[k];
    if (w >= 0 && (peers[k] & lower) == 0u) {
      float a = acc[w];
      for (unsigned m = peers[k]; m != 0u; m &= m - 1u)
        a += p[32 * k + __ffs(m) - 1];
      acc[w] = a;
      masks[k * C + w] = 0u;
    }
    __syncwarp();
  }
}

template <int kSub>
__global__ void __launch_bounds__(32)
segment_partials_kernel(const int32_t* __restrict__ winners,   // (S, n)
                        const float* __restrict__ prices,      // (S, n)
                        const int32_t* __restrict__ lo,        // (S,) global
                        const int32_t* __restrict__ hi,        // (S,) global
                        float* __restrict__ parts,             // (S, G, C)
                        int n, int C, int offset, int block_size, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* ring_w = reinterpret_cast<int32_t*>(smem);      // (kStages, kSlot)
  float* ring_p = reinterpret_cast<float*>(ring_w + kStages * kSlot);
  float* acc = ring_p + kStages * kSlot;                    // (C,) sums
  unsigned* masks = reinterpret_cast<unsigned*>(acc + C);   // (kSub, C)
  const int s = blockIdx.x;
  const int g = blockIdx.y;
  const int lane = threadIdx.x;
  for (int c = lane; c < C; c += 32) acc[c] = 0.0f;
  for (int c = lane; c < kSub * C; c += 32) masks[c] = 0u;

  // this block's rows inside the lane's window and the slice, local index
  const long long g0 = (long long)g * block_size;
  const long long a = max(g0, (long long)max(lo[s], offset)) - offset;
  const long long b =
      min(min(g0 + block_size, (long long)hi[s]), (long long)offset + n) -
      offset;
  const int32_t* w_lane = winners + (size_t)s * n;
  const float* p_lane = prices + (size_t)s * n;
  // kChunk is a multiple of 4 rows, so every chunk has these shifts
  const int w_shift = (int)((reinterpret_cast<uintptr_t>(w_lane + a) >> 2) & 3);
  const int p_shift = (int)((reinterpret_cast<uintptr_t>(p_lane + a) >> 2) & 3);
  const int n_chunks = a < b ? (int)((b - a + kChunk - 1) / kChunk) : 0;

  auto stage = [&](int k) {
    const long long r0 = a + (long long)k * kChunk;
    const long long r1 = min(r0 + kChunk, b);
    const int slot = k % kStages;
    stage_rows(ring_w + slot * kSlot, w_lane, r0, r1, w_shift, lane);
    stage_rows(ring_p + slot * kSlot, p_lane, r0, r1, p_shift, lane);
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n_chunks) stage(k);
    cp_commit();
  }
  for (int k = 0; k < n_chunks; ++k) {
    // the slot of chunk k + kStages - 1 held chunk k - 1, whose adds every
    // lane has finished (the closing __syncwarp)
    if (k + kStages - 1 < n_chunks) stage(k + kStages - 1);
    cp_commit();
    cp_wait<kStages - 1>();           // chunk k has landed
    __syncwarp();

    const int slot = k % kStages;
    const int rows = (int)min((long long)kChunk, b - a - (long long)k * kChunk);
    const int32_t* w = ring_w + slot * kSlot + w_shift;
    const float* p = ring_p + slot * kSlot + p_shift;
    int win[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int row = 32 * i + lane;
      win[i] = row < rows ? w[row] : -1;
      if (win[i] >= C) win[i] = -1;     // never index past the sums
    }
#pragma unroll
    for (int i = 0; i < kSteps; i += kSub) {
      if (32 * i >= rows) break;
      add_steps<kSub>(acc, masks, C, &win[i], p + 32 * i, lane);
    }
    __syncwarp();
  }

  float* out = parts + ((size_t)s * G + g) * C;
  for (int c = lane; c < C; c += 32) out[c] = acc[c];
}

template <int kSub>
int launch(const int32_t* winners, const float* prices, const int32_t* lo,
           const int32_t* hi, float* parts, int S, int n, int C, int offset,
           int block_size, int G, cudaStream_t stream) {
  auto kernel = segment_partials_kernel<kSub>;
  const size_t dyn = kRingBytes + (size_t)C * 4 * (1 + kSub);
  if (dyn > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(S, G), 32, dyn, stream>>>(winners, prices, lo, hi, parts, n,
                                          C, offset, block_size, G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (S, G, C) event-ordered partials of each lane's window. Returns the
// cudaError_t of the launch.
int sp_segment_partials(const int32_t* winners, const float* prices,
                        const int32_t* lo, const int32_t* hi, float* parts,
                        int S, int n, int C, int offset, int block_size, int G,
                        cudaStream_t stream) {
  return C <= kHoistMaxCampaigns
             ? launch<4>(winners, prices, lo, hi, parts, S, n, C, offset,
                         block_size, G, stream)
             : launch<1>(winners, prices, lo, hi, parts, S, n, C, offset,
                         block_size, G, stream);
}

// Largest C whose running sums and one step's masks fit the kernel's
// shared memory beside its ring of staged rows.
int sp_max_campaigns(void) {
  return (int)((auction_tile::kMaxSmem - kRingBytes) / 8);
}

}  // extern "C"
