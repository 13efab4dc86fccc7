// Device code shared by the bf16 tensor-core attention kernels
// (flash_attention.cu's forward, flash_attention_bwd.cu's backward):
// XOR-swizzled bf16 tiles in shared memory, 16-byte cp.async with
// zero-fill, ldmatrix fragment loads and the bf16 mma.sync.m16n8k16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tensor_tiles {

using bf16 = __nv_bfloat16;

// Element offset of 16-byte chunk `chunk` of row `row` in a swizzled tile
// of DH bf16 a row. The eight rows an ldmatrix reads at one chunk column
// fall on eight distinct 16-byte bank groups: for rows of 128 bytes or
// more the chunk index is XORed with the row's low 3 bits; shorter rows
// share a 128-byte line, and the chunk's place in the line is XORed with
// the line's index. A warp's 16 rows never leave their own lines.
template <int DH>
__device__ __forceinline__ int swz(int row, int chunk) {
  if constexpr (DH >= 64) {
    return row * DH + ((chunk ^ (row & 7)) << 3);
  } else {
    const int lin = row * (DH / 8) + chunk;
    return (lin ^ ((lin >> 3) & 7)) << 3;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, asynchronously; src_bytes 0
// zero-fills the destination (the source address must still be valid).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c (16x8, float32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two floats as bf16 pairs hi + lo: hi rounds them, lo rounds what hi
// leaves, so hi + lo carries 16 significant bits of each (the error is
// 2^-16 of the value, not bf16's 2^-9).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// Rows [row0, row0 + ROWS) of one head (DH bf16 at `base + s * row_stride`)
// into a swizzled tile by cp.async, THREADS threads sharing the copies;
// rows at or past S are zero-filled.
template <int DH, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* tile,
                                          const bf16* __restrict__ src,
                                          long base, long row_stride, int row0,
                                          int S) {
  constexpr int kChunks = DH / 8;    // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += THREADS) {
    const int r = idx / kChunks, c = idx % kChunks, s = row0 + r;
    const bf16* from = src + base + (long)min(s, S - 1) * row_stride + c * 8;
    cp_async16(tile + swz<DH>(r, c), from, s < S ? 16 : 0);
  }
}

// The A fragment (16 rows x 16 columns) of the m16n8k16 product from the
// 16 float32 accumulators of two adjacent n-tiles (columns [0, 8) and [8,
// 16)): the m16n8 accumulator layout is the A layout, each pair rounded
// once to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

}  // namespace tensor_tiles
