// Hand-written Hopper (sm_90a) kernels: causal, optionally sliding-window,
// attention forward with an online softmax, on the tensor cores: bfloat16
// inputs through bf16 mma.sync, float32 inputs through split TF32.
//
// Replaces repro/kernels/flash_attention/flash_attention.py:82
// `flash_attention_pallas` (its `_kernel`, :25-79). The port's model sends
// every prefill attention layer here (repro_torch/models/attention.py
// `causal_attention`), 24 launches per stablelm-1.6b prefill, all bf16.
//
// What it computes. q (B, S, H, dh), k and v (B, S, KV, dh), all float32 or
// all bfloat16, in the model's layout; query head h reads kv head
// h / (H / KV) (GQA without a repeated copy). For each (b, h, row i):
//   scores_j = (q_i . k_j) * scale, scale = 1 / sqrtf(dh) in float32;
//   masked to NEG = -2^30 unless (j <= i if causal) and (j > i - window if
//   a window is given);
//   out_i = sum_j softmax(scores)_j v_j, in q's dtype,
// the online softmax of the Pallas kernel: per kv block, m_new = max(m,
// max_j s_j), p_j = exp(s_j - m_new), alpha = exp(m - m_new), l = alpha*l
// + sum_j p_j, acc = alpha*acc + sum_j p_j v_j; at the end acc / max(l,
// 1e-30), rounded once to q's dtype. Kv blocks entirely above the causal
// frontier or outside the window are skipped, as the Pallas kernel's
// `relevant` test does (:40-44). S need not divide the blocks: rows past S
// are not written, and keys past S are masked and staged as zeros.
// The tensor cores take bf16 operands, so the bf16 kernel feeds them each
// probability p_j as two bf16 terms, hi = bf16(p_j) and lo = bf16(p_j -
// hi): 16 significant bits instead of bf16's 8, which keeps it within the
// plain version's float32 probabilities as closely as the float32 kernel
// (the output rounding to bf16 is then the only visible difference).
//
// What bounds it on the H100. At stablelm-1.6b's prefill (B=8, S=2048,
// H=32, dh=64, causal, bf16) the causal half of QK^T and PV is 1.375e11
// operations: 0.139 ms at the 989 TFLOP/s bf16 tensor-core peak, 2.05 ms at
// the 67 TFLOP/s float32 rate of CUDA cores. q, k, v and o are 268 MB in
// bf16, 0.08 ms at 3.35 TB/s. So the operations bound it; the split P makes
// the PV product two tensor-core passes, 1.5x the multiplies of a kernel
// that rounds P once. In float32 split TF32 takes three TF32 products for
// one float32 product: 4.1e11 operations, 0.83 ms at the 495 TFLOP/s dense
// TF32 peak (against 2.05 ms on CUDA cores).
//
// What the bf16 design does about it (`flash_tc_kernel`, the
// FlashAttention-2 shape on mma.sync). One CTA per (b, h, 128 query rows),
// 8 warps of 16 rows each (64 rows and 4 warps at dh=256, where the
// accumulator takes 128 registers a thread), two CTAs an SM at dh <= 64;
// the CTAs of the last query tiles, the heaviest under a causal mask, are
// launched first. Q is copied once by 16-byte cp.async into XOR-swizzled
// shared memory and loaded by ldmatrix into A fragments, which stay in
// registers across the kv loop for dh <= 128 (at dh=256 they are reloaded
// from shared memory per k-step). K and V tiles of 64 rows go through a
// cp.async ring of three stages (two at dh=256): the next tile is in
// flight while the current one multiplies, with one barrier a tile. S =
// Q K^T is mma.sync.m16n8k16 (bf16 in, float32 accumulators; the products
// of bf16 values are exact, only the order of the float32 sum differs from
// the plain version). The softmax stays in registers: a row lies on a quad
// of 4 threads, so its max takes 2 shuffles, and m, l and alpha never leave
// registers. P's accumulator fragments are the A operands of O += P V
// directly (the m16n8 accumulator layout is the m16n8k16 A layout), split
// into hi and lo in registers; V comes in by ldmatrix.trans. The output is
// divided by max(l, 1e-30), rounded once to bf16 and written with 16-byte
// stores through shared memory. No atomics and a fixed order: two launches
// give the same bits. wgmma, TMA and warp specialisation are a later PR's
// work. The swizzle, cp.async, ldmatrix and mma.sync helpers live in
// tensor_tiles.cuh, shared with the backward's bf16 kernels.
//
// The float32 design (`flash_tf32_kernel`) is the same shape in split TF32
// (3xTF32) on mma.sync.m16n8k8: each float32 operand x is hi = tf32(x),
// rounded to nearest with ties away (cvt.rna's rounding, done with integer
// operations), and lo = tf32(x - hi), and
// a b is lo_a hi_b + hi_a lo_b + hi_a hi_b in float32 accumulators (lo_a
// lo_b, below 2^-22 of the product, is dropped), for S = Q K^T and for O +=
// P V; ref.attention_split_tf32_ref repeats this rounding and the block
// order on the CPU, within the float32 tolerance of the plain version.
// One CTA per (b, h, 128 query rows), 8 warps of 16 rows (64 rows and 4
// warps at dh=256, whose accumulator takes 128 registers a thread), two
// CTAs an SM at dh <= 64; heaviest query tiles first, B*H on the grid's x
// axis. Q and a two-stage ring of K and V tiles (64 keys; 32 at dh=256)
// come in by 16-byte cp.async into rows padded by 4 floats, so every
// fragment load is on 32 distinct banks; the next tile is in flight while
// the current one multiplies. The operands are split in registers as they
// are loaded. The m16n8 accumulator gives a thread P's keys 2t and 2t + 1
// of an 8-key step where the tf32 A fragment wants columns t and t + 4: the
// kernel takes the step's keys in the permuted order (0, 2, 4, 6, 1, 3, 5,
// 7), so P's registers are A as they stand and V's B fragment loads rows 2t
// and 2t + 1; no shuffles, and the sum over a step's keys comes in that
// fixed order. The softmax stays in registers as in the bf16 kernel, with
// expf; the output is divided by max(l, 1e-30) and stored as float pairs.
// The shared memory (102 KB at dh=64, 198 KB at dh=128 and 195 KB at
// dh=256) is set with cudaFuncSetAttribute above 48 KB, as is the bf16
// kernel's (160 KB at dh=256, 128 KB at dh=128).
//
// Floats. The shared flags pass --fmad=false; the float32 kernel's products
// are the tensor cores' (split TF32), and expf (not __expf) keeps the
// float32 tolerance. The bf16 kernel takes exp(x) as exp2f(x * log2(e)),
// within a few float32 ulps of expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_tiles.cuh"

namespace {

using namespace tensor_tiles;

constexpr int kBK = 64;          // key/value rows per tile of the bf16 kernel
constexpr float kNeg = -1073741824.0f;   // -2^30, the reference's NEG

// The row logsumexp of the scaled, masked scores, m + log(l) with the
// denominator the output was divided by, for rows row_lo and row_lo + 8
// (those below S) of one (b, h): what the backward recomputes P from.
__device__ __forceinline__ void write_lse(float* __restrict__ lse, long base,
                                          int row_lo, int S, const float (&m)[2],
                                          const float (&denom)[2]) {
  if (row_lo < S) lse[base + row_lo] = m[0] + logf(denom[0]);
  if (row_lo + 8 < S) lse[base + row_lo + 8] = m[1] + logf(denom[1]);
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct TC {
  static constexpr int kWarps = DH == 256 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;    // query rows per CTA
  // K/V ring: with three stages the tile loaded next never lands in the
  // stage another warp may still read, so one barrier a tile suffices; at
  // dh=256 three stages would not fit, and two take a second barrier
  static constexpr int kStages = DH == 256 ? 2 : 3;
  static constexpr int kChunks = DH / 8;     // 16-byte chunks per row
  static constexpr int kTile = kBK * DH;     // elements of a K or V tile
  static constexpr bool kQInRegs = DH <= 128;
  static constexpr size_t kBytes =
      (size_t)(kBQ * DH + 2 * kStages * kTile) * sizeof(bf16);
};

// Two CTAs an SM for dh <= 64 (at most 128 registers a thread).
template <int DH>
__global__ void __launch_bounds__(TC<DH>::kThreads, DH <= 64 ? 2 : 1)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                float* __restrict__ lse, int S, int H, int KV, int causal,
                int window) {
  using C = TC<DH>;
  constexpr int kKSteps = DH / 16;     // k-steps of QK^T, n-tile pairs of PV
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* Ks = Qs + C::kBQ * DH;
  bf16* Vs = Ks + C::kStages * C::kTile;

  const int bh = blockIdx.x, b = bh / H, h = bh % H, g = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kBQ;   // heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const long q_row = (long)H * DH, kv_row = (long)KV * DH;
  const long q_base = (long)b * S * q_row + (long)h * DH;
  const long kv_base = (long)b * S * kv_row + (long)g * DH;
  const float scale = 1.0f / sqrtf((float)DH);

  // the kv tiles the Pallas kernel's `relevant` test keeps: a range
  int t_end = (S + kBK - 1) / kBK;
  if (causal) t_end = min(t_end, (q0 + C::kBQ - 1) / kBK + 1);
  int t_begin = 0;
  if (window > 0) {
    const int x = q0 - window - kBK + 1;   // relevant iff t * kBK > x
    t_begin = x < 0 ? 0 : x / kBK + 1;
  }

  load_tile<DH, C::kBQ, C::kThreads>(Qs, q, q_base, q_row, q0, S);
  load_tile<DH, kBK, C::kThreads>(Ks, k, kv_base, kv_row, t_begin * kBK, S);
  load_tile<DH, kBK, C::kThreads>(Vs, v, kv_base, kv_row, t_begin * kBK, S);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  const int wrow = warp * 16;          // the warp's first row in the tile
  // ldmatrix row and chunk offsets of this lane: A (and the trans'd V)
  // fragments take rows lane & 15, chunk lane >> 4; K's take keys
  // (lane & 7) + 8 * (lane >> 4), chunk (lane >> 3) & 1
  const int a_row = lane & 15, a_chunk = lane >> 4;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_chunk = (lane >> 3) & 1;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_chunk = lane >> 4;

  uint32_t qf[C::kQInRegs ? kKSteps : 1][4];
  if constexpr (C::kQInRegs) {
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks)
      ldmatrix_x4(qf[ks], Qs + swz<DH>(wrow + a_row, 2 * ks + a_chunk));
  }

  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
  float oacc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0f;

  const int row_lo = q0 + wrow + gid, row_hi = row_lo + 8;
  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) % C::kStages;
    const int nx = (st + 1) % C::kStages;
    const bf16* Kt = Ks + st * C::kTile;
    const bf16* Vt = Vs + st * C::kTile;
    // the next tile goes into stage nx, last read for tile t + 1 - kStages,
    // which every thread has left: three stages back, the previous
    // iteration's opening barrier; two, its closing one
    if (t + 1 < t_end) {
      load_tile<DH, kBK, C::kThreads>(Ks + nx * C::kTile, k, kv_base, kv_row,
                         (t + 1) * kBK, S);
      load_tile<DH, kBK, C::kThreads>(Vs + nx * C::kTile, v, kv_base, kv_row,
                         (t + 1) * kBK, S);
    }
    cp_commit();
    cp_wait<1>();                      // tile t has landed
    __syncthreads();

    // ---- S = Q K^T, 16 rows x 64 keys per warp
    float sacc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      uint32_t a[4];
      if constexpr (C::kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
      } else {
        ldmatrix_x4(a, Qs + swz<DH>(wrow + a_row, 2 * ks + a_chunk));
      }
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Kt + swz<DH>(16 * j2 + k_row, 2 * ks + k_chunk));
        mma_bf16(sacc[2 * j2], a, bk[0], bk[1]);
        mma_bf16(sacc[2 * j2 + 1], a, bk[2], bk[3]);
      }
    }

    // ---- scale, mask, online softmax in registers; element e of n-tile j
    // is row (e < 2 ? row_lo : row_hi), key c0 + 8j + 2*tig + (e & 1)
    const int c0 = t * kBK;
    const int wq0 = q0 + wrow;         // the warp's rows are [wq0, wq0 + 16)
    const bool masked = c0 + kBK > S || (causal && c0 + kBK - 1 > wq0) ||
                        (window > 0 && c0 <= wq0 + 15 - window);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sacc[j][e] * scale;
        if (masked) {
          const int col = c0 + 8 * j + 2 * tig + (e & 1);
          const int row = e < 2 ? row_lo : row_hi;
          bool keep = col < S;
          if (causal) keep = keep && col <= row;
          if (window > 0) keep = keep && col > row - window;
          s = keep ? s : kNeg;
        }
        sacc[j][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // a row's 64 scores lie on the quad of lanes sharing gid
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f((m[r] - m_new) * kLog2e);
      m[r] = m_new;
    }
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((sacc[j][e] - m[e >> 1]) * kLog2e);
        sacc[j][e] = p;
        ps[e >> 1] += p;
      }
    // l is kept per thread (its quarter of the row) and summed over the
    // quad at the end; alpha is the same for the whole row
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + ps[r];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // ---- O += P V: P's accumulator fragments of keys [16kk, 16kk + 16)
    // are the A fragments of that k-step, P = hi + lo in two bf16 terms
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(sacc[2 * kk][0], sacc[2 * kk][1], hi[0], lo[0]);
      split_bf16(sacc[2 * kk][2], sacc[2 * kk][3], hi[1], lo[1]);
      split_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int n2 = 0; n2 < kKSteps; ++n2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vt + swz<DH>(16 * kk + v_row, 2 * n2 + v_chunk));
        mma_bf16(oacc[2 * n2], hi, bv[0], bv[1]);
        mma_bf16(oacc[2 * n2 + 1], hi, bv[2], bv[3]);
        mma_bf16(oacc[2 * n2], lo, bv[0], bv[1]);
        mma_bf16(oacc[2 * n2 + 1], lo, bv[2], bv[3]);
      }
    }
    if (C::kStages == 2) __syncthreads();   // stage st is free for t + 2
  }

  // ---- epilogue: normalise, round once, stage the warp's 16 rows in its
  // own rows of Qs (only this warp reads them), 16-byte stores
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    denom[r] = fmaxf(l[r], 1e-30f);
  }
  if (lse != nullptr && tig == 0) write_lse(lse, (long)bh * S, row_lo, S, m,
                                             denom);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int off = 2 * tig;
    *reinterpret_cast<uint32_t*>(Qs + swz<DH>(wrow + gid, n) + off) =
        pack_bf16(oacc[n][0] / denom[0], oacc[n][1] / denom[0]);
    *reinterpret_cast<uint32_t*>(Qs + swz<DH>(wrow + gid + 8, n) + off) =
        pack_bf16(oacc[n][2] / denom[1], oacc[n][3] / denom[1]);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * C::kChunks; idx += 32) {
    const int r = idx / C::kChunks, c = idx % C::kChunks;
    const int row = q0 + wrow + r;
    if (row < S)
      *reinterpret_cast<uint4*>(o + q_base + (long)row * q_row + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz<DH>(wrow + r, c));
  }
}

// ---------------------------------------------------------------------------
// The float32 tensor-core kernel (split TF32)
// ---------------------------------------------------------------------------

template <int DH>
struct TF {
  static constexpr int kWarps = DH == 256 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;    // query rows per CTA
  static constexpr int kBK = DH == 256 ? 32 : 64;   // keys per kv tile
  // rows padded by one 16-byte chunk: a stride of 4 (mod 32) floats puts
  // the fragments' loads (8 rows x 4 columns of Q and K, 4 row pairs x 8
  // columns of V) on 32 distinct banks
  static constexpr int kStride = DH + 4;
  static constexpr int kChunks = DH / 4;     // 16-byte chunks per row
  static constexpr int kTile = kBK * kStride;
  static constexpr size_t kBytes =
      (size_t)(kBQ + 4 * kBK) * kStride * sizeof(float);   // Q + 2 x (K, V)
};

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero,
// the rounding of cvt.rna.tf32.f32 for finite x, in two integer operations
// (half the dropped 13 bits' range added to the magnitude, then the 13
// bits cleared), which issue faster than cvt.rna
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as hi + lo, two TF32 values: hi rounds x, lo rounds what hi leaves (x -
// hi is exact), so hi + lo carries 22 significant bits of x
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c (16x8, float32) += a (16x8, tf32, row) * b (8x8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in split TF32: lo.hi, then hi.lo, then hi.hi (the small terms
// first); lo.lo, below 2^-22 of the product, is dropped
__device__ __forceinline__ void mma_split(float (&c)[4],
                                          const uint32_t (&ahi)[4],
                                          const uint32_t (&alo)[4],
                                          float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, alo, bh0, bh1);
  mma_tf32(c, ahi, bl0, bl1);
  mma_tf32(c, ahi, bh0, bh1);
}

// Rows [row0, row0 + ROWS) of one head into a padded float32 tile by
// 16-byte cp.async; rows at or past S are zero-filled.
template <int DH, int ROWS>
__device__ __forceinline__ void load_rows(float* tile,
                                          const float* __restrict__ src,
                                          long base, long row_stride, int row0,
                                          int S) {
  using C = TF<DH>;
  for (int idx = threadIdx.x; idx < ROWS * C::kChunks; idx += C::kThreads) {
    const int r = idx / C::kChunks, c = idx % C::kChunks, s = row0 + r;
    const float* from = src + base + (long)min(s, S - 1) * row_stride + c * 4;
    cp_async16(tile + r * C::kStride + c * 4, from, s < S ? 16 : 0);
  }
}

// Two CTAs an SM for dh <= 64 (at most 128 registers a thread).
template <int DH>
__global__ void __launch_bounds__(TF<DH>::kThreads, DH <= 64 ? 2 : 1)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int S, int H, int KV, int causal,
                  int window) {
  using C = TF<DH>;
  constexpr int kTK = C::kBK;          // keys a tile
  constexpr int kDSteps = DH / 8;      // k-steps of QK^T, n-tiles of PV
  constexpr int kKeyTiles = kTK / 8;   // n-tiles of QK^T, k-steps of PV
  extern __shared__ __align__(128) unsigned char tf_smem[];
  float* Qs = reinterpret_cast<float*>(tf_smem);
  float* Ks = Qs + C::kBQ * C::kStride;
  float* Vs = Ks + 2 * C::kTile;

  const int bh = blockIdx.x, b = bh / H, h = bh % H, g = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kBQ;   // heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const long q_row = (long)H * DH, kv_row = (long)KV * DH;
  const long q_base = (long)b * S * q_row + (long)h * DH;
  const long kv_base = (long)b * S * kv_row + (long)g * DH;
  const float scale = 1.0f / sqrtf((float)DH);

  // the kv tiles the Pallas kernel's `relevant` test keeps: a range
  int t_end = (S + kTK - 1) / kTK;
  if (causal) t_end = min(t_end, (q0 + C::kBQ - 1) / kTK + 1);
  int t_begin = 0;
  if (window > 0) {
    const int x = q0 - window - kTK + 1;   // relevant iff t * kTK > x
    t_begin = x < 0 ? 0 : x / kTK + 1;
  }

  load_rows<DH, C::kBQ>(Qs, q, q_base, q_row, q0, S);
  load_rows<DH, kTK>(Ks, k, kv_base, kv_row, t_begin * kTK, S);
  load_rows<DH, kTK>(Vs, v, kv_base, kv_row, t_begin * kTK, S);
  cp_commit();

  const int wrow = warp * 16;          // the warp's first row in the tile
  // this lane's A elements of Q: rows gid and gid + 8, columns tig and
  // tig + 4 of each 8-column k-step
  const float* Qa = Qs + (wrow + gid) * C::kStride + tig;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
  float oacc[kDSteps][4];
#pragma unroll
  for (int n = 0; n < kDSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0f;

  const int row_lo = q0 + wrow + gid, row_hi = row_lo + 8;
  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    const float* Kt = Ks + st * C::kTile;
    const float* Vt = Vs + st * C::kTile;
    // the next tile goes into the other stage, which every thread left at
    // the previous iteration's closing barrier
    if (t + 1 < t_end) {
      load_rows<DH, kTK>(Ks + (st ^ 1) * C::kTile, k, kv_base, kv_row,
                         (t + 1) * kTK, S);
      load_rows<DH, kTK>(Vs + (st ^ 1) * C::kTile, v, kv_base, kv_row,
                         (t + 1) * kTK, S);
    }
    cp_commit();
    cp_wait<1>();                      // tile t (and Q) has landed
    __syncthreads();

    // ---- S = Q K^T, 16 rows x kTK keys per warp; B of n-tile j is keys
    // 8j + gid at columns tig and tig + 4 of the k-step
    float sacc[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kDSteps; ++ks) {
      const float* qa = Qa + 8 * ks;
      uint32_t ahi[4], alo[4];
      split_tf32(qa[0], ahi[0], alo[0]);
      split_tf32(qa[8 * C::kStride], ahi[1], alo[1]);
      split_tf32(qa[4], ahi[2], alo[2]);
      split_tf32(qa[8 * C::kStride + 4], ahi[3], alo[3]);
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        const float* kb = Kt + (8 * j + gid) * C::kStride + 8 * ks + tig;
        mma_split(sacc[j], ahi, alo, kb[0], kb[4]);
      }
    }

    // ---- scale, mask, online softmax in registers; element e of n-tile j
    // is row (e < 2 ? row_lo : row_hi), key c0 + 8j + 2*tig + (e & 1)
    const int c0 = t * kTK;
    const int wq0 = q0 + wrow;         // the warp's rows are [wq0, wq0 + 16)
    const bool masked = c0 + kTK > S || (causal && c0 + kTK - 1 > wq0) ||
                        (window > 0 && c0 <= wq0 + 15 - window);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sacc[j][e] * scale;
        if (masked) {
          const int col = c0 + 8 * j + 2 * tig + (e & 1);
          const int row = e < 2 ? row_lo : row_hi;
          bool keep = col < S;
          if (causal) keep = keep && col <= row;
          if (window > 0) keep = keep && col > row - window;
          s = keep ? s : kNeg;
        }
        sacc[j][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // a row's scores lie on the quad of lanes sharing gid
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sacc[j][e] - m[e >> 1]);
        sacc[j][e] = p;
        ps[e >> 1] += p;
      }
    // l is kept per thread (its quarter of the row) and summed over the
    // quad at the end; alpha is the same for the whole row
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + ps[r];
#pragma unroll
    for (int n = 0; n < kDSteps; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // ---- O += P V. The accumulator holds keys 2*tig and 2*tig + 1 of
    // each 8-key step where the A fragment wants columns tig and tig + 4:
    // the step's keys are taken in the order 0, 2, 4, 6, 1, 3, 5, 7, so a
    // thread's two P values are its A columns as they stand, and V's B
    // fragment reads keys 2*tig and 2*tig + 1 (no shuffles)
#pragma unroll
    for (int kk = 0; kk < kKeyTiles; ++kk) {
      uint32_t phi[4], plo[4];
      split_tf32(sacc[kk][0], phi[0], plo[0]);
      split_tf32(sacc[kk][2], phi[1], plo[1]);
      split_tf32(sacc[kk][1], phi[2], plo[2]);
      split_tf32(sacc[kk][3], phi[3], plo[3]);
      const float* vb = Vt + (8 * kk + 2 * tig) * C::kStride + gid;
#pragma unroll
      for (int n = 0; n < kDSteps; ++n)
        mma_split(oacc[n], phi, plo, vb[8 * n], vb[C::kStride + 8 * n]);
    }
    __syncthreads();                   // stage st is free for tile t + 2
  }

  // ---- epilogue: normalise and store each lane's column pairs
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    denom[r] = fmaxf(l[r], 1e-30f);
  }
  if (lse != nullptr && tig == 0) write_lse(lse, (long)bh * S, row_lo, S, m,
                                             denom);
#pragma unroll
  for (int n = 0; n < kDSteps; ++n) {
    const int col = 8 * n + 2 * tig;
    if (row_lo < S)
      *reinterpret_cast<float2*>(o + q_base + (long)row_lo * q_row + col) =
          make_float2(oacc[n][0] / denom[0], oacc[n][1] / denom[0]);
    if (row_hi < S)
      *reinterpret_cast<float2*>(o + q_base + (long)row_hi * q_row + col) =
          make_float2(oacc[n][2] / denom[1], oacc[n][3] / denom[1]);
  }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int S, int H, int KV, int causal, int window,
               cudaStream_t stream) {
  using C = TF<DH>;
  auto kernel = flash_tf32_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + C::kBQ - 1) / C::kBQ);
  kernel<<<grid, C::kThreads, C::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), S, H, KV, causal, window);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int S, int H, int KV, int causal, int window,
                cudaStream_t stream) {
  using C = TC<DH>;
  auto kernel = flash_tc_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + C::kBQ - 1) / C::kBQ);
  kernel<<<grid, C::kThreads, C::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), S, H, KV, causal, window);
  return (int)cudaGetLastError();
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int H, int KV, int causal, int window, int bf16_in,
           cudaStream_t stream) {
  return bf16_in ? launch_bf16<DH>(q, k, v, o, lse, B, S, H, KV, causal,
                                   window, stream)
                 : launch_f32<DH>(q, k, v, o, lse, B, S, H, KV, causal,
                                  window, stream);
}

}  // namespace

extern "C" {

// Attention of q (B, S, H, dh) over k, v (B, S, KV, dh) into o (B, S, H,
// dh), all 16-byte aligned; bf16_in != 0 for bfloat16 tensors, float32
// otherwise; window <= 0 for none. lse, if not null, receives each row's
// logsumexp of its scaled, masked scores, (B, H, S) float32 (training
// saves it for the backward, csrc/flash_attention_bwd.cu); serving passes
// null, and the kernels then write what they wrote without it. Returns the cudaError_t of the launch,
// or cudaErrorInvalidValue for a head dim other than 16, 32, 64, 128 or
// 256 or H not a multiple of KV.
int fa_forward(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int S, int H, int KV, int dh, int causal,
               int window, int bf16_in, cudaStream_t stream) {
  if (KV < 1 || H % KV != 0) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 16: return launch<16>(q, k, v, o, lse, B, S, H, KV, causal, window, bf16_in, stream);
    case 32: return launch<32>(q, k, v, o, lse, B, S, H, KV, causal, window, bf16_in, stream);
    case 64: return launch<64>(q, k, v, o, lse, B, S, H, KV, causal, window, bf16_in, stream);
    case 128: return launch<128>(q, k, v, o, lse, B, S, H, KV, causal, window, bf16_in, stream);
    case 256: return launch<256>(q, k, v, o, lse, B, S, H, KV, causal, window, bf16_in, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
