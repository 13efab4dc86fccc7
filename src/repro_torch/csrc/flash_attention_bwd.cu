// Hand-written Hopper (sm_90a) kernels: the backward of causal, optionally
// sliding-window, attention (the gradient of `flash_attention.cu`'s
// forward), for training.
//
// Replaces no Pallas kernel: repro takes this gradient from XLA's autodiff
// of repro/models/attention.py:103 `causal_attention`, whose per-chunk
// jax.checkpoint recomputes the score tiles instead of storing them
// (:146-150). The port's training path sends every attention layer's
// gradient here (repro_torch/kernels/flash_attention/ops.py, the autograd
// Function), 24 launches a microbatch for stablelm-1.6b.
//
// What it computes. q, o, dO (B, S, H, dh), k, v (B, S, KV, dh), all
// float32 or all bfloat16, in the model's layout; lse (B, H, S) float32, the
// forward's row logsumexp of the scaled, masked scores; query head h reads
// kv head h / (H / KV). With scale = 1 / sqrtf(dh) and the forward's mask
// (key j seen by query i when j < S, j <= i if causal, j > i - window if a
// window is given):
//   D_i   = sum_d dO_id O_id                       (bwd_delta_kernel)
//   P_ij  = exp(scale q_i . k_j - lse_i), 0 where masked
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dV_j  = sum_i P_ij dO_i,  dK_j = scale sum_i dS_ij q_i    (the dK/dV kernel)
//   dQ_i  = scale sum_j dS_ij k_j                             (the dQ kernel)
// summed over the query heads of a kv head's group for dK and dV; dq, dk
// and dv are written in the inputs' dtype, rounded once. This is XLA's
// transpose of the reference's attention with the softmax's Jacobian
// written out (dS = P (dP - rowsum(dP P))) and rowsum(dP P) = rowsum(dO O).
//
// Two routes. bfloat16 inputs (every training step: the models compute in
// bf16) go to the tensor-core kernels, `bwd_dkdv_tc_kernel` and
// `bwd_dq_tc_kernel`; float32 inputs (the float32 twins of the tests) to
// the CUDA-core kernels of the first design, `bwd_dkdv_kernel` and
// `bwd_dq_kernel`, whose bits this redesign leaves as they were. Both
// routes take D from `bwd_delta_kernel`.
//
// What bounds it on the H100. At stablelm-1.6b's microbatch (B=4, S=2048,
// H=32, dh=64, causal, bf16) the five products (S = Q K^T, dP = dO V^T,
// dV, dK, dQ) over the 2.686e8 (query, key) pairs the mask keeps are
// 1.72e11 operations: 0.174 ms at the 989 TFLOP/s bf16 tensor-core peak,
// 2.6 ms at the 67 TFLOP/s float32 rate of CUDA cores (the first design,
// float32 fmaf on CUDA cores with operands reloaded from shared memory,
// took 9.2 ms). q, k, v, o, dO and the three gradients are 268 MB of bf16,
// 0.08 ms at 3.35 TB/s. So the operations bound it, and the products have
// to run on the tensor cores.
//
// What the bf16 design does about it: FlashAttention-2's backward on
// mma.sync.m16n8k16 (bf16 operands, float32 accumulators), built from the
// forward's pieces (tensor_tiles.cuh: swizzled tiles, cp.async, ldmatrix).
// - dK/dV, kv-tile-major: one CTA of 4 warps per (b, kv head, 64 keys).
//   K and V are copied once into swizzled shared memory; warp w owns keys
//   [16w, 16w + 16) and, at dh <= 64, keeps their K and V A fragments in
//   registers. The CTA walks, in a fixed order, the group's query heads
//   and the query tiles that see its keys (kBQ rows: 64 at dh <= 64, 32
//   above); each tile's Q, dO, lse and D come through a three-stage
//   cp.async ring, the next tile in flight while one multiplies, one
//   barrier a tile. S^T = K Q^T and dP^T = V dO^T are products of the
//   warp's rows by the staged tiles (ldmatrix); P^T and dS^T then lie in
//   the m16n8 accumulator layout, which is the m16n8k16 A layout, so dV +=
//   P^T dO and dK += dS^T Q take them from registers, with dO and Q as B
//   operands by ldmatrix.trans. No P or dS tile goes through shared
//   memory. dK and dV stay in float32 registers across the walk and are
//   scaled, rounded once and written with 16-byte stores through the
//   warp's own rows of the K and V tiles. A warp none of whose keys a
//   tile's rows see skips the tile. At dh = 256 a warp's dK and dV would
//   take 256 registers a thread: the kernel runs twice (PART kDV, then
//   kDK), and that route does one product more (S twice).
// - dQ, query-tile-major: one CTA of 4 warps per (b, h, 64 rows), the
//   heaviest causal tiles launched first. Q and dO are staged once (their
//   A fragments in registers at dh <= 64), each warp's lse and D in
//   registers; K and V tiles (kKT keys: 64 at dh <= 64, 32 above) come
//   through a three-stage cp.async ring. S = Q K^T and dP = dO V^T on the
//   tensor cores, dS stays in registers as the A operand of dQ += dS K,
//   with K as the B operand by ldmatrix.trans.
// - Shared memory: 65.5 KB (dK/dV) and 64 KB (dQ) at dh = 64, 80 KB at dh
//   = 128, 160 KB at dh = 256; with about 250 registers a thread of 128
//   threads, two CTAs an SM up to dh = 128 (one at 256). No spills
//   (-Xptxas -v, printed by chip_smoke.py's build and by
//   tools/flash_bwd_designs.py).
//
// Rounding. The tensor cores take bf16 operands. P is computed in float32,
// P = 2^(s scale log2(e) - lse log2(e)) (ex2.approx on a fused
// multiply-add), and rounded once to bf16 as the A operand of dV = P^T dO;
// dS = P (dP - D) is computed from the float32 P and rounded once to bf16
// as the A operand of dK and dQ. No operand is split into two bf16 terms
// (the forward splits its P): rounded once, as the reference's own bf16
// attention rounds its probabilities, the gradients stay within 6e-3 of
// the plain float32 backward's scale at phase 18 (a)'s training shapes
// (BWD_TOL is 2e-2) and within two output ulps of
// ref.attention_bwd_bf16_ref, the CPU mirror of these roundings
// (tools/flash_bwd_designs.py on an NVIDIA H100 80GB HBM3 at 700 W).
//
// Determinism. No atomics, in either route. dK and dV come from the CTA
// that owns their keys, dQ from the CTA that owns its rows; every sum runs
// in a fixed order, so two launches give the same bits and a resumed
// training run is bitwise an uninterrupted one. The price is that the dQ
// kernel recomputes S and dP: seven products where the bound counts five
// (a floor of 0.243 ms at stablelm's microbatch).
//
// What binds it now, and the next step. mma.sync issues from the warps'
// own instruction streams: every product reloads its B fragments from
// shared memory by ldmatrix (one 512-byte load for two mma), the
// elementwise work (exp, mask, dS, the bf16 packing) shares the issue
// slots, and about 250 registers a thread leave two CTAs of 4 warps an
// SM. wgmma (B read from shared memory by the tensor cores, A from
// registers), TMA with mbarriers and a producer warp are the next
// redesign's work.
//
// The float32 design (`bwd_dkdv_kernel`, `bwd_dq_kernel`): the same two
// walks with 256 threads as 16 x 16, a thread owning the outputs (ty +
// 16a, tx + 16c) of each tile product, CUDA-core float32 fmaf (which
// --fmad=false leaves fused) with a thread's operands reloaded from shared
// memory each step. Q and dO tiles (kBQ rows), K and V tiles (kBK rows)
// are staged in shared memory as float32 in rows padded to an odd stride,
// so the 16 rows a half-warp reads at one column fall on 16 banks; the P
// and dS tiles in rows of kBK + 16 floats, so two adjacent rows fall on
// disjoint banks. kBQ = kBK = 64 for dh <= 128, 32 at dh = 256 (107 KB at
// dh = 64, two CTAs an SM; 173 KB at dh = 128; 144 KB at dh = 256). Kv
// tiles past the causal frontier or outside the window are skipped; S
// need not divide the tiles: rows and keys past S are staged as zeros and
// masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_tiles.cuh"

namespace {

using namespace tensor_tiles;

// ---------------------------------------------------------------------------
// The float32 CUDA-core kernels (and the row sums D of both routes)
// ---------------------------------------------------------------------------

template <int DH>
struct BW {
  static constexpr int kThreads = 256;
  static constexpr int kBQ = DH == 256 ? 32 : 64;   // query rows a tile
  static constexpr int kBK = DH == 256 ? 32 : 64;   // keys a tile
  static constexpr int kRS = DH + 1;                // Q, dO, K, V row stride
  static constexpr int kPS = kBK + 16;              // P, dS row stride
  static constexpr int kRM = kBQ / 16;   // a thread's query rows
  static constexpr int kRN = kBK / 16;   // a thread's keys
  static constexpr int kRD = DH / 16;    // a thread's head-dim columns
  static constexpr size_t kBytes =
      (size_t)(2 * kBQ * kRS + 2 * kBK * kRS + 2 * kBQ * kPS + 2 * kBQ) *
      sizeof(float);
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }

// Rows [row0, row0 + ROWS) of one head (dh values at `base + s *
// row_stride`) into shared memory as float32 rows of stride kRS, by 16-byte
// loads; rows at or past S are zeros.
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      long base, long row_stride, int row0,
                                      int S) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = DH / kVec;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += BW<DH>::kThreads) {
    const int r = idx / kChunks, c = idx % kChunks, s = row0 + r;
    float* d = dst + r * BW<DH>::kRS + c * kVec;
    if (s < S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + base + (long)s * row_stride + c * kVec);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) d[e] = widen(vals[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) d[e] = 0.0f;
    }
  }
}

// D = rowsum(dO * O) in float32, one thread a (b, s, h) row, the head dim
// summed in order; written (B, H, S).
template <typename T, int DH>
__global__ void bwd_delta_kernel(const T* __restrict__ o,
                                 const T* __restrict__ dout,
                                 float* __restrict__ delta, long rows, int S,
                                 int H) {
  constexpr int kVec = 16 / sizeof(T);
  const long row = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int h = (int)(row % H);
  const long bs = row / H;
  const int s = (int)(bs % S);
  const long b = bs / S;
  const T* orow = o + row * DH;
  const T* drow = dout + row * DH;
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < DH / kVec; ++c) {
    const uint4 ro = *reinterpret_cast<const uint4*>(orow + c * kVec);
    const uint4 rd = *reinterpret_cast<const uint4*>(drow + c * kVec);
    const T* vo = reinterpret_cast<const T*>(&ro);
    const T* vd = reinterpret_cast<const T*>(&rd);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc = fmaf(widen(vd[e]), widen(vo[e]), acc);
  }
  delta[(b * H + h) * S + s] = acc;
}

// A thread's part of S = Q K^T and dP = dO V^T for a (query tile, kv tile)
// pair: rows ty + 16a, keys tx + 16b, the head dim summed in order.
template <int DH>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       float (&s)[BW<DH>::kRM][BW<DH>::kRN],
                                       float (&dp)[BW<DH>::kRM][BW<DH>::kRN],
                                       int ty, int tx) {
  using C = BW<DH>;
#pragma unroll
  for (int a = 0; a < C::kRM; ++a)
#pragma unroll
    for (int b = 0; b < C::kRN; ++b) s[a][b] = dp[a][b] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float qa[C::kRM], oa[C::kRM], kb[C::kRN], vb[C::kRN];
#pragma unroll
    for (int a = 0; a < C::kRM; ++a) {
      qa[a] = Qs[(ty + 16 * a) * C::kRS + d];
      oa[a] = dOs[(ty + 16 * a) * C::kRS + d];
    }
#pragma unroll
    for (int b = 0; b < C::kRN; ++b) {
      kb[b] = Ks[(tx + 16 * b) * C::kRS + d];
      vb[b] = Vs[(tx + 16 * b) * C::kRS + d];
    }
#pragma unroll
    for (int a = 0; a < C::kRM; ++a)
#pragma unroll
      for (int b = 0; b < C::kRN; ++b) {
        s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
        dp[a][b] = fmaf(oa[a], vb[b], dp[a][b]);
      }
  }
}

// P and dS of the pair from S and dP into shared memory (rows of kPS):
// P = exp(scale s - lse) where the key is seen, else 0; dS = P (dP - D).
template <int DH>
__device__ __forceinline__ void probs(const float (&s)[BW<DH>::kRM][BW<DH>::kRN],
                                      const float (&dp)[BW<DH>::kRM][BW<DH>::kRN],
                                      const float* Ls, const float* Ds,
                                      float* Ps, float* dSs, int q0, int k0,
                                      int S, int causal, int window,
                                      float scale, int ty, int tx) {
  using C = BW<DH>;
#pragma unroll
  for (int a = 0; a < C::kRM; ++a) {
    const int i = ty + 16 * a, row = q0 + i;
#pragma unroll
    for (int b = 0; b < C::kRN; ++b) {
      const int j = tx + 16 * b, col = k0 + j;
      bool keep = row < S && col < S;
      if (causal) keep = keep && col <= row;
      if (window > 0) keep = keep && col > row - window;
      const float p = keep ? expf(s[a][b] * scale - Ls[i]) : 0.0f;
      if (Ps != nullptr) Ps[i * C::kPS + j] = p;
      dSs[i * C::kPS + j] = p * (dp[a][b] - Ds[i]);
    }
  }
}

// lse and D of query rows [q0, q0 + kBQ) of one (b, h) (0 past S).
template <int DH>
__device__ __forceinline__ void stage_rows(float* Ls, float* Ds,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           long row_base, int q0, int S) {
  for (int i = threadIdx.x; i < BW<DH>::kBQ; i += BW<DH>::kThreads) {
    const int row = q0 + i;
    Ls[i] = row < S ? lse[row_base + row] : 0.0f;
    Ds[i] = row < S ? delta[row_base + row] : 0.0f;
  }
}

// dK and dV of one kv tile (blockIdx.y) of one (b, kv head) (blockIdx.x):
// the tile's K and V stay staged while the CTA walks the query heads of the
// group and, for each, the query tiles that see the tile, in order.
template <typename T, int DH>
__global__ void __launch_bounds__(256, DH <= 64 ? 2 : 1)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KV,
                int causal, int window) {
  using C = BW<DH>;
  extern __shared__ __align__(16) float bw_smem[];
  float* Qs = bw_smem;
  float* dOs = Qs + C::kBQ * C::kRS;
  float* Ks = dOs + C::kBQ * C::kRS;
  float* Vs = Ks + C::kBK * C::kRS;
  float* Ps = Vs + C::kBK * C::kRS;
  float* dSs = Ps + C::kBQ * C::kPS;
  float* Ls = dSs + C::kBQ * C::kPS;
  float* Ds = Ls + C::kBQ;

  const int b = blockIdx.x / KV, g = blockIdx.x % KV, rep = H / KV;
  const int k0 = blockIdx.y * C::kBK;   // tile 0, which most queries see, first
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long q_row = (long)H * DH, kv_row = (long)KV * DH;
  const long kv_base = (long)b * S * kv_row + (long)g * DH;
  const float scale = 1.0f / sqrtf((float)DH);

  stage<T, DH, C::kBK>(Ks, k, kv_base, kv_row, k0, S);
  stage<T, DH, C::kBK>(Vs, v, kv_base, kv_row, k0, S);

  // the query tiles that see a key of this tile: from the causal frontier
  // to the last row whose window reaches the tile's last key (i <= j +
  // window - 1)
  const int n_qt = (S + C::kBQ - 1) / C::kBQ;
  const int qt_begin = causal ? k0 / C::kBQ : 0;
  int qt_end = n_qt;
  if (window > 0) {
    const long last = (long)k0 + C::kBK - 2 + window;
    qt_end = (int)min((long)n_qt, last / C::kBQ + 1);
  }

  float dk_acc[C::kRN][C::kRD], dv_acc[C::kRN][C::kRD];
#pragma unroll
  for (int a = 0; a < C::kRN; ++a)
#pragma unroll
    for (int c = 0; c < C::kRD; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.0f;

  for (int hh = 0; hh < rep; ++hh) {
    const int h = g * rep + hh;
    const long q_base = (long)b * S * q_row + (long)h * DH;
    const long row_base = ((long)b * H + h) * S;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * C::kBQ;
      __syncthreads();   // the previous pair's readers are done
      stage<T, DH, C::kBQ>(Qs, q, q_base, q_row, q0, S);
      stage<T, DH, C::kBQ>(dOs, dout, q_base, q_row, q0, S);
      stage_rows<DH>(Ls, Ds, lse, delta, row_base, q0, S);
      __syncthreads();
      float s[C::kRM][C::kRN], dp[C::kRM][C::kRN];
      scores<DH>(Qs, dOs, Ks, Vs, s, dp, ty, tx);
      probs<DH>(s, dp, Ls, Ds, Ps, dSs, q0, k0, S, causal, window, scale, ty,
                tx);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q over the tile's query rows, in order
#pragma unroll 4
      for (int i = 0; i < C::kBQ; ++i) {
        float pa[C::kRN], sa[C::kRN], ob[C::kRD], qb[C::kRD];
#pragma unroll
        for (int a = 0; a < C::kRN; ++a) {
          pa[a] = Ps[i * C::kPS + ty + 16 * a];
          sa[a] = dSs[i * C::kPS + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < C::kRD; ++c) {
          ob[c] = dOs[i * C::kRS + tx + 16 * c];
          qb[c] = Qs[i * C::kRS + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < C::kRN; ++a)
#pragma unroll
          for (int c = 0; c < C::kRD; ++c) {
            dv_acc[a][c] = fmaf(pa[a], ob[c], dv_acc[a][c]);
            dk_acc[a][c] = fmaf(sa[a], qb[c], dk_acc[a][c]);
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < C::kRN; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= S) continue;
    const long off = kv_base + (long)key * kv_row;
#pragma unroll
    for (int c = 0; c < C::kRD; ++c) {
      narrow(dk + off + tx + 16 * c, dk_acc[a][c] * scale);
      narrow(dv + off + tx + 16 * c, dv_acc[a][c]);
    }
  }
}

// dQ of one query tile of one (b, h) (blockIdx.x): the CTA walks the kv
// tiles that the tile's rows see, in order; the last query tiles, which
// see the most keys under a causal mask, are launched first.
template <typename T, int DH>
__global__ void __launch_bounds__(256, DH <= 64 ? 2 : 1)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int S, int H, int KV, int causal,
              int window) {
  using C = BW<DH>;
  extern __shared__ __align__(16) float bw_smem[];
  float* Qs = bw_smem;
  float* dOs = Qs + C::kBQ * C::kRS;
  float* Ks = dOs + C::kBQ * C::kRS;
  float* Vs = Ks + C::kBK * C::kRS;
  float* dSs = Vs + C::kBK * C::kRS + C::kBQ * C::kPS;
  float* Ls = dSs + C::kBQ * C::kPS;
  float* Ds = Ls + C::kBQ;

  const int bh = blockIdx.x, b = bh / H, h = bh % H, g = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kBQ;   // heaviest first
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long q_row = (long)H * DH, kv_row = (long)KV * DH;
  const long q_base = (long)b * S * q_row + (long)h * DH;
  const long kv_base = (long)b * S * kv_row + (long)g * DH;
  const long row_base = ((long)b * H + h) * S;
  const float scale = 1.0f / sqrtf((float)DH);

  stage<T, DH, C::kBQ>(Qs, q, q_base, q_row, q0, S);
  stage<T, DH, C::kBQ>(dOs, dout, q_base, q_row, q0, S);
  stage_rows<DH>(Ls, Ds, lse, delta, row_base, q0, S);

  // the kv tiles the rows see: from the window's first key (j >= i -
  // window + 1) to the causal frontier
  int t_end = (S + C::kBK - 1) / C::kBK;
  if (causal) t_end = min(t_end, (q0 + C::kBQ - 1) / C::kBK + 1);
  int t_begin = 0;
  if (window > 0) t_begin = max(0, q0 - window + 1) / C::kBK;

  float dq_acc[C::kRM][C::kRD];
#pragma unroll
  for (int a = 0; a < C::kRM; ++a)
#pragma unroll
    for (int c = 0; c < C::kRD; ++c) dq_acc[a][c] = 0.0f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * C::kBK;
    __syncthreads();   // the previous tile's readers are done
    stage<T, DH, C::kBK>(Ks, k, kv_base, kv_row, k0, S);
    stage<T, DH, C::kBK>(Vs, v, kv_base, kv_row, k0, S);
    __syncthreads();
    float s[C::kRM][C::kRN], dp[C::kRM][C::kRN];
    scores<DH>(Qs, dOs, Ks, Vs, s, dp, ty, tx);
    probs<DH>(s, dp, Ls, Ds, nullptr, dSs, q0, k0, S, causal, window, scale,
              ty, tx);
    __syncthreads();
    // dQ += dS K over the tile's keys, in order
#pragma unroll 4
    for (int j = 0; j < C::kBK; ++j) {
      float sa[C::kRM], kb[C::kRD];
#pragma unroll
      for (int a = 0; a < C::kRM; ++a) sa[a] = dSs[(ty + 16 * a) * C::kPS + j];
#pragma unroll
      for (int c = 0; c < C::kRD; ++c) kb[c] = Ks[j * C::kRS + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < C::kRM; ++a)
#pragma unroll
        for (int c = 0; c < C::kRD; ++c)
          dq_acc[a][c] = fmaf(sa[a], kb[c], dq_acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < C::kRM; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= S) continue;
    const long off = q_base + (long)row * q_row;
#pragma unroll
    for (int c = 0; c < C::kRD; ++c)
      narrow(dq + off + tx + 16 * c, dq_acc[a][c] * scale);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int B, int S, int H, int KV, int causal, int window,
           cudaStream_t stream) {
  using C = BW<DH>;
  const long rows = (long)B * S * H;
  bwd_delta_kernel<T, DH><<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), rows, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto dkdv = bwd_dkdv_kernel<T, DH>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::kBytes);
  if (err != cudaSuccess) return (int)err;
  dkdv<<<dim3(B * KV, (S + C::kBK - 1) / C::kBK), C::kThreads, C::kBytes,
         stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), static_cast<const T*>(dout),
                   static_cast<const float*>(lse),
                   static_cast<const float*>(delta), static_cast<T*>(dk),
                   static_cast<T*>(dv), S, H, KV, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto dqk = bwd_dq_kernel<T, DH>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::kBytes);
  if (err != cudaSuccess) return (int)err;
  dqk<<<dim3(B * H, (S + C::kBQ - 1) / C::kBQ), C::kThreads, C::kBytes,
        stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<T*>(dq), S, H,
                  KV, causal, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core kernels
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
enum Part { kBoth = 0, kDV = 1, kDK = 2 };

template <int DH>
struct BT {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  // three stages: the tile loaded next never lands in the stage another
  // warp may still read, so one barrier a tile suffices
  static constexpr int kStages = 3;
  // dK/dV: kBK keys a CTA (16 a warp); the ring holds query tiles of kBQ
  // rows (Q, dO, lse and D)
  static constexpr int kBK = 16 * kWarps;
  static constexpr int kBQ = DH <= 64 ? 64 : 32;
  // dQ: kRows query rows a CTA (16 a warp); the ring holds kv tiles of kKT
  // keys (K and V)
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kKT = DH <= 64 ? 64 : 32;
  // K, V (dK/dV) and Q, dO (dQ) A fragments held in registers across the
  // walk; above dh = 64 they are reloaded from shared memory per k-step
  static constexpr bool kFragsInRegs = DH <= 64;
  // at dh = 256 a warp's dK and dV would take 256 float32 registers a
  // thread: the dK/dV kernel runs twice, once for each
  static constexpr bool kSplit = DH == 256;
  static constexpr int kStageElems = 2 * kBQ * DH;   // Q and dO of a stage
  static constexpr size_t kKVBytes =
      (size_t)(2 * kBK * DH + kStages * kStageElems) * sizeof(bf16) +
      (size_t)kStages * 2 * kBQ * sizeof(float);
  static constexpr size_t kQBytes =
      (size_t)(2 * kRows * DH + 2 * kStages * kKT * DH) * sizeof(bf16);
};

// 4 bytes from global to shared memory, asynchronously; src_bytes 0
// zero-fills the destination (the source address must still be valid).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 2^x by the MUFU unit (ex2.approx.ftz: a relative error of about 2^-22,
// results below 2^-126 flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A fragment loads of this lane: the A operand (rows lane & 15, chunk lane
// >> 4), a B operand stored n-major (K for S = Q K^T: keys (lane & 7) + 8
// (lane >> 4), chunk (lane >> 3) & 1) and a B operand stored k-major, by
// ldmatrix.trans (V for O = P V: rows (lane & 7) + 8 ((lane >> 3) & 1),
// chunk lane >> 4), as in flash_attention.cu's forward
struct Lanes {
  int a_row, a_chunk, b_row, b_chunk, t_row, t_chunk;
  __device__ __forceinline__ explicit Lanes(int lane)
      : a_row(lane & 15), a_chunk(lane >> 4),
        b_row((lane & 7) + ((lane >> 4) << 3)), b_chunk((lane >> 3) & 1),
        t_row((lane & 7) + (((lane >> 3) & 1) << 3)), t_chunk(lane >> 4) {}
};

// acc (16 x 8N, float32) += A (16 x DH, the warp's 16 rows of `At`, or
// `af` in registers) times the n-major tile `Bt` (8N rows of DH)
// transposed: S^T = K Q^T, dP^T = V dO^T, S = Q K^T and dP = dO V^T.
template <int DH, int N, bool kRegs>
__device__ __forceinline__ void rows_by_rows(float (&acc)[N][4],
                                             const uint32_t (&af)[kRegs ? DH / 16 : 1][4],
                                             const bf16* At, int arow,
                                             const bf16* Bt, const Lanes& ln) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t a[4];
    if constexpr (kRegs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = af[ks][e];
    } else {
      ldmatrix_x4(a, At + swz<DH>(arow + ln.a_row, 2 * ks + ln.a_chunk));
    }
#pragma unroll
    for (int j2 = 0; j2 < N / 2; ++j2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, Bt + swz<DH>(16 * j2 + ln.b_row, 2 * ks + ln.b_chunk));
      mma_bf16(acc[2 * j2], a, bf[0], bf[1]);
      mma_bf16(acc[2 * j2 + 1], a, bf[2], bf[3]);
    }
  }
}

// out (16 x DH, float32) += X (16 x 8N, float32 accumulators, each value
// rounded once to bf16 as the A operand) times the k-major tile `Bt` (8N
// rows of DH): dV += P^T dO, dK += dS^T Q and dQ += dS K.
template <int DH, int N>
__device__ __forceinline__ void acc_by_tile(float (&out)[DH / 8][4],
                                            const float (&x)[N][4],
                                            const bf16* Bt, const Lanes& ln) {
#pragma unroll
  for (int kk = 0; kk < N / 2; ++kk) {
    uint32_t a[4];
    acc_to_a(a, x[2 * kk], x[2 * kk + 1]);
#pragma unroll
    for (int n2 = 0; n2 < DH / 16; ++n2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, Bt + swz<DH>(16 * kk + ln.t_row, 2 * n2 + ln.t_chunk));
      mma_bf16(out[2 * n2], a, bf[0], bf[1]);
      mma_bf16(out[2 * n2 + 1], a, bf[2], bf[3]);
    }
  }
}

// A warp's 16 output rows (float32 accumulators times `mul`) rounded once
// to bf16, staged in rows [wrow, wrow + 16) of the swizzled tile `st`,
// which only this warp reads, and written with 16-byte stores to rows
// [r0, r0 + 16) below S of `dst` (`base + r * row_stride`).
template <int DH>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, long base,
                                           long row_stride, int r0, int S,
                                           const float (&acc)[DH / 8][4],
                                           float mul, bf16* st, int wrow,
                                           int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    *reinterpret_cast<uint32_t*>(st + swz<DH>(wrow + gid, n) + 2 * tig) =
        pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<uint32_t*>(st + swz<DH>(wrow + gid + 8, n) + 2 * tig) =
        pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
  __syncwarp();
  constexpr int kChunks = DH / 8;
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int r = idx / kChunks, c = idx % kChunks;
    if (r0 + r < S)
      *reinterpret_cast<uint4*>(dst + base + (long)(r0 + r) * row_stride +
                                c * 8) =
          *reinterpret_cast<const uint4*>(st + swz<DH>(wrow + r, c));
  }
}

// dK and dV (PART kBoth; kDV or kDK for one of them) of one kv tile
// (blockIdx.y, kBK keys) of one (b, kv head) (blockIdx.x). K and V are
// staged once; the CTA walks the group's query heads and, for each, the
// query tiles that see the tile, in order, their Q, dO, lse and D coming
// through a three-stage cp.async ring. Warp w owns keys [16w, 16w + 16) of
// the tile and keeps their dK and dV in float32 registers.
template <int DH, int PART>
__global__ void __launch_bounds__(BT<DH>::kThreads, 2)
bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int S, int H, int KV, int causal,
                   int window) {
  using C = BT<DH>;
  constexpr bool kDoV = PART != kDK, kDoK = PART != kDV;
  constexpr bool kRegs = C::kFragsInRegs;
  constexpr int kQT = C::kBQ / 8;      // n-tiles of S^T (queries)
  extern __shared__ __align__(128) unsigned char bt_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(bt_smem);
  bf16* Vs = Ks + C::kBK * DH;
  bf16* Qs = Vs + C::kBK * DH;         // stage st: Q, then dO
  float* Ls = reinterpret_cast<float*>(Qs + C::kStages * C::kStageElems);

  const int b = blockIdx.x / KV, g = blockIdx.x % KV, rep = H / KV;
  const int k0 = blockIdx.y * C::kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const Lanes ln(lane);
  const long q_row = (long)H * DH, kv_row = (long)KV * DH;
  const long kv_base = (long)b * S * kv_row + (long)g * DH;
  const float scale = 1.0f / sqrtf((float)DH);
  const float scale_log2 = scale * kLog2e;

  // the query tiles that see a key of this tile: from the causal frontier
  // to the last row whose window reaches the tile's last key (i <= j +
  // window - 1); the walk is every (head of the group, tile) in order
  const int n_qt = (S + C::kBQ - 1) / C::kBQ;
  const int qt_begin = causal ? k0 / C::kBQ : 0;
  int qt_end = n_qt;
  if (window > 0) {
    const long last = (long)k0 + C::kBK - 2 + window;
    qt_end = (int)min((long)n_qt, last / C::kBQ + 1);
  }
  const int per_head = max(qt_end - qt_begin, 0);
  const int n_items = rep * per_head;

  // Q and dO rows [q0, q0 + kBQ) of the item's head, and their lse and D
  // (zeros past S), into stage st
  auto load_item = [&](int it, int st) {
    const int h = g * rep + it / per_head;
    const int q0 = (qt_begin + it % per_head) * C::kBQ;
    const long q_base = (long)b * S * q_row + (long)h * DH;
    bf16* qs = Qs + st * C::kStageElems;
    load_tile<DH, C::kBQ, C::kThreads>(qs, q, q_base, q_row, q0, S);
    load_tile<DH, C::kBQ, C::kThreads>(qs + C::kBQ * DH, dout, q_base, q_row,
                                       q0, S);
    float* ls = Ls + st * 2 * C::kBQ;
    const long row_base = ((long)b * H + h) * S;
    for (int i = threadIdx.x; i < 2 * C::kBQ; i += C::kThreads) {
      const int row = q0 + i % C::kBQ;
      const float* src = (i < C::kBQ ? lse : delta) + row_base + min(row, S - 1);
      cp_async4(ls + i, src, row < S ? 4 : 0);
    }
  };

  load_tile<DH, C::kBK, C::kThreads>(Ks, k, kv_base, kv_row, k0, S);
  if constexpr (kDoK)
    load_tile<DH, C::kBK, C::kThreads>(Vs, v, kv_base, kv_row, k0, S);
  cp_commit();
  if (n_items > 0) load_item(0, 0);
  cp_commit();
  cp_wait<1>();                        // K and V have landed
  __syncthreads();

  const int wrow = warp * 16;          // the warp's first key in the tile
  const int kw0 = k0 + wrow;
  uint32_t kf[kRegs ? DH / 16 : 1][4], vf[kRegs ? DH / 16 : 1][4];
  if constexpr (kRegs) {
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      ldmatrix_x4(kf[ks], Ks + swz<DH>(wrow + ln.a_row, 2 * ks + ln.a_chunk));
      if constexpr (kDoK)
        ldmatrix_x4(vf[ks], Vs + swz<DH>(wrow + ln.a_row, 2 * ks + ln.a_chunk));
    }
  }
  float dk_acc[DH / 8][4], dv_acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;
  const int key_lo = kw0 + gid, key_hi = key_lo + 8;

  for (int it = 0; it < n_items; ++it) {
    const int st = it % C::kStages;
    // the next item goes into the stage last read for item it - 2, which
    // every thread left before the previous item's barrier
    if (it + 1 < n_items) load_item(it + 1, (it + 1) % C::kStages);
    cp_commit();
    cp_wait<1>();                      // item it has landed
    __syncthreads();

    const int q0 = (qt_begin + it % per_head) * C::kBQ;
    // a warp none of whose keys a row of the tile sees adds nothing
    if (kw0 >= S || (causal && kw0 > q0 + C::kBQ - 1) ||
        (window > 0 && kw0 + 15 <= q0 - window))
      continue;
    const bf16* Qt = Qs + st * C::kStageElems;
    const bf16* dOt = Qt + C::kBQ * DH;
    const float* Lt = Ls + st * 2 * C::kBQ;
    const float* Dt = Lt + C::kBQ;

    // ---- S^T = K Q^T, the warp's 16 keys x kBQ queries
    float sacc[kQT][4];
    rows_by_rows<DH, kQT, kRegs>(sacc, kf, Ks, wrow, Qt, ln);

    // ---- P^T = exp(scale s - lse) where the key is seen, else 0; element
    // e of n-tile j is key (e < 2 ? key_lo : key_hi), query q0 + 8j +
    // 2 tig + (e & 1)
    const bool masked = q0 + C::kBQ > S || kw0 + 16 > S ||
                        (causal && kw0 + 15 > q0) ||
                        (window > 0 && kw0 <= q0 + C::kBQ - 1 - window);
#pragma unroll
    for (int j = 0; j < kQT; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(Lt + 8 * j + 2 * tig);
      const float lg[2] = {l2.x * kLog2e, l2.y * kLog2e};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(sacc[j][e], scale_log2, -lg[e & 1]));
        if (masked) {
          const int key = e < 2 ? key_lo : key_hi;
          const int row = q0 + 8 * j + 2 * tig + (e & 1);
          bool keep = key < S && row < S;
          if (causal) keep = keep && key <= row;
          if (window > 0) keep = keep && key > row - window;
          p = keep ? p : 0.0f;
        }
        sacc[j][e] = p;
      }
    }

    // ---- dV += P^T dO, P rounded once to bf16
    if constexpr (kDoV) acc_by_tile<DH, kQT>(dv_acc, sacc, dOt, ln);

    if constexpr (kDoK) {
      // ---- dP^T = V dO^T, then dS^T = P^T (dP^T - D) from the float32 P
      float dpacc[kQT][4];
      rows_by_rows<DH, kQT, kRegs>(dpacc, vf, Vs, wrow, dOt, ln);
#pragma unroll
      for (int j = 0; j < kQT; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(Dt + 8 * j + 2 * tig);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sacc[j][e] = sacc[j][e] * (dpacc[j][e] - ((e & 1) ? d2.y : d2.x));
      }
      // ---- dK += dS^T Q, dS rounded once to bf16
      acc_by_tile<DH, kQT>(dk_acc, sacc, Qt, ln);
    }
  }

  // ---- epilogue: dK scaled, each rounded once, through the warp's own
  // rows of Ks and Vs
  if constexpr (kDoK)
    store_rows<DH>(dk, kv_base, kv_row, kw0, S, dk_acc, scale, Ks, wrow, lane);
  if constexpr (kDoV)
    store_rows<DH>(dv, kv_base, kv_row, kw0, S, dv_acc, 1.0f, Vs, wrow, lane);
}

// dQ of one query tile (kRows rows) of one (b, h) (blockIdx.x): Q, dO and
// the rows' lse and D are staged once, the kv tiles the rows see come
// through a three-stage cp.async ring, in order; warp w owns rows [16w,
// 16w + 16) and keeps their dQ in float32 registers. The last query tiles,
// which see the most keys under a causal mask, are launched first.
template <int DH>
__global__ void __launch_bounds__(BT<DH>::kThreads, 2)
bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int S, int H, int KV, int causal,
                 int window) {
  using C = BT<DH>;
  constexpr bool kRegs = C::kFragsInRegs;
  constexpr int kKT = C::kKT;
  constexpr int kNT = kKT / 8;         // n-tiles of S (keys)
  constexpr int kTile = kKT * DH;
  extern __shared__ __align__(128) unsigned char bt_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(bt_smem);
  bf16* dOs = Qs + C::kRows * DH;
  bf16* Ks = dOs + C::kRows * DH;
  bf16* Vs = Ks + C::kStages * kTile;

  const int bh = blockIdx.x, b = bh / H, h = bh % H, g = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kRows;   // heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const Lanes ln(lane);
  const long q_row = (long)H * DH, kv_row = (long)KV * DH;
  const long q_base = (long)b * S * q_row + (long)h * DH;
  const long kv_base = (long)b * S * kv_row + (long)g * DH;
  const float scale = 1.0f / sqrtf((float)DH);
  const float scale_log2 = scale * kLog2e;

  // the kv tiles the rows see: from the window's first key (j >= i -
  // window + 1) to the causal frontier
  int t_end = (S + kKT - 1) / kKT;
  if (causal) t_end = min(t_end, (q0 + C::kRows - 1) / kKT + 1);
  int t_begin = 0;
  if (window > 0) t_begin = max(0, q0 - window + 1) / kKT;

  load_tile<DH, C::kRows, C::kThreads>(Qs, q, q_base, q_row, q0, S);
  load_tile<DH, C::kRows, C::kThreads>(dOs, dout, q_base, q_row, q0, S);
  load_tile<DH, kKT, C::kThreads>(Ks, k, kv_base, kv_row, t_begin * kKT, S);
  load_tile<DH, kKT, C::kThreads>(Vs, v, kv_base, kv_row, t_begin * kKT, S);
  cp_commit();

  const int wrow = warp * 16;          // the warp's first row in the tile
  const int wq0 = q0 + wrow;
  const int row_lo = wq0 + gid, row_hi = row_lo + 8;
  const long row_base = (long)bh * S;
  const float lg[2] = {row_lo < S ? lse[row_base + row_lo] * kLog2e : 0.0f,
                       row_hi < S ? lse[row_base + row_hi] * kLog2e : 0.0f};
  const float dd[2] = {row_lo < S ? delta[row_base + row_lo] : 0.0f,
                       row_hi < S ? delta[row_base + row_hi] : 0.0f};

  cp_wait<0>();
  __syncthreads();
  uint32_t qf[kRegs ? DH / 16 : 1][4], of[kRegs ? DH / 16 : 1][4];
  if constexpr (kRegs) {
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      ldmatrix_x4(qf[ks], Qs + swz<DH>(wrow + ln.a_row, 2 * ks + ln.a_chunk));
      ldmatrix_x4(of[ks], dOs + swz<DH>(wrow + ln.a_row, 2 * ks + ln.a_chunk));
    }
  }
  float dq_acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.0f;

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) % C::kStages;
    const int nx = (st + 1) % C::kStages;
    // the next tile goes into stage nx, last read for tile t - 2, which
    // every thread left before the previous tile's barrier
    if (t + 1 < t_end) {
      load_tile<DH, kKT, C::kThreads>(Ks + nx * kTile, k, kv_base, kv_row,
                                      (t + 1) * kKT, S);
      load_tile<DH, kKT, C::kThreads>(Vs + nx * kTile, v, kv_base, kv_row,
                                      (t + 1) * kKT, S);
    }
    cp_commit();
    cp_wait<1>();                      // tile t has landed
    __syncthreads();

    const int c0 = t * kKT;
    // a warp whose rows see no key of the tile adds nothing
    if (wq0 >= S || (causal && c0 > wq0 + 15) ||
        (window > 0 && c0 + kKT - 1 <= wq0 - window))
      continue;
    const bf16* Kt = Ks + st * kTile;
    const bf16* Vt = Vs + st * kTile;

    // ---- S = Q K^T and dP = dO V^T, the warp's 16 rows x kKT keys
    float sacc[kNT][4], dpacc[kNT][4];
    rows_by_rows<DH, kNT, kRegs>(sacc, qf, Qs, wrow, Kt, ln);
    rows_by_rows<DH, kNT, kRegs>(dpacc, of, dOs, wrow, Vt, ln);

    // ---- dS = P (dP - D), P = exp(scale s - lse) where the key is seen,
    // else 0; element e of n-tile j is row (e < 2 ? row_lo : row_hi), key
    // c0 + 8j + 2 tig + (e & 1)
    const bool masked = c0 + kKT > S || wq0 + 16 > S ||
                        (causal && c0 + kKT - 1 > wq0) ||
                        (window > 0 && c0 <= wq0 + 15 - window);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(sacc[j][e], scale_log2, -lg[e >> 1]));
        if (masked) {
          const int col = c0 + 8 * j + 2 * tig + (e & 1);
          const int row = e < 2 ? row_lo : row_hi;
          bool keep = col < S && row < S;
          if (causal) keep = keep && col <= row;
          if (window > 0) keep = keep && col > row - window;
          p = keep ? p : 0.0f;
        }
        sacc[j][e] = p * (dpacc[j][e] - dd[e >> 1]);
      }

    // ---- dQ += dS K, dS rounded once to bf16
    acc_by_tile<DH, kNT>(dq_acc, sacc, Kt, ln);
  }

  // ---- epilogue: scaled, rounded once, through the warp's own rows of Qs
  store_rows<DH>(dq, q_base, q_row, wq0, S, dq_acc, scale, Qs, wrow, lane);
}

template <int DH, int PART>
int launch_dkdv_tc(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int S, int H, int KV,
                   int causal, int window, cudaStream_t stream) {
  using C = BT<DH>;
  auto kernel = bwd_dkdv_tc_kernel<DH, PART>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kKVBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B * KV, (S + C::kBK - 1) / C::kBK), C::kThreads, C::kKVBytes,
           stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v),
                     static_cast<const bf16*>(dout),
                     static_cast<const float*>(lse),
                     static_cast<const float*>(delta), static_cast<bf16*>(dk),
                     static_cast<bf16*>(dv), S, H, KV, causal, window);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* delta, void* dq,
              void* dk, void* dv, int B, int S, int H, int KV, int causal,
              int window, cudaStream_t stream) {
  using C = BT<DH>;
  const long rows = (long)B * S * H;
  bwd_delta_kernel<bf16, DH><<<(unsigned)((rows + 255) / 256), 256, 0,
                               stream>>>(static_cast<const bf16*>(o),
                                         static_cast<const bf16*>(dout),
                                         static_cast<float*>(delta), rows, S,
                                         H);
  int err = (int)cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (C::kSplit) {
    err = launch_dkdv_tc<DH, kDV>(q, k, v, dout, lse, delta, dk, dv, B, S, H,
                                  KV, causal, window, stream);
    if (err != cudaSuccess) return err;
    err = launch_dkdv_tc<DH, kDK>(q, k, v, dout, lse, delta, dk, dv, B, S, H,
                                  KV, causal, window, stream);
  } else {
    err = launch_dkdv_tc<DH, kBoth>(q, k, v, dout, lse, delta, dk, dv, B, S,
                                    H, KV, causal, window, stream);
  }
  if (err != cudaSuccess) return err;

  auto dqk = bwd_dq_tc_kernel<DH>;
  err = (int)cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kQBytes);
  if (err != cudaSuccess) return err;
  dqk<<<dim3(B * H, (S + C::kRows - 1) / C::kRows), C::kThreads, C::kQBytes,
        stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<bf16*>(dq), S,
                  H, KV, causal, window);
  return (int)cudaGetLastError();
}

template <int DH>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* delta, void* dq,
             void* dk, void* dv, int B, int S, int H, int KV, int causal,
             int window, int bf16_in, cudaStream_t stream) {
  return bf16_in ? launch_tc<DH>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                 S, H, KV, causal, window, stream)
                 : launch<float, DH>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                     B, S, H, KV, causal, window, stream);
}

}  // namespace

extern "C" {

// The gradients dq (B, S, H, dh) and dk, dv (B, S, KV, dh) of attention
// from q, o, dout (B, S, H, dh), k, v (B, S, KV, dh) and the forward's lse
// (B, H, S) float32; delta is (B, H, S) float32 scratch. All tensors
// 16-byte aligned; bf16_in != 0 for bfloat16 tensors, float32 otherwise;
// window <= 0 for none. Three launches on `stream` (D, dK and dV, dQ;
// four for bf16 at dh = 256, where dV and dK are two).
// Returns the first cudaError_t, or cudaErrorInvalidValue for a head dim
// other than 16, 32, 64, 128 or 256 or H not a multiple of KV.
int fa_backward(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* delta, void* dq,
                void* dk, void* dv, int B, int S, int H, int KV, int dh,
                int causal, int window, int bf16_in, cudaStream_t stream) {
  if (KV < 1 || H % KV != 0) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 16: return dispatch<16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, bf16_in, stream);
    case 32: return dispatch<32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, bf16_in, stream);
    case 64: return dispatch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, bf16_in, stream);
    case 128: return dispatch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, bf16_in, stream);
    case 256: return dispatch<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, window, bf16_in, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
