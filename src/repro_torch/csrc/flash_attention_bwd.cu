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
//   dV_j  = sum_i P_ij dO_i,  dK_j = scale sum_i dS_ij q_i  (bwd_dkdv_kernel)
//   dQ_i  = scale sum_j dS_ij k_j                           (bwd_dq_kernel)
// summed over the query heads of a kv head's group for dK and dV; dq, dk
// and dv are written in the inputs' dtype, rounded once. This is XLA's
// transpose of the reference's attention with the softmax's Jacobian
// written out (dS = P (dP - rowsum(dP P))) and rowsum(dP P) = rowsum(dO O).
//
// Which P. The bf16 forward feeds its tensor cores P as two bf16 terms
// (16 significant bits); this kernel recomputes P in float32 from float32
// q . k and the saved lse, and every product here (dV = P^T dO, dS = P (dP
// - D), dK = dS^T Q, dQ = dS K) takes that float32 P and float32 operands:
// the bf16 inputs are widened when staged, all products are float32 fused
// multiply-adds on the CUDA cores.
//
// Determinism. No atomics. dK and dV come from a CTA that owns one kv tile
// of one (b, kv head) and walks, in a fixed order, every query head of its
// group and every query tile that sees the tile; dQ from a second kernel
// whose CTA owns one query tile of one (b, h) and walks the kv tiles. Every
// sum runs in a fixed order, so two launches give the same bits.
//
// The tiles. 256 threads as 16 x 16; a thread owns the outputs (ty + 16a,
// tx + 16c) of each tile product. Q and dO tiles (kBQ rows), K and V tiles
// (kBK rows) are staged in shared memory as float32 in rows padded to an
// odd stride, so the 16 rows a half-warp reads at one column fall on 16
// banks; the P and dS tiles in rows of kBK + 16 floats, so two adjacent
// rows fall on disjoint banks. kBQ = kBK = 64 for dh <= 128, 32 at dh =
// 256, which keeps the staging within shared memory (107 KB at dh = 64,
// two CTAs an SM; 173 KB at dh = 128; 144 KB at dh = 256). Kv tiles past
// the causal frontier or outside the window are skipped; S need not divide
// the tiles: rows and keys past S are staged as zeros and masked.
//
// Speed. CUDA-core float32 (fmaf, which --fmad=false leaves fused), with a
// thread's operands reloaded from shared memory each step: a simple
// kernel, right first; the tensor cores (mma.sync, wgmma) and TMA are a
// later redesign's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

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
__device__ __forceinline__ void narrow(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

template <int DH>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* delta, void* dq,
             void* dk, void* dv, int B, int S, int H, int KV, int causal,
             int window, int bf16_in, cudaStream_t stream) {
  return bf16_in ? launch<bf16, DH>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    B, S, H, KV, causal, window, stream)
                 : launch<float, DH>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                     B, S, H, KV, causal, window, stream);
}

}  // namespace

extern "C" {

// The gradients dq (B, S, H, dh) and dk, dv (B, S, KV, dh) of attention
// from q, o, dout (B, S, H, dh), k, v (B, S, KV, dh) and the forward's lse
// (B, H, S) float32; delta is (B, H, S) float32 scratch. All tensors
// 16-byte aligned; bf16_in != 0 for bfloat16 tensors, float32 otherwise;
// window <= 0 for none. Three launches on `stream` (D, dK and dV, dQ).
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
