// Hand-written Hopper (sm_90a) kernel: causal, optionally sliding-window,
// attention forward with an online softmax, float32 inside.
//
// Replaces repro/kernels/flash_attention/flash_attention.py:82
// `flash_attention_pallas` (its `_kernel`, :25-79). The port's model sends
// every prefill attention layer here (repro_torch/models/attention.py
// `causal_attention`), 24 launches per stablelm-1.6b prefill.
//
// What it computes. q (B, S, H, dh), k and v (B, S, KV, dh), all float32 or
// all bfloat16, in the model's layout; query head h reads kv head
// h / (H / KV) (GQA without a repeated copy). For each (b, h, row i):
//   scores_j = (q_i . k_j) * scale, scale = 1 / sqrtf(dh) in float32;
//   masked to NEG = -2^30 unless (j <= i if causal) and (j > i - window if
//   a window is given);
//   out_i = sum_j softmax(scores)_j v_j, in q's dtype,
// the online softmax of the Pallas kernel: per kv block, m_new = max(m,
// max_j s_j), p_j = expf(s_j - m_new), alpha = expf(m - m_new), l = alpha*l
// + sum_j p_j, acc = alpha*acc + sum_j p_j v_j; at the end acc / max(l,
// 1e-30). Kv blocks entirely above the causal frontier or outside the
// window are skipped, as the Pallas kernel's `relevant` test does (:40-44).
// S need not divide the blocks: rows past S are not written, and keys past
// S are masked and staged as zeros.
//
// What bounds it on the H100. At stablelm-1.6b's prefill (B=8, S=2048,
// H=32, dh=64, causal, bf16) the causal half of QK^T and PV is 1.37e11
// operations: 0.14 ms at the 989 TFLOP/s bf16 tensor-core peak (the bound
// for bf16 inputs), 2.05 ms at the 67 TFLOP/s float32 rate this kernel
// computes at. q, k, v and o are 268 MB, 0.08 ms at 3.35 TB/s. So the
// operations bound it, and this kernel, on CUDA cores in float32, cannot
// come nearer than 2.05 ms.
//
// What the design does about it. It is the simple form: one CTA of 256
// threads per (b, h, block of 64 query rows); the kv axis, sequential on the
// TPU's grid, is a loop inside the CTA over 64-row key and value tiles
// staged in shared memory as float32 (rows padded by one float against bank
// conflicts). A thread owns four query rows (ty + 16*i) and, for the scores,
// four keys (tx + 16*j): a 4x4 register tile, 8 shared loads per 16 fused
// multiply-adds. The 16 threads of a row group are half a warp, so row
// maxima and sums are shuffles. Probabilities go through shared memory to
// the PV product, where the thread keeps the same four rows and dh/16
// columns of the accumulator, so alpha, m and l stay in registers. No
// atomics: two launches give the same bits. The shared memory (208.75 KB at
// dh=256) is set with cudaFuncSetAttribute above 48 KB. Tensor cores
// (mma.sync or wgmma on bf16 tiles), TMA and warp specialisation are a
// later PR's work.
//
// Floats. The shared flags pass --fmad=false; the dot products use
// __fmaf_rn explicitly, and expf (not __expf) keeps the float32 tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 64;          // key/value rows per tile
constexpr int kThreads = 256;    // 16 row groups x 16 column groups
constexpr float kNeg = -1073741824.0f;   // -2^30, the reference's NEG

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DH>
struct Layout {                  // shared-memory tiles, in floats
  static constexpr int kQS = DH + 1;   // padded row strides
  static constexpr int kKS = DH + 1;
  static constexpr int kVS = DH;
  static constexpr int kPS = kBK + 1;
  static constexpr int kFloats = kBQ * kQS + kBK * kKS + kBK * kVS + kBQ * kPS;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// Rows [row0, row0 + rows) of one head into a padded float32 tile; rows at
// or past S are zeros.
template <int DH, typename T>
__device__ __forceinline__ void stage(float* tile, int stride,
                                      const T* __restrict__ src, long base,
                                      long row_stride, int row0, int rows,
                                      int S) {
  for (int idx = threadIdx.x; idx < rows * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH, s = row0 + r;
    tile[r * stride + d] =
        s < S ? to_f32(src[base + (long)s * row_stride + d]) : 0.0f;
  }
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int KV, int causal, int window) {
  using L = Layout<DH>;
  constexpr int kCols = DH / 16;       // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * L::kQS;
  float* Vs = Ks + kBK * L::kKS;
  float* Ps = Vs + kBK * L::kVS;

  const int bh = blockIdx.y, b = bh / H, h = bh % H, g = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long q_row = (long)H * DH, kv_row = (long)KV * DH;
  const long q_base = (long)b * S * q_row + (long)h * DH;
  const long kv_base = (long)b * S * kv_row + (long)g * DH;
  const float scale = 1.0f / sqrtf((float)DH);

  stage<DH>(Qs, L::kQS, q, q_base, q_row, q0, kBQ, S);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const int n_kv = (S + kBK - 1) / kBK;
  for (int t = 0; t < n_kv; ++t) {
    const int c0 = t * kBK;
    // the same test for every thread of the CTA, so the barriers below are
    // reached by all or none
    bool relevant = true;
    if (causal) relevant = c0 <= q0 + kBQ - 1;
    if (window > 0) relevant = relevant && (c0 + kBK - 1 > q0 - window);
    if (!relevant) continue;

    __syncthreads();   // the previous tile's readers are done; Q is staged
    stage<DH>(Ks, L::kKS, k, kv_base, kv_row, c0, kBK, S);
    stage<DH>(Vs, L::kVS, v, kv_base, kv_row, c0, kBK, S);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 16
    for (int d = 0; d < DH; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * L::kQS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * L::kKS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = __fmaf_rn(a[i], bk[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mc = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        bool keep = col < S;
        if (causal) keep = keep && col <= row;
        if (window > 0) keep = keep && col > row - window;
        sc[i][j] = keep ? sc[i][j] * scale : kNeg;
        mc = fmaxf(mc, sc[i][j]);
      }
      // the row's 64 scores lie in the 16 lanes sharing ty (half a warp)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float m_new = fmaxf(m[i], mc);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty + 16 * i) * L::kPS + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = alpha * l[i] + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * L::kPS + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = Vs[j * L::kVS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = __fmaf_rn(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* dst = o + q_base + (long)row * q_row;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(dst + tx + 16 * c, acc[i][c] / denom);
  }
}

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int causal, int window, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<DH, T>;
  const size_t bytes = Layout<DH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int KV, int dh, int causal, int window,
             cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<16, T>(q, k, v, o, B, S, H, KV, causal, window, stream);
    case 32: return launch<32, T>(q, k, v, o, B, S, H, KV, causal, window, stream);
    case 64: return launch<64, T>(q, k, v, o, B, S, H, KV, causal, window, stream);
    case 128: return launch<128, T>(q, k, v, o, B, S, H, KV, causal, window, stream);
    case 256: return launch<256, T>(q, k, v, o, B, S, H, KV, causal, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Attention of q (B, S, H, dh) over k, v (B, S, KV, dh) into o (B, S, H,
// dh); bf16 != 0 for bfloat16 tensors, float32 otherwise; window <= 0 for
// none. Returns the cudaError_t of the launch, or cudaErrorInvalidValue for
// a head dim other than 16, 32, 64, 128 or 256 or H not a multiple of KV.
int fa_forward(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int KV, int dh, int causal, int window, int bf16,
               cudaStream_t stream) {
  if (KV < 1 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, dh, causal, window,
                                   stream);
  return dispatch<float>(q, k, v, o, B, S, H, KV, dh, causal, window, stream);
}

}  // extern "C"
