// Hand-written Hopper (sm_90a) kernels: the common-random-numbers draws of
// the scenario families (`core/crn.py`) and the bid noise that perturbs the
// valuations with them (`core/executor.py`, `core/vi.py`).
//
// They replace no Pallas kernel. On the TPU, XLA computes these from
// jax.random (repro/core/crn.py:58-85) and from jnp.exp
// (repro/core/executor.py:914, repro/core/vi.py:114). The port's plain
// versions are PyTorch ops (`prng.normal`, `prng.uniform`, `floats.exp`);
// on the H100 they take a few hundred elementwise launches a block, and the
// noise is paid again every round for every noisy lane, so the draws and
// the noise each get one launch here.
//
// What they compute, bit for bit the plain versions (and so repro's bits on
// XLA's CPU backend):
//
// * crn_cells_kernel: for cell (t, c) of T events and C campaigns, with
//   g = idx[t] (or start + t), the cell key
//   fold_in(fold_in(key, g), c) and its 32 random bits, all Threefry-2x32
//   (20 rounds) in uint32 arithmetic; then jax.random.uniform's mantissa
//   transform, and for a normal sqrt(2) * erf_inv(u) with u in
//   [nextafter(-1, 0), 1): XLA's single-precision erf_inv on XLA CPU's
//   float32 log1p, every multiply-add that XLA CPU contracts one
//   __fmaf_rn, every other operation rounded on its own (the file builds
//   with --fmad=false).
// * bid_noise_kernel: out[s, r, c] = v[r, c] * exp(sigma[s, c] * z[r, c])
//   with XLA CPU's float32 exp (Cephes, Cody-Waite reduction, denormal
//   results flushed to zero).
//
// What bounds them on the H100: the cells kernel is a few hundred integer
// and float operations a cell (three Threefry hashes, the erf_inv
// polynomial) and writes 4 bytes: operations. The noise kernel reads 12
// bytes and writes 4 a cell for ~40 float operations: bytes. Each is one
// thread a cell, in a grid-stride loop.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32 with 20 rounds: the hash of (x0, x1) under key (k0, k1).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t x0, uint32_t x1,
                                         uint32_t& o0, uint32_t& o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int step = 0; step < 5; ++step) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl(x1, rot[step & 1][i]) ^ x0;
    }
    x0 += ks[(step + 1) % 3];
    x1 += ks[(step + 2) % 3] + (uint32_t)(step + 1);
  }
  o0 = x0;
  o1 = x1;
}

constexpr float kTiny = 1.1754943508222875e-38f;   // smallest normal

// XLA CPU's float32 log of x1 (Cephes).
__device__ __forceinline__ float xla_log(float x1) {
  const float xc = x1 > kTiny ? x1 : kTiny;
  const uint32_t b = __float_as_uint(xc);
  const float m = __uint_as_float((b & 0x7FFFFFu) | 0x3F000000u);
  float e = __fadd_rn((float)((int)(b >> 23) - 127), 1.0f);
  const bool small = m < 0.7071067690849304f;
  if (small) e = __fsub_rn(e, 1.0f);
  const float x = __fadd_rn(__fadd_rn(m, -1.0f), small ? m : 0.0f);
  const float z = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x, z);
  const float q0 = __fmaf_rn(
      __fmaf_rn(x, 0.07037683576345444f, -0.11514610052108765f), x,
      0.11676998436450958f);
  const float q1 = __fmaf_rn(
      __fmaf_rn(x, -0.12420140951871872f, 0.14249323308467865f), x,
      -0.16668057441711426f);
  const float q2 = __fmaf_rn(
      __fmaf_rn(x, 0.2000071406364441f, -0.24999994039535522f), x,
      0.3333333134651184f);
  const float r = __fmaf_rn(__fmaf_rn(q0, x3, q1), x3, q2);
  const float t =
      __fmaf_rn(r, x3, __fmul_rn(e, -0.00021219444170128554f));
  float y = __fadd_rn(__fmaf_rn(-0.5f, z, x), t);
  y = __fmaf_rn(e, 0.693359375f, y);
  if (!(x1 > 0.0f)) y = __int_as_float(0xFFFFFFFF);       // NaN
  if (x1 == 0.0f) y = -INFINITY;
  if (x1 == INFINITY) y = INFINITY;
  return y;
}

// XLA CPU's float32 log1p (Cephes' rational form below sqrt(2) - 1).
__device__ __forceinline__ float xla_log1p(float x) {
  const float large = xla_log(__fadd_rn(x, 1.0f));
  const float x2 = __fmul_rn(x, x);
  const float zero = __fmul_rn(x, 0.0f);
  float den = __fadd_rn(zero, 1.0f);
  den = __fmaf_rn(den, x, 15.062909126281738f);
  den = __fmaf_rn(den, x, 83.04756927490234f);
  den = __fmaf_rn(den, x, 221.7624053955078f);
  den = __fmaf_rn(den, x, 309.0987243652344f);
  den = __fmaf_rn(den, x, 216.42788696289062f);
  den = __fmaf_rn(den, x, 60.11865997314453f);
  float num = __fadd_rn(zero, 4.527000055531971e-05f);
  num = __fmaf_rn(num, x, 0.4985410273075104f);
  num = __fmaf_rn(num, x, 6.578732490539551f);
  num = __fmaf_rn(num, x, 29.91191864013672f);
  num = __fmaf_rn(num, x, 60.949668884277344f);
  num = __fmaf_rn(num, x, 57.11296463012695f);
  num = __fmaf_rn(num, x, 20.039552688598633f);
  const float small = __fadd_rn(
      x, __fmaf_rn(-0.5f, x2,
                   __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den))));
  return fabsf(x) < 0.4142135679721832f ? small : large;
}

// XLA's ErfInv32 (Giles' polynomials), highest degree first.
__constant__ float kErfLt5[9] = {
    2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f,
    -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
    -0.00417768164f,  0.246640727f,    1.50140941f};
__constant__ float kErfGe5[9] = {
    -0.000200214257f, 0.000100950558f, 0.00134934322f,
    -0.00367342844f,  0.00573950773f,  -0.0076224613f,
    0.00943887047f,   1.00167406f,     2.83297682f};

__device__ __forceinline__ float xla_erf_inv(float x) {
  const float w = -xla_log1p(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  const float t =
      lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  const float* c = lt ? kErfLt5 : kErfGe5;
  float p = c[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, t, c[i]);
  return fabsf(x) == 1.0f ? __fmul_rn(x, INFINITY) : __fmul_rn(p, x);
}

// XLA CPU's float32 exp.
__device__ __forceinline__ float xla_exp(float x) {
  x = fminf(fmaxf(x, -87.80000305175781f), 88.80000305175781f);
  float n = floorf(__fmaf_rn(x, 1.4426950216293335f, 0.5f));
  n = fminf(fmaxf(n, -127.0f), 127.0f);
  float r = __fmaf_rn(-n, 0.693359375f, x);
  r = __fmaf_rn(-n, -0.00021219444170128554f, r);
  float p = __fmaf_rn(r, 0.00019875691214110702f, 0.001398199936375022f);
  p = __fmaf_rn(p, r, 0.008333452045917511f);
  p = __fmaf_rn(p, r, 0.04166579619050026f);
  p = __fmaf_rn(p, r, 0.1666666567325592f);
  p = __fmaf_rn(p, r, 0.5f);
  const float y = __fadd_rn(__fmaf_rn(p, __fmul_rn(r, r), r), 1.0f);
  const float scale = __int_as_float(((int)n + 127) << 23);
  const float out = __fmul_rn(y, scale);
  return out < kTiny ? 0.0f : out;
}

__global__ void __launch_bounds__(kThreads)
    crn_cells_kernel(uint32_t k0, uint32_t k1, const int* idx,
                     long long start, long long T, int C, int normal,
                     float* out) {
  const long long cells = T * (long long)C;
  const float lo = -0.9999999403953552f;              // nextafter(-1, 0)
  const float span = __fsub_rn(1.0f, lo);
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
       i < cells; i += (long long)gridDim.x * kThreads) {
    const long long t = i / C;
    const int c = (int)(i - t * C);
    const uint32_t g = idx != nullptr ? (uint32_t)idx[t]
                                      : (uint32_t)(start + t);
    uint32_t e0, e1, c0, c1, b0, b1;
    threefry(k0, k1, 0u, g, e0, e1);
    threefry(e0, e1, 0u, (uint32_t)c, c0, c1);
    threefry(c0, c1, 0u, 0u, b0, b1);
    const uint32_t bits = b0 ^ b1;
    const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u),
                              1.0f);
    float v;
    if (normal) {
      const float u = fmaxf(lo, __fmaf_rn(f, span, lo));
      v = __fmul_rn(xla_erf_inv(u), 1.4142135381698608f);
    } else {
      v = fmaxf(0.0f, __fmaf_rn(f, 1.0f, 0.0f));
    }
    out[i] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
    bid_noise_kernel(const float* v, const float* z, const float* sigma,
                     float* out, int S, long long T, int C) {
  const long long per_lane = T * (long long)C;
  const long long cells = per_lane * S;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
       i < cells; i += (long long)gridDim.x * kThreads) {
    const int s = (int)(i / per_lane);
    const long long rc = i - s * per_lane;
    const int c = (int)(rc % C);
    const float x = __fmul_rn(sigma[(long long)s * C + c], z[rc]);
    out[i] = __fmul_rn(v[rc], xla_exp(x));
  }
}

int grid_for(long long cells) {
  long long blocks = (cells + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;      // a few waves on 132 SMs
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

extern "C" {

// (T, C) draws of the cells of events idx[0..T) (or start .. start+T when
// idx is null) under the stream key (k0, k1): normals when `normal` is 1,
// uniforms in [0, 1) when 0. Returns the cudaError_t of the launch.
int crn_cells(unsigned int k0, unsigned int k1, const int* idx,
              long long start, long long T, int C, int normal, float* out,
              cudaStream_t stream) {
  if (T <= 0 || C <= 0) return 0;
  crn_cells_kernel<<<grid_for(T * (long long)C), kThreads, 0, stream>>>(
      k0, k1, idx, start, T, C, normal, out);
  return (int)cudaGetLastError();
}

// out (S, T, C) = v * exp(sigma * z): v and z (T, C), sigma (S, C).
int bid_noise(const float* v, const float* z, const float* sigma,
              float* out, int S, long long T, int C, cudaStream_t stream) {
  if (S <= 0 || T <= 0 || C <= 0) return 0;
  bid_noise_kernel<<<grid_for((long long)S * T * C), kThreads, 0, stream>>>(
      v, z, sigma, out, S, T, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
