// Hand-written Hopper (sm_90a) kernel: the exact budget-capped sequential
// replay (the paper's Algorithm 1 carried over all campaigns), one scenario
// lane per warp.
//
// Replaces the Pallas TPU kernel `capped_scan_pallas` of
// repro/kernels/capped_scan/capped_scan.py (:75, body `_kernel` :27), which
// is first price only; this kernel also takes second price, the other rule
// of repro's `sequential_replay` (repro/core/sequential.py:33).
//
// What it computes. For each lane s, walking the events n = 0 .. N-1 in
// order with spends sp (C,) starting at 0: active = sp < budget; bid =
// values[n, c] * mult[s, c]; eligible = active & bid > reserve[s]; the
// winner is the first index of the largest eligible bid (-1 if none); it
// pays its bid (first price) or max(second-largest eligible bid, reserve)
// (second price), added to its spend with one float32 add; then every
// campaign whose spend has reached its budget and has no cap time gets cap
// time n + 1 (N + 1 = never). Out: winners and prices (S, N), the final
// spends and the cap times (S, C).
//
// What bounds it on the H100. The bytes (the (N, C) valuations read once,
// 400 MB at N=1e6, C=100, plus 8 bytes per (lane, event) written) take
// ~0.2 ms at 3.35 TB/s, and the multiplies and compares less. Neither is
// the bound: each event depends on the spends the previous event left, so
// a lane is a chain of N dependent steps, and the chain's latency (the
// masked arg-max across the warp, then one add) bounds it.
//
// What the design does about it. One warp per lane keeps the lane's state
// in registers: lane k of the warp owns campaigns k, k + 32, ... (kPer of
// them). The valuation rows do not depend on the state, so each thread loads
// its columns kDepth rows ahead of the chain into a register ring; the
// loads are coalesced across the warp, and the S warps read the same rows,
// which L2 serves. A step is the thread's own scan of its kPer columns in
// ascending order (top two bids, first index on ties), then the merge across
// the warp in a few instructions: the largest bid by an integer max
// reduction over order-preserving keys (redux.sync), the lowest index
// holding it by a min reduction, the bid's exact bits from the winner's
// thread by one shuffle, and for second price one more max over each
// thread's best but the winner's thread's second. Then the owner's add, and
// every thread tests its own columns for the cap (a budget <= 0 caps at
// event 1 without a sale, as in the reference). Every thread ends a step
// with the same result; thread n % 32 keeps event n's winner and price,
// and each 32 events are stored in one coalesced write. The S lanes run
// side by side on S SMs.
//
// Bids are compared as floats in the scan, and as keys in the merge, where
// -0.0 orders below +0.0; the two differ only for a zero bid under a
// negative reserve.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDepth = 8;                     // rows loaded ahead
constexpr int kMaxPer = 8;                    // campaigns per thread

// A float's order-preserving unsigned key (-0.0 below +0.0) and back.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

template <int kPer>
__global__ void __launch_bounds__(32)
capped_scan_kernel(const float* __restrict__ values,     // (N, C)
                   const float* __restrict__ budgets,    // (S, C)
                   const float* __restrict__ mult,       // (S, C)
                   const float* __restrict__ reserves,   // (S,)
                   int32_t* __restrict__ winners,        // (S, N)
                   float* __restrict__ prices,           // (S, N)
                   float* __restrict__ spend,            // (S, C)
                   int32_t* __restrict__ cap,            // (S, C)
                   int N, int C, int second_price) {
  const int s = blockIdx.x;
  const int lane = threadIdx.x;
  const int sentinel = N + 1;
  const float reserve = reserves[s];
  float b[kPer], m[kPer], sp[kPer];
  int cp[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = lane + 32 * j;
    const bool real = c < C;
    b[j] = real ? budgets[(size_t)s * C + c] : INFINITY;  // never caps
    m[j] = real ? mult[(size_t)s * C + c] : nanf("");     // never bids
    sp[j] = 0.0f;
    cp[j] = sentinel;
  }
  float ring[kDepth][kPer];
#pragma unroll
  for (int d = 0; d < kDepth; ++d)
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = lane + 32 * j;
      ring[d][j] =
          (d < N && c < C) ? __ldg(values + (size_t)d * C + c) : 0.0f;
    }

  int kept_w = -1;                            // event (n & 31)'s result,
  float kept_p = 0.0f;                        // held by thread n & 31
  for (int n0 = 0; n0 < N; n0 += kDepth) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int n = n0 + d;
      if (n >= N) break;
      float v[kPer];
      const long long ahead = (long long)n + kDepth;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = lane + 32 * j;
        v[j] = ring[d][j];
        ring[d][j] = (ahead < N && c < C)
                         ? __ldg(values + (size_t)ahead * C + c) : 0.0f;
      }
      // this thread's columns, ascending: eligible means active and
      // bid > reserve, which starting `best` at the reserve enforces
      float best = reserve, second = reserve;
      int win = -1;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (!(sp[j] < b[j])) continue;        // burnt out (or NaN budget)
        const float bid = v[j] * m[j];
        if (bid > best) {
          second = best;
          best = bid;
          win = lane + 32 * j;
        } else if (bid > second) {
          second = bid;
        }
      }
      // merge across the warp with integer reductions: the largest bid
      // (as an order-preserving key), then the lowest index holding it;
      // the winner's lane supplies the bid's exact bits
      const unsigned top = __reduce_max_sync(0xffffffffu, ordered(best));
      const unsigned cand =
          (win >= 0 && ordered(best) == top) ? (unsigned)win : 0xffffffffu;
      const unsigned wmin = __reduce_min_sync(0xffffffffu, cand);
      const int w_all = wmin == 0xffffffffu ? -1 : (int)wmin;
      const float top_bid = __shfl_sync(0xffffffffu, best, w_all & 31);
      if (second_price) {
        // the largest bid of the rest: the winner's lane offers its second,
        // every other lane its best
        const float mine = (w_all >= 0 && (w_all & 31) == lane) ? second
                                                                  : best;
        second = unordered(__reduce_max_sync(0xffffffffu, ordered(mine)));
      }
      best = top_bid;
      win = w_all;
      const float price = win >= 0 ? (second_price ? second : best) : 0.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (win == lane + 32 * j) sp[j] = sp[j] + price;
        if (cp[j] == sentinel && sp[j] >= b[j]) cp[j] = n + 1;
      }
      if (lane == (n & 31)) {
        kept_w = win;
        kept_p = price;
      }
      if ((n & 31) == 31 || n == N - 1) {
        const int row = (n & ~31) + lane;
        if (row <= n) {
          winners[(size_t)s * N + row] = kept_w;
          prices[(size_t)s * N + row] = kept_p;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = lane + 32 * j;
    if (c < C) {
      spend[(size_t)s * C + c] = sp[j];
      cap[(size_t)s * C + c] = cp[j];
    }
  }
}

template <int kPer>
int launch(const float* values, const float* budgets, const float* mult,
           const float* reserves, int32_t* winners, float* prices,
           float* spend, int32_t* cap, int S, int N, int C, int second_price,
           cudaStream_t stream) {
  capped_scan_kernel<kPer><<<S, 32, 0, stream>>>(
      values, budgets, mult, reserves, winners, prices, spend, cap, N, C,
      second_price);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// S exact replays, one warp each. Returns the cudaError_t of the launch, or
// cudaErrorInvalidValue for a C above cs_max_campaigns().
int cs_capped_scan(const float* values, const float* budgets,
                   const float* mult, const float* reserves, int32_t* winners,
                   float* prices, float* spend, int32_t* cap, int S, int N,
                   int C, int second_price, cudaStream_t stream) {
  const int per = (C + 31) / 32;
  if (per <= 1)
    return launch<1>(values, budgets, mult, reserves, winners, prices, spend,
                     cap, S, N, C, second_price, stream);
  if (per <= 2)
    return launch<2>(values, budgets, mult, reserves, winners, prices, spend,
                     cap, S, N, C, second_price, stream);
  if (per <= 4)
    return launch<4>(values, budgets, mult, reserves, winners, prices, spend,
                     cap, S, N, C, second_price, stream);
  if (per <= kMaxPer)
    return launch<kMaxPer>(values, budgets, mult, reserves, winners, prices,
                           spend, cap, S, N, C, second_price, stream);
  return (int)cudaErrorInvalidValue;
}

// Largest C one warp holds in registers.
int cs_max_campaigns(void) { return 32 * kMaxPer; }

}  // extern "C"
