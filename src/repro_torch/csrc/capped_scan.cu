// Hand-written Hopper (sm_90a) kernel: the exact budget-capped sequential
// replay (the paper's Algorithm 1 carried over all campaigns), one scenario
// lane per CTA.
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
// ~0.2 ms at 3.35 TB/s, and the multiplies and compares less. The first
// design (one warp a lane, each event a chain of a column scan, three warp
// reductions and an add: 437 ms for 32 lanes) was held by that chain. But
// an event depends on the earlier ones only through the active set, and
// that changes only when a sale takes its campaign to its budget: at most
// C times a lane.
//
// What the design does about it: speculative windows with a frozen active
// set, repaired at the first cap. A lane's CTA loops over windows of
// kWindow events from n0:
//  1. resolve: the window's events all against the active set at n0, one
//     warp per row, kRows rows at once with every valuation load of up to
//     kChunks 32-column chunks issued before the (branch-free) scan, so a
//     warp keeps kRows * kChunks loads in flight: each thread's columns in
//     ascending order (top two bids, first index on ties), then the merge
//     across the warp: the largest bid by an integer max reduction over
//     order-preserving keys (redux.sync), the lowest index holding it by a
//     min reduction, the bid's exact bits from the winner's thread by one
//     shuffle, and for second price one more max over each thread's best
//     but the winner's thread's second. Winners and prices go to shared
//     memory, and each row's mask of the rows of its 32-row step with the
//     same winner (__match_any_sync);
//  2. ordered sums: warp 0 walks the window's sales in event order, 32 rows
//     at a time, each same-winner group's lowest row adding the group's
//     prices in row order to the campaign's spend, and stops at the first
//     event k after which a spend is no longer below its budget (only the
//     winner's spend moves at an event, so at most one campaign caps
//     there). Meanwhile the other 15 warps resolve the next window against
//     the same active set, into a second buffer: that work is right unless
//     this window caps, which happens at most C times a lane;
//  3. commit: events [n0, k] (the whole window if nothing capped) are the
//     sequential replay's, since the active set was that of n0 until k. The
//     spends stand as they were after k, the capping campaign leaves the
//     active set with cap time k + 1, the window's winners and prices are
//     stored with coalesced writes, and the next window starts at k + 1:
//     already resolved if nothing capped, resolved again otherwise.
// A lane resolves at most N + C * kWindow events. The latency floor is the
// chain of windows, ~N / kWindow + (caps a lane), each the longer of warp
// 0's walk (kWindow / 32 dependent steps) and 15 warps' resolve, and two
// barriers. Every spend takes the same float32 adds in the same order as
// the sequential walk, so the bits are the first design's.
//
// State: spend, budget, the multiplier (NaN once inactive, so a bid is NaN
// and never eligible) and the cap time, 16 bytes a campaign, in shared
// memory up to cs_max_shared_campaigns() campaigns and in device memory
// above it (the outputs and a scratch buffer), so any C that fits the card
// runs. A budget <= 0 caps at event 1 without a sale; a NaN budget is never
// active and never caps.
//
// A scale (naive sampling's sampled replay, repro/core/sequential.py:68):
// with `scale` r != 1 each sale adds p * r to its spend, one float32
// multiply then the add. The reference writes `where(w >= 0, p, 0) / rho`
// with rho a constant, which XLA's simplifier turns into a multiply by the
// float32 reciprocal 1 / rho; the caller passes that reciprocal. The
// stored prices stay p. The exact replay passes 1 and keeps its code and
// bits (a template parameter).
//
// Bids are compared as floats in a thread's scan, and as keys in the merge,
// where -0.0 orders below +0.0; the two differ only for a zero bid under a
// negative reserve.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;                 // one CTA per lane
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                      // rows a warp resolves at once
constexpr int kChunks = 4;                    // 32-column chunks at once
constexpr int kWindow = 1024;                 // events per window
constexpr int kNone = INT_MAX;
constexpr size_t kMaxSmem = 232448;           // per-block opt-in limit, sm_90
// a window's winners, prices and same-winner masks
constexpr size_t kWindowBytes = (size_t)kWindow * 12;
constexpr size_t kStateBytes = 16;            // per campaign in shared memory

// A float's order-preserving unsigned key (-0.0 below +0.0) and back.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

int max_shared_campaigns() {
  return (int)((kMaxSmem - 64 - 2 * kWindowBytes) / kStateBytes);
}

// Resolves the `len` events of the window from n0 against the active set
// `em` into winners w_buf and prices p_buf; warps wi, wi + nw, ... of the
// CTA take kRows rows at a time.
template <bool kSecond>
__device__ __forceinline__ void resolve_window(
    const float* __restrict__ values, const float* em, float reserve, int n0,
    int len, int C, int32_t* w_buf, float* p_buf, int wi, int nw) {
  const int lane = threadIdx.x & 31;
  for (int r0 = wi * kRows; r0 < len; r0 += nw * kRows) {
    float best[kRows], second[kRows];
    int win[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      best[q] = second[q] = reserve;          // eligible: bid > reserve
      win[q] = -1;
    }
    const float* row = values + (size_t)(n0 + r0) * C;
    for (int c0 = 0; c0 < C; c0 += 32 * kChunks) {
      // every load of the step first (kChunks * kRows in flight), then the
      // scan without branches, so no load waits behind a compare
      float v[kChunks][kRows], e[kChunks];
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int c = c0 + 32 * j + lane;
        e[j] = c < C ? em[c] : nanf("");
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          v[j][q] = (c < C && r0 + q < len)
                        ? __ldg(row + (size_t)q * C + c) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int c = c0 + 32 * j + lane;
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const float bid = v[j][q] * e[j];
          const bool gt = bid > best[q];
          if (kSecond) {
            const bool gt2 = bid > second[q];
            second[q] = gt ? best[q] : (gt2 ? bid : second[q]);
          }
          best[q] = gt ? bid : best[q];
          win[q] = gt ? c : win[q];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const unsigned top = __reduce_max_sync(0xffffffffu, ordered(best[q]));
      const unsigned cand = (win[q] >= 0 && ordered(best[q]) == top)
                                ? (unsigned)win[q] : 0xffffffffu;
      const unsigned wmin = __reduce_min_sync(0xffffffffu, cand);
      const int w_all = wmin == 0xffffffffu ? -1 : (int)wmin;
      const float top_bid = __shfl_sync(0xffffffffu, best[q], w_all & 31);
      float price = top_bid;
      if (kSecond) {
        const float mine = (w_all >= 0 && (w_all & 31) == lane)
                               ? second[q] : best[q];
        price = unordered(__reduce_max_sync(0xffffffffu, ordered(mine)));
      }
      if (lane == q && r0 + q < len) {
        w_buf[r0 + q] = w_all;
        p_buf[r0 + q] = w_all >= 0 ? price : 0.0f;
      }
    }
  }
}

// The same-winner groups of a window's rows: for each row, the mask of the
// rows of its 32-row step with its winner (__match_any_sync); warps wi,
// wi + nw, ... take a step at a time.
__device__ __forceinline__ void group_window(const int32_t* w_buf,
                                             unsigned* g_buf, int len,
                                             int wi, int nw) {
  const int lane = threadIdx.x & 31;
  for (int r = wi * 32; r < len; r += nw * 32) {
    const int w = r + lane < len ? w_buf[r + lane] : -1;
    g_buf[r + lane] = __match_any_sync(0xffffffffu, w);
  }
}

// One warp's walk of a window's `len` events in order, 32 at a time: each
// group's lowest row adds its prices in row order to the campaign's spend,
// and the walk stops at the first row after which a spend is no longer
// below its budget (that step's adds are made again up to the row).
// Returns that row, or kNone; the spends stand as after it.
template <bool kScaled>
__device__ __forceinline__ int walk_window(const int32_t* w_buf,
                                           const float* p_buf,
                                           const unsigned* g_buf, int len,
                                           float* sp, const float* bud,
                                           float scale) {
  // a sale's spend increment
  const auto inc = [&](int i) {
    return kScaled ? p_buf[i] * scale : p_buf[i];
  };
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int first = kNone;
  for (int r = 0; r < len && first == kNone; r += 32) {
    const int w = r + lane < len ? w_buf[r + lane] : -1;
    const unsigned peers = g_buf[r + lane];
    const bool leader = w >= 0 && (peers & below) == 0;
    float acc = 0.0f;
    int cross = kNone;
    if (leader) {
      const float b = bud[w];
      acc = sp[w];
      for (unsigned m = peers; m != 0u; m &= m - 1u) {
        const int i = r + __ffs(m) - 1;
        acc = acc + inc(i);
        if (!(acc < b)) {
          cross = i;
          break;
        }
      }
    }
    first = (int)__reduce_min_sync(0xffffffffu, (unsigned)cross);
    if (first != kNone && leader) {           // a cap: the rows up to it
      acc = sp[w];
      for (unsigned m = peers; m != 0u; m &= m - 1u) {
        const int i = r + __ffs(m) - 1;
        if (i > first) break;
        acc = acc + inc(i);
      }
    }
    if (leader) sp[w] = acc;
  }
  return first;
}

template <bool kSecond, bool kShared, bool kScaled>
__global__ void __launch_bounds__(kThreads, 1)
capped_scan_kernel(const float* __restrict__ values,     // (N, C)
                   const float* __restrict__ budgets,    // (S, C)
                   const float* __restrict__ mult,       // (S, C)
                   const float* __restrict__ reserves,   // (S,)
                   int32_t* __restrict__ winners,        // (S, N)
                   float* __restrict__ prices,           // (S, N)
                   float* __restrict__ spend,            // (S, C)
                   int32_t* __restrict__ cap,            // (S, C)
                   float* __restrict__ scratch,          // (S, C) or null
                   int N, int C, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int kmin;
  // two window buffers, each winners, prices and same-winner masks
  const auto w_s = [&](int b) {
    return reinterpret_cast<int32_t*>(smem + b * kWindowBytes);
  };
  const auto p_s = [&](int b) {
    return reinterpret_cast<float*>(w_s(b) + kWindow);
  };
  const auto g_s = [&](int b) {
    return reinterpret_cast<unsigned*>(p_s(b) + kWindow);
  };
  const int s = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float reserve = reserves[s];
  const float* b_in = budgets + (size_t)s * C;
  const float* m_in = mult + (size_t)s * C;

  // the lane's state: in shared memory, or in the outputs and the scratch
  // (a template parameter, so that the compiler knows which and issues
  // shared-memory loads for the first)
  float *em, *sp;
  const float* bud;
  int32_t* cp;
  if (kShared) {
    float* st = reinterpret_cast<float*>(smem + 2 * kWindowBytes);
    em = st;
    sp = st + C;
    float* b_s = st + 2 * C;
    cp = reinterpret_cast<int32_t*>(st + 3 * C);
    for (int c = tid; c < C; c += kThreads) b_s[c] = b_in[c];
    bud = b_s;
  } else {
    em = scratch + (size_t)s * C;
    sp = spend + (size_t)s * C;
    cp = cap + (size_t)s * C;
    bud = b_in;
  }
  for (int c = tid; c < C; c += kThreads) {
    const float b = b_in[c];
    sp[c] = 0.0f;
    em[c] = 0.0f < b ? m_in[c] : nanf("");    // inactive: never bids
    cp[c] = 0.0f >= b ? 1 : N + 1;            // a budget <= 0 caps at 1
  }
  __syncthreads();

  int cur = 0;
  int len = min(kWindow, N);
  if (len > 0) {
    resolve_window<kSecond>(values, em, reserve, 0, len, C, w_s(cur),
                            p_s(cur), warp, kWarps);
    __syncthreads();
    group_window(w_s(cur), g_s(cur), len, warp, kWarps);
    __syncthreads();
  }
  for (int n0 = 0; n0 < N;) {
    // warp 0 walks the window while the other warps resolve the next one
    // against the same active set: right unless this window caps
    const int next0 = n0 + len;
    const int next_len = min(kWindow, N - next0);
    if (warp == 0) {
      const int k = walk_window<kScaled>(w_s(cur), p_s(cur), g_s(cur), len,
                                         sp, bud, scale);
      if (lane == 0) kmin = k;
    } else if (next_len > 0) {
      resolve_window<kSecond>(values, em, reserve, next0, next_len, C,
                              w_s(1 - cur), p_s(1 - cur), warp - 1,
                              kWarps - 1);
      asm volatile("bar.sync 1, %0;" ::"r"(kThreads - 32) : "memory");
      group_window(w_s(1 - cur), g_s(1 - cur), next_len, warp - 1,
                   kWarps - 1);
    }
    __syncthreads();

    // commit events [n0, k] (the whole window if nothing capped)
    const int k = kmin;
    const int m = k == kNone ? len : k + 1;
    if (k != kNone && tid == 0) {             // the campaign that capped
      const int c = w_s(cur)[k];
      em[c] = nanf("");
      if (sp[c] >= bud[c]) cp[c] = n0 + k + 1;
    }
    for (int r = tid; r < m; r += kThreads) {
      winners[(size_t)s * N + n0 + r] = w_s(cur)[r];
      prices[(size_t)s * N + n0 + r] = p_s(cur)[r];
    }
    n0 += m;
    if (k == kNone) {                         // the next window is right
      cur = 1 - cur;
      len = next_len;
    } else if (n0 < N) {                      // resolve it again from k + 1
      __syncthreads();
      len = min(kWindow, N - n0);
      resolve_window<kSecond>(values, em, reserve, n0, len, C, w_s(1 - cur),
                              p_s(1 - cur), warp, kWarps);
      __syncthreads();
      group_window(w_s(1 - cur), g_s(1 - cur), len, warp, kWarps);
      cur = 1 - cur;
    }
    __syncthreads();
  }

  if (kShared) {
    for (int c = tid; c < C; c += kThreads) {
      spend[(size_t)s * C + c] = sp[c];
      cap[(size_t)s * C + c] = cp[c];
    }
  }
}

struct Launch {
  const float *values, *budgets, *mult, *reserves;
  int32_t* winners;
  float *prices, *spend;
  int32_t* cap;
  float* scratch;
  int S, N, C;
  float scale;
};

template <bool kSecond, bool kShared, bool kScaled>
int launch(const Launch& a, cudaStream_t stream) {
  const size_t dyn =
      2 * kWindowBytes + (kShared ? (size_t)a.C * kStateBytes : 0);
  if (dyn > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        capped_scan_kernel<kSecond, kShared, kScaled>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  capped_scan_kernel<kSecond, kShared, kScaled>
      <<<a.S, kThreads, dyn, stream>>>(a.values, a.budgets, a.mult,
                                       a.reserves, a.winners, a.prices,
                                       a.spend, a.cap, a.scratch, a.N, a.C,
                                       a.scale);
  return (int)cudaGetLastError();
}

template <bool kSecond, bool kScaled>
int launch_state(const Launch& a, cudaStream_t stream) {
  if (a.C <= max_shared_campaigns())
    return launch<kSecond, true, kScaled>(a, stream);
  if (a.scratch == nullptr) return (int)cudaErrorInvalidValue;
  return launch<kSecond, false, kScaled>(a, stream);
}

template <bool kSecond>
int launch_rule(const Launch& a, cudaStream_t stream) {
  return a.scale != 1.0f ? launch_state<kSecond, true>(a, stream)
                         : launch_state<kSecond, false>(a, stream);
}

}  // namespace

extern "C" {

// S replays, one CTA each: exact with `scale` 1, each sale's spend
// increment p * scale otherwise. `scratch` holds S * C floats when C is
// above cs_max_shared_campaigns() (null otherwise). Returns the cudaError_t
// of the launch.
int cs_capped_scan(const float* values, const float* budgets,
                   const float* mult, const float* reserves, int32_t* winners,
                   float* prices, float* spend, int32_t* cap, float* scratch,
                   int S, int N, int C, int second_price, float scale,
                   cudaStream_t stream) {
  if (!(scale > 0.0f) || isinf(scale)) return (int)cudaErrorInvalidValue;
  const Launch a{values, budgets, mult, reserves, winners, prices,
                 spend,  cap,     scratch, S,     N,       C, scale};
  return second_price ? launch_rule<true>(a, stream)
                      : launch_rule<false>(a, stream);
}

// Largest C whose state the kernel keeps in shared memory; above it the
// state lives in device memory.
int cs_max_shared_campaigns(void) { return max_shared_campaigns(); }

}  // extern "C"
