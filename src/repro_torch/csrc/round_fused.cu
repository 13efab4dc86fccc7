// Hand-written Hopper (sm_90a) kernels for one fused Algorithm-2 round.
//
// Replaces the Pallas TPU kernels of repro/kernels/auction_resolve/
// round_fused.py: `sweep_partials_pallas` (:301, body `_partials_kernel`
// :266 with `_resolve_tile` :66 and `_accumulate_partials` :92) and
// `round_fused_pallas` (:197, body `_round_kernel` :130 with `_predict_all`
// :110).
//
// What they compute. S scenario lanes share one (N, C) valuation matrix.
// For each lane s, `partials_kernel` resolves the auctions of the events in
// the lane's window [lo[s], hi[s]) (bid = value * multiplier, eligible when
// active and bid > reserve, first or second price) and reduces the spends
// onto the canonical (S, G = 32, C) grid: parts[s, g, c] is the spend of
// campaign c over the events of canonical block g, added in event order.
// `predict_kernel` folds the rate partials over g in order and predicts the
// next cap-out per lane (c_next, no_cap, n_next). A round is partials over
// [n_hat, N), predict, partials over [n_hat, n_next); the last launch reads
// n_next from device memory, so a round needs no host round trip. Winners
// and prices never leave shared memory.
//
// What bounds it on the H100. One partials pass reads the rows of its
// window once from HBM (N*C*4 bytes: 400 MB at N=1e6, C=100, ~0.12 ms at
// 3.35 TB/s) if L2 serves the other lanes; the work is S*rows*C multiplies
// and compares (3.2e9 at S=32), under 0.1 ms at the 67 TFLOP/s fp32 rate.
// So its least time is set by the bytes, ~0.12 ms a pass.
//
// What the design does about it. The sums must be deterministic and equal
// to the reference's event-ordered segment sum, so there are no float
// atomics: one CTA owns the partials of kLanes lanes for one canonical block
// g, and each (lane, campaign) sum is added in event order inside it. A CTA
// walks the rows of block g that lie inside its lanes' windows (rows
// outside add an exact +0.0 in the reference, so skipping them is exact), a
// tile of kRows rows at a time:
//   1. the tile's valuations and the lanes' multipliers are staged in shared
//      memory with coalesced loads, once for all kLanes lanes;
//   2. one thread per (lane, row) scans the row's bids in campaign order,
//      keeping the top bid, its first index and the second bid in registers
//      (no shuffles; inactive campaigns carry a NaN multiplier and never
//      compare true);
//   3. within each warp (32 rows of one lane) the rows with the same winner
//      form a group (__match_any_sync), and the group's first row adds the
//      group's prices in row order to the campaign's running sum; the two
//      warps of a lane take turns, so every sum is added in event order.
// Built with --fmad=false so that (b - s_hat) / rate and the sums round as
// the reference rounds them. The rows are read from L2 once per CTA, so
// S / kLanes times per pass; issue of the per-element scan (two shared
// loads, a multiply, two compares) is what is left to bound it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;                    // scenario lanes per CTA
constexpr int kRows = 64;                    // rows per tile
constexpr int kThreads = kLanes * kRows;     // one thread per (lane, row)
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;                   // campaigns staged at a time
constexpr size_t kStaticSmem =
    sizeof(float) * (kRows * (kCols + 1) + kLanes * kCols + kLanes * kRows) +
    2 * sizeof(long long) * kLanes;
constexpr size_t kMaxSmem = 232448;          // per-block opt-in limit, sm_90

// (v, i) := smaller value, then lower index (first minimum).
__device__ __forceinline__ void keep_min(float& v, int& i, float v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__global__ void __launch_bounds__(kThreads)
partials_kernel(const float* __restrict__ values,     // (n_local, C)
                const float* __restrict__ mult,       // (S, C)
                const uint8_t* __restrict__ act,      // (S, C) bool
                const float* __restrict__ reserves,   // (S,)
                const int32_t* __restrict__ lo,       // (S,) global
                const int32_t* __restrict__ hi,       // (S,) or null = N
                const uint8_t* __restrict__ alive,    // (S,) bool
                float* __restrict__ parts,            // (S, G, C)
                int S, int n_local, int C, int offset, int n_global,
                int block_size, int G, int second_price, int skip_retired) {
  __shared__ float tile[kRows][kCols + 1];    // +1: conflict-free row reads
  __shared__ float mult_s[kLanes][kCols];     // NaN = inactive campaign
  __shared__ float price_s[kLanes][kRows];
  __shared__ long long win_lo[kLanes], win_hi[kLanes];
  extern __shared__ float acc[];              // (kLanes, C) running sums

  const int tid = threadIdx.x;
  const int l = tid / kRows;                  // this thread's lane ...
  const int r = tid % kRows;                  // ... and row in the tile
  const int s0 = blockIdx.x * kLanes;
  const int g = blockIdx.y;
  const int s = s0 + l;

  // each lane's rows: canonical block g, this slice of the log, its window
  if (tid < kLanes) {
    const int st = s0 + tid;
    long long a = (long long)g * block_size;
    long long b = a + block_size;
    if (st < S && !(skip_retired && !alive[st])) {
      a = max(a, (long long)max(offset, lo[st]));
      b = min(b, (long long)offset + n_local);
      b = min(b, (long long)(hi != nullptr ? hi[st] : n_global));
    }
    win_lo[tid] = a;
    win_hi[tid] = (st < S && !(skip_retired && !alive[st])) ? max(a, b) : a;
  }
  for (int i = tid; i < kLanes * C; i += kThreads) acc[i] = 0.0f;
  __syncthreads();
  long long u0 = 0, u1 = 0;                   // union of the lanes' rows
  bool any = false;
  for (int k = 0; k < kLanes; ++k) {
    if (win_hi[k] == win_lo[k]) continue;
    u0 = any ? min(u0, win_lo[k]) : win_lo[k];
    u1 = any ? max(u1, win_hi[k]) : win_hi[k];
    any = true;
  }
  const long long my_lo = win_lo[l], my_hi = win_hi[l];
  const float reserve = s < S ? reserves[s] : 0.0f;
  const int col = tid % kCols;                // staging: a row segment per
  const int step = kThreads / kCols;          // kCols threads, coalesced

  for (long long base = u0; base < u1; base += kRows) {
    const int rows = (int)min((long long)kRows, u1 - base);
    float best = reserve, second = reserve;   // eligible means bid > reserve
    int win = -1;
    for (int c0 = 0; c0 < C; c0 += kCols) {
      const int cols = min(kCols, C - c0);
      if (col < cols) {
        for (int rr = tid / kCols; rr < rows; rr += step)
          tile[rr][col] = values[(size_t)(base + rr - offset) * C + c0 + col];
        for (int ll = tid / kCols; ll < kLanes; ll += step) {
          const int st = s0 + ll;
          const size_t sc = (size_t)st * C + c0 + col;
          mult_s[ll][col] = (st < S && act[sc]) ? mult[sc] : nanf("");
        }
      }
      __syncthreads();
      if (r < rows) {
        const float* vrow = tile[r];
        const float* mrow = mult_s[l];
        for (int k = 0; k < cols; ++k) {
          const float bid = vrow[k] * mrow[k];
          if (bid > best) {                   // strict: first index wins ties
            second = best;
            best = bid;
            win = c0 + k;
          } else if (bid > second) {
            second = bid;
          }
        }
      }
      __syncthreads();
    }
    const long long row = base + r;
    const int winner = (win >= 0 && r < rows && row >= my_lo && row < my_hi)
                           ? win : -1;
    // second price: max(second-highest eligible bid, reserve), which is
    // `second` because it started at the reserve
    price_s[l][r] = second_price ? second : best;
    __syncwarp();
    for (int half = 0; half < kRows / 32; ++half) {
      if (r / 32 == half) {                   // whole warps
        const unsigned peers = __match_any_sync(0xffffffffu, winner);
        const unsigned lower = (1u << (r % 32)) - 1u;
        if (winner >= 0 && (peers & lower) == 0) {
          float a = acc[l * C + winner];
          for (unsigned m = peers; m != 0u; m &= m - 1u)
            a += price_s[l][half * 32 + __ffs(m) - 1];
          acc[l * C + winner] = a;
        }
      }
      __syncthreads();
    }
  }

  if (s < S) {
    float* out = parts + ((size_t)s * G + g) * C;
    for (int c = r; c < C; c += kRows) out[c] = acc[l * C + c];
  }
}

__global__ void __launch_bounds__(kThreads)
predict_kernel(const float* __restrict__ rate_parts,  // (S, G, C)
               const float* __restrict__ budgets,     // (S, C)
               const float* __restrict__ s_hat,       // (S, C)
               const uint8_t* __restrict__ act,       // (S, C) bool
               const int32_t* __restrict__ n_hat,     // (S,)
               int32_t* __restrict__ c_next,          // (S,)
               uint8_t* __restrict__ no_cap,          // (S,) bool
               int32_t* __restrict__ n_next,          // (S,)
               int C, int G, int n_events) {
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float denom = (float)max(n_events - n_hat[s], 1);

  float best = INFINITY;
  int arg = 0x7fffffff;
  for (int c = tid; c < C; c += kThreads) {
    const float* p = rate_parts + (size_t)s * G * C + c;
    float sum = p[0];
    for (int g = 1; g < G; ++g) sum = sum + p[(size_t)g * C];
    const float rate = sum / denom;
    const size_t sc = (size_t)s * C + c;
    float ttl = (act[sc] && rate > 0.0f) ? (budgets[sc] - s_hat[sc]) / rate
                                         : INFINITY;
    if (ttl < 0.0f) ttl = 0.0f;
    keep_min(best, arg, ttl, c);
  }
  for (int d = 16; d > 0; d >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, best, d);
    const int i2 = __shfl_xor_sync(0xffffffffu, arg, d);
    keep_min(best, arg, v2, i2);
  }
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = arg;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) keep_min(best, arg, red_v[w], red_i[w]);
    const bool none = isinf(best);
    const int step = (int)fminf(floorf(best), (float)n_events);
    c_next[s] = min(arg, C - 1);
    no_cap[s] = none ? 1 : 0;
    n_next[s] = none ? n_events : min(n_hat[s] + step, n_events);
  }
}

inline size_t partials_smem(int C) {
  return (size_t)kLanes * C * sizeof(float);
}

}  // namespace

extern "C" {

// One partials pass (the port of sweep_partials_pallas). `hi` may be null:
// the window then runs to the end of the log. Returns the cudaError_t of the
// launch.
int rf_sweep_partials(const float* values, const float* mult,
                      const uint8_t* act, const float* reserves,
                      const int32_t* lo, const int32_t* hi,
                      const uint8_t* alive, float* parts, int S, int n_local,
                      int C, int offset, int n_global, int block_size, int G,
                      int second_price, int skip_retired,
                      cudaStream_t stream) {
  const size_t dyn = partials_smem(C);
  if (kStaticSmem + dyn > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((S + kLanes - 1) / kLanes, G);
  partials_kernel<<<grid, kThreads, dyn, stream>>>(
      values, mult, act, reserves, lo, hi, alive, parts, S, n_local, C,
      offset, n_global, block_size, G, second_price, skip_retired);
  return (int)cudaGetLastError();
}

// The cap-out prediction from (S, G, C) rate partials (the port of
// _predict_all). Returns the cudaError_t of the launch.
int rf_predict(const float* rate_parts, const float* budgets,
               const float* s_hat, const uint8_t* act, const int32_t* n_hat,
               int32_t* c_next, uint8_t* no_cap, int32_t* n_next, int S,
               int C, int G, int n_events, cudaStream_t stream) {
  predict_kernel<<<S, kThreads, 0, stream>>>(rate_parts, budgets, s_hat, act,
                                             n_hat, c_next, no_cap, n_next, C,
                                             G, n_events);
  return (int)cudaGetLastError();
}

// Largest C whose running sums fit the partials kernel's shared memory.
int rf_max_campaigns(void) {
  return (int)((kMaxSmem - kStaticSmem) / (kLanes * sizeof(float)));
}

}  // extern "C"
