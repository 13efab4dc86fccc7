// Hand-written Hopper (sm_90a) kernel: per-campaign spend totals and first
// budget crossings of resolved auctions, in the reference's float order.
//
// Replaces no Pallas kernel. On the TPU this is XLA's work in
// repro/core/segments.py: `first_crossing_times` (:68, a blockwise
// `jnp.cumsum` at :89) and the flat segment sum `auction.spend_sums` that
// gives `aggregate`'s final spend (:55). SORT2AGGREGATE runs it once per
// refine pass and once for the aggregate pass; the port's
// `auction.spend_sums` uses its flat sum on CUDA tensors too, in place of
// `index_add_`, whose atomics add in an order that changes from run to run.
//
// What it computes. S lanes of resolved events, winners (S, N) int32 (-1 =
// no sale) and prices (S, N) float32. For each (lane, campaign):
//  * spend: the flat sum of the campaign's prices in event order, from 0.0
//    (what XLA's segment sum and the CPU's index_add_ add);
//  * cap (when budgets are given): the 1-based index of the first event at
//    which the running spend reaches the budget, N+1 if none. The running
//    spend is the reference's blockwise one: blocks of `block` events, each
//    `s0 + cumsum(block spends)` with s0 the previous block's last value,
//    and the cumsum added in the order of XLA's CPU backend
//    (repro_torch/core/segments.py `xla_cumsum`): 16-row groups with a
//    sequential prefix inside each, the group totals scanned recursively by
//    the same rule, and each row's value the exclusive prefix of the earlier
//    groups plus its in-group prefix. One ulp off moves a cap time, so the
//    kernel repeats that order exactly; with --fmad=false every add rounds
//    as on the CPU.
//
// What bounds it on the H100. It reads each winner and price once (8 bytes
// per (lane, event)); the work is a compare and up to three adds per
// (lane, event, campaign), 9.6e9 at S=32, N=1e6, C=100. Neither bound is
// near: the sums are S*C sequential chains of N dependent adds.
//
// What the design does about it. One thread per (lane, campaign) walks the
// lane's events in order, so every sum is added in event order without
// atomics. The CTA (128 campaigns of one lane) stages 1,024 events at a
// time in shared memory with coalesced loads, and each thread reads them
// as broadcasts. Per crossing level l the thread keeps its in-group prefix
// g[l] and the exclusive prefix ex[l] of the level's earlier groups; a
// finished 16-group pushes its total one level up. A lane has only C
// threads, so a single design (S=1) uses one SM: the chains' latency, not
// the card, bounds it (a later PR can split the blocks across CTAs, since a
// block's scan depends on the earlier blocks only through s0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // campaigns per CTA
constexpr int kTile = 1024;        // events staged per step
constexpr int kGroup = 16;         // XLA's scan group
constexpr int kMaxLevels = 8;      // grouped levels of a block < 2^31 rows

template <bool kCross>
__global__ void __launch_bounds__(kThreads)
first_crossing_kernel(const int32_t* __restrict__ winners,   // (S, N)
                      const float* __restrict__ prices,      // (S, N)
                      const float* __restrict__ budgets,     // (S, C)
                      int32_t* __restrict__ cap_out,         // (S, C)
                      float* __restrict__ spend_out,         // (S, C)
                      int N, int C, int block, int levels) {
  __shared__ int32_t w_s[kTile];
  __shared__ float p_s[kTile];
  const int s = blockIdx.x;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  const bool valid = c < C;
  const int32_t* w_lane = winners + (size_t)s * N;
  const float* p_lane = prices + (size_t)s * N;

  float flat = 0.0f;
  // crossing state: running total s0 of the previous blocks, the top
  // level's sequential prefix, and per grouped level its in-group prefix
  // and the exclusive prefix of its earlier groups
  const float budget = (kCross && valid) ? budgets[(size_t)s * C + c] : 0.0f;
  int cap = N + 1;
  float s0 = 0.0f, top = 0.0f;
  float g[kMaxLevels], ex[kMaxLevels];
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) g[l] = ex[l] = 0.0f;
  int r = 0;                         // row within the crossing block

  for (long long base = 0; base < N; base += kTile) {
    const int rows = (int)min((long long)kTile, (long long)N - base);
    __syncthreads();
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      w_s[i] = w_lane[base + i];
      p_s[i] = p_lane[base + i];
    }
    __syncthreads();
    if (!valid) continue;
    for (int i = 0; i < rows; ++i) {
      const int w = w_s[i];
      const float p = p_s[i];
      if (w == c) flat = flat + p;
      if (!kCross) continue;
      const float x = w == c ? p : 0.0f;
      float val;
      if (levels == 0) {             // a block of <= 16 rows: sequential
        top = r == 0 ? 0.0f + x : top + x;
        val = top;
      } else {
        if (r == 0) {
#pragma unroll
          for (int l = 0; l < kMaxLevels; ++l) ex[l] = 0.0f;
        }
        const int j0 = r & (kGroup - 1);
        g[0] = j0 == 0 ? 0.0f + x : g[0] + x;
        val = ex[0] + g[0];
        if (j0 == kGroup - 1) {      // group done: push its total upward
          float t = g[0];
          int k = r >> 4;
#pragma unroll
          for (int l = 1; l < kMaxLevels; ++l) {
            if (l == levels) {       // the top level: sequential
              top = k == 0 ? 0.0f + t : top + t;
              ex[l - 1] = top;
              break;
            }
            const int j = k & (kGroup - 1);
            g[l] = j == 0 ? 0.0f + t : g[l] + t;
            ex[l - 1] = ex[l] + g[l];
            if (j != kGroup - 1) break;
            t = g[l];
            k >>= 4;
          }
        }
      }
      const float cum = s0 + val;
      if (cap > N && cum >= budget) cap = (int)(base + i) + 1;
      if (++r == block) {
        s0 = cum;
        r = 0;
      }
    }
  }
  if (valid) {
    spend_out[(size_t)s * C + c] = flat;
    if (kCross) cap_out[(size_t)s * C + c] = cap;
  }
}

}  // namespace

extern "C" {

// Spend totals (and, when `budgets` is not null, cap times) of S lanes.
// `block` is the crossing block (events); the number of grouped levels of
// XLA's scan is derived from it here. Returns the cudaError_t of the launch.
int fc_first_crossing(const int32_t* winners, const float* prices,
                      const float* budgets, int32_t* cap, float* spend, int S,
                      int N, int C, int block, cudaStream_t stream) {
  int levels = 0;
  for (long long len = block; len > kGroup; len = (len + kGroup - 1) / kGroup)
    ++levels;
  if (levels >= kMaxLevels) return (int)cudaErrorInvalidValue;
  dim3 grid(S, (C + kThreads - 1) / kThreads);
  if (budgets != nullptr)
    first_crossing_kernel<true><<<grid, kThreads, 0, stream>>>(
        winners, prices, budgets, cap, spend, N, C, block, levels);
  else
    first_crossing_kernel<false><<<grid, kThreads, 0, stream>>>(
        winners, prices, budgets, cap, spend, N, C, block, levels);
  return (int)cudaGetLastError();
}

}  // extern "C"
