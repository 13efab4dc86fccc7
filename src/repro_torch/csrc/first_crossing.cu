// Hand-written Hopper (sm_90a) kernels: per-campaign spend totals and first
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
//    kernels repeat that order exactly; with --fmad=false every add rounds
//    as on the CPU.
//
// What bounds it on the H100. It reads each winner and price once (8 bytes
// per (lane, event)): 0.08 ms for 32 lanes of 1e6 events at 3.35 TB/s.
// What held the first design (one thread per (lane, campaign) walking all
// N events, 77.9 ms for 32 lanes) was latency: S*C chains of N dependent
// steps on S SMs (one SM for a single design).
//
// What the design does about it. A crossing block's in-block scan depends
// on the earlier blocks only through s0 (`s0 + val`), and s0 of the next
// block is s0 + the block's last value. The flat sum is one chain per
// (lane, campaign), but only over that campaign's own sales (a non-sale
// adds +0.0, which changes nothing): ~N/C adds, not N. So a call runs four
// kernels, each wide:
//  A. block_kernel<pass A>, one CTA per (lane, crossing block, 128
//     campaigns): the block staged in shared memory, one thread per
//     campaign walks it in XLA's order and writes the block's total T (the
//     value at its last row) and its number of sales;
//  B. chain_kernel, one CTA per lane: per campaign the s0 chain
//     s0[b+1] = s0[b] + T[b] (one float32 add each, written over T), the
//     exclusive count of the earlier blocks' sales (written over the
//     counts), and an exclusive scan of the campaigns' sale totals, which
//     places each campaign's sales contiguously in a per-lane list;
//  C. block_kernel<pass C>, the grid of A: each thread walks its block
//     again from its s0, tests `s0 + val >= budget` exactly as the
//     sequential walk did, takes the earliest crossing with an integer
//     atomicMin (order-free), and copies its sales, in event order, into
//     the lane's list;
//  D. flat_kernel, one warp per (lane, campaign): the flat sum of its
//     contiguous run of the list, staged in shared memory by coalesced
//     loads and added in order by one lane while the next chunk loads.
// A thread does not visit every row: inside a 16-row group the scan
// changes only at the campaign's own sales (and at the group's first row,
// where the in-group prefix restarts). The CTA stages 1,024 rows at a
// time, and each row's winner sets its bit in its campaign's mask of the
// stage (an integer atomicOr, one per row), so a thread reads its 16-row
// groups' sales as 16-bit masks and walks only the rows it won. The group
// totals are still pushed up XLA's levels for every group. Without budgets
// the passes only count, place and add. Every call takes this path: a
// one-lane call of 256 rows and 100 campaigns took 0.0583 ms on an H100
// (80GB HBM3, 700 W), the first design's single kernel 0.0608 ms, so
// small calls need no path of their own. fc_device_kernels() counts the
// device kernels the calls launched.
//
// A carry (the chunked SORT2AGGREGATE replay). A call may take the rows
// [offset, offset + N) of a longer log of n_global events, offset a
// multiple of `block`, with the running spend s0_in (S, C) and the cap
// times cap_in (S, C) that the earlier rows left (sentinel n_global + 1 =
// not capped). Pass B's chain then starts at s0_in, a crossing's time is
// offset + row + 1, a campaign already capped keeps its time, and s0_out
// gets the running spend after the call's last row. Every block is the
// same block of the whole log, so a log replayed chunk by chunk gives the
// cap times of one call and its running total. With no carry (s0_in and
// cap_in null, offset 0, sentinel N + 1) the bits are a plain call's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // campaigns per CTA
constexpr int kStage = 1024;       // events staged per step (block_kernel)
constexpr int kGroup = 16;         // XLA's scan group
constexpr int kMaxLevels = 8;      // grouped levels of a block < 2^31 rows
constexpr int kChainThreads = 256; // chain_kernel
constexpr int kChainAhead = 8;     // chain_kernel: blocks loaded ahead
constexpr int kFlatWarps = 4;      // flat_kernel: runs (warps) per CTA
constexpr int kFlatChunk = 256;    // flat_kernel: values staged at a time

// XLA's grouped scan of one campaign inside one crossing block. Per grouped
// level l it keeps the in-group prefix g[l] and the exclusive prefix ex[l]
// of the level's earlier groups; `top` is the top level's sequential prefix.
struct BlockScan {
  float g[kMaxLevels], ex[kMaxLevels];
  float top;

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) g[l] = ex[l] = 0.0f;
    top = 0.0f;
  }

  // A finished 16-row group k (of the block's level 0) with total t: push
  // it up the levels, leaving ex[0] the next group's exclusive prefix.
  __device__ __forceinline__ void push(float t, int k, int levels) {
#pragma unroll
    for (int l = 1; l < kMaxLevels; ++l) {
      if (l == levels) {             // the top level: sequential
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
};

// Scratch of the four passes, carved from one buffer.
struct Scratch {
  float* t_s0;        // (S, nb, C): pass A's block totals, then B's s0
  int32_t* cnt_off;   // (S, nb, C): pass A's sale counts, then B's offsets
  int32_t* start;     // (S, C+1): each campaign's first place in the list
  float* list;        // (S, N): each lane's sales grouped by campaign
};

inline size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

inline size_t carve(void* base, int S, int N, int C, int nb, Scratch* out) {
  const size_t cells = (size_t)S * nb * C;
  size_t at = 0;
  char* p = static_cast<char*>(base);
  if (out) out->t_s0 = reinterpret_cast<float*>(p + at);
  at += align256(cells * sizeof(float));
  if (out) out->cnt_off = reinterpret_cast<int32_t*>(p + at);
  at += align256(cells * sizeof(int32_t));
  if (out) out->start = reinterpret_cast<int32_t*>(p + at);
  at += align256((size_t)S * (C + 1) * sizeof(int32_t));
  if (out) out->list = reinterpret_cast<float*>(p + at);
  at += align256((size_t)S * N * sizeof(float));
  return at;
}

// Pass A (kPassC false) or C (kPassC true) over one crossing block of one
// lane, one thread per campaign. grid (nb, S, ceil(C / kThreads)).
template <bool kCross, bool kPassC>
__global__ void __launch_bounds__(kThreads)
block_kernel(const int32_t* __restrict__ winners,   // (S, N)
             const float* __restrict__ prices,      // (S, N)
             const float* __restrict__ budgets,     // (S, C)
             const int32_t* __restrict__ cap_in,    // (S, C) or null
             int32_t* __restrict__ cap_out,         // (S, C)
             Scratch scr, int N, int C, int block, int levels,
             int offset, int sentinel) {
  __shared__ float p_s[kStage];
  // hit_s[span * kThreads + t]: the rows of 32-row span `span` of the stage
  // that campaign c0 + t won, as a bit mask
  __shared__ unsigned hit_s[(kStage / 32) * kThreads];
  const int b = blockIdx.x;
  const int s = blockIdx.y;
  const int c0 = blockIdx.z * kThreads;
  const int c = c0 + threadIdx.x;
  const bool valid = c < C;
  const int nb = gridDim.x;
  const long long row0 = (long long)b * block;
  const int len = (int)min((long long)block, (long long)N - row0);
  const int32_t* w_blk = winners + (size_t)s * N + row0;
  const float* p_blk = prices + (size_t)s * N + row0;
  const size_t cell = ((size_t)s * nb + b) * C + c;

  float s0 = 0.0f, budget = 0.0f;
  int pos = 0;                       // pass C: the next place in the list
  float* list = scr.list + (size_t)s * N;
  // a campaign the earlier rows capped keeps its time (read from the
  // input: the output is written by other blocks meanwhile)
  bool crossed = kPassC && valid && cap_in != nullptr &&
                 cap_in[(size_t)s * C + c] != sentinel;
  if (kPassC && valid) {
    if (kCross) {
      s0 = scr.t_s0[cell];
      budget = budgets[(size_t)s * C + c];
    }
    pos = scr.start[(size_t)s * (C + 1) + c] + scr.cnt_off[cell];
  }
  int count = 0;
  float last = 0.0f;                 // the value at the block's last row
  BlockScan scan;
  scan.reset();
  // a block of <= 16 rows is one sequential group; otherwise 16-row groups
  const int group = levels == 0 ? len : kGroup;

  for (int base = 0; base < len; base += kStage) {
    const int rows = min(kStage, len - base);
    __syncthreads();
    for (int i = threadIdx.x; i < (kStage / 32) * kThreads; i += kThreads)
      hit_s[i] = 0u;
    __syncthreads();
    // stage the prices; each row's winner, if one of this CTA's campaigns,
    // sets its bit (an integer atomicOr: the order does not matter)
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      const int w = w_blk[base + i] - c0;
      p_s[i] = p_blk[base + i];
      if (w >= 0 && w < kThreads)
        atomicOr(&hit_s[(i >> 5) * kThreads + w], 1u << (i & 31));
    }
    __syncthreads();
    if (!valid) continue;
    for (int r0 = 0; r0 < rows; r0 += group) {
      const int glen = min(group, rows - r0);
      const unsigned hits = (hit_s[(r0 >> 5) * kThreads + threadIdx.x] >>
                             (r0 & 31)) & (0xffffffffu >> (32 - glen));
      // the group's first row, then its sales of c: the rows where the
      // scan's value changes
      float g0 = 0.0f + ((hits & 1u) ? p_s[r0] : 0.0f);
      const float ex0 = levels == 0 ? 0.0f : scan.ex[0];
      if (kCross && kPassC && !crossed) {
        const float cum = s0 + (levels == 0 ? g0 : ex0 + g0);
        if (cum >= budget) {
          crossed = true;
          atomicMin(cap_out + (size_t)s * C + c,
                    offset + (int)(row0 + base + r0) + 1);
        }
      }
      if (hits & 1u) {
        ++count;
        if (kPassC) list[pos++] = p_s[r0];
      }
      for (unsigned m = hits & ~1u; m != 0u; m &= m - 1u) {
        const int r = r0 + __ffs(m) - 1;
        const float p = p_s[r];
        ++count;
        if (kPassC) list[pos++] = p;
        if (!kCross) continue;
        g0 = g0 + p;
        if (kPassC && !crossed) {
          const float cum = s0 + (levels == 0 ? g0 : ex0 + g0);
          if (cum >= budget) {
            crossed = true;
            atomicMin(cap_out + (size_t)s * C + c,
                      offset + (int)(row0 + base + r) + 1);
          }
        }
      }
      if (!kCross) continue;
      // levels == 0: the sequential prefix is the value (0.0 + g0 would
      // equal it too, g0 never being -0.0)
      last = levels == 0 ? g0 : ex0 + g0;
      if (levels > 0 && glen == kGroup)
        scan.push(g0, (base + r0) >> 4, levels);
    }
  }
  if (!kPassC && valid) {
    if (kCross) scr.t_s0[cell] = last;
    scr.cnt_off[cell] = count;
  }
}

// Pass B, one CTA per lane: the s0 chains (from s0_in when given, the
// last value to s0_out), the block offsets, each campaign's place in the
// list, and the cap times set to cap_in (the sentinel without a carry).
template <bool kCross>
__global__ void __launch_bounds__(kChainThreads)
chain_kernel(Scratch scr, const float* __restrict__ s0_in,
             const int32_t* __restrict__ cap_in, float* __restrict__ s0_out,
             int32_t* __restrict__ cap_out, int C, int nb, int sentinel) {
  __shared__ int32_t warp_sums[kChainThreads / 32];
  __shared__ int32_t carry;
  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  for (int c0 = 0; c0 < C; c0 += kChainThreads) {
    const int c = c0 + threadIdx.x;
    int total = 0;
    if (c < C) {
      float s0 = kCross && s0_in != nullptr ? s0_in[(size_t)s * C + c]
                                            : 0.0f;
      const size_t first = (size_t)s * nb * C + c;
      for (int b0 = 0; b0 < nb; b0 += kChainAhead) {
        int n_b[kChainAhead];      // loads first, then the chain
        float t[kChainAhead];
#pragma unroll
        for (int k = 0; k < kChainAhead; ++k) {
          if (b0 + k >= nb) break;
          n_b[k] = scr.cnt_off[first + (size_t)(b0 + k) * C];
          if (kCross) t[k] = scr.t_s0[first + (size_t)(b0 + k) * C];
        }
#pragma unroll
        for (int k = 0; k < kChainAhead; ++k) {
          if (b0 + k >= nb) break;
          scr.cnt_off[first + (size_t)(b0 + k) * C] = total;
          total += n_b[k];
          if (kCross) {
            scr.t_s0[first + (size_t)(b0 + k) * C] = s0;
            s0 = s0 + t[k];
          }
        }
      }
      if (kCross) {
        cap_out[(size_t)s * C + c] =
            cap_in != nullptr ? cap_in[(size_t)s * C + c] : sentinel;
        if (s0_out != nullptr) s0_out[(size_t)s * C + c] = s0;
      }
    }
    // exclusive scan of the totals over this tile of campaigns
    int incl = total;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int before = carry;
    for (int w = 0; w < warp; ++w) before += warp_sums[w];
    if (c < C) scr.start[(size_t)s * (C + 1) + c] = before + incl - total;
    __syncthreads();
    if (threadIdx.x == kChainThreads - 1) carry = before + incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) scr.start[(size_t)s * (C + 1) + C] = carry;
}

// Pass D: the flat sum of each (lane, campaign)'s run of the list, in
// event order, one warp per run: the warp stages kFlatChunk values at a
// time in shared memory with coalesced loads, and its lane 0 adds them in
// order while the next chunk is in flight. Past the run's end the chunk
// holds +0.0, and adding +0.0 to a sum that starts at +0.0 changes
// nothing.
__global__ void __launch_bounds__(32 * kFlatWarps)
flat_kernel(Scratch scr, float* __restrict__ spend_out, int S, int N,
            int C) {
  __shared__ __align__(16) float buf[kFlatWarps][kFlatChunk];
  constexpr int kPer = kFlatChunk / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long chain = (long long)blockIdx.x * kFlatWarps + warp;
  if (chain >= (long long)S * C) return;
  const int s = (int)(chain / C), c = (int)(chain % C);
  const int32_t* start = scr.start + (size_t)s * (C + 1);
  const float* run = scr.list + (size_t)s * N + start[c];
  const int n = start[c + 1] - start[c];
  float v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    v[k] = 32 * k + lane < n ? run[32 * k + lane] : 0.0f;
  float flat = 0.0f;
  for (int base = 0; base < n; base += kFlatChunk) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) buf[warp][32 * k + lane] = v[k];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = base + kFlatChunk + 32 * k + lane;
      v[k] = i < n ? run[i] : 0.0f;
    }
    if (lane == 0) {
      const float4* b4 = reinterpret_cast<const float4*>(buf[warp]);
#pragma unroll 16
      for (int q = 0; q < kFlatChunk / 4; ++q) {
        const float4 f = b4[q];
        flat = flat + f.x;
        flat = flat + f.y;
        flat = flat + f.z;
        flat = flat + f.w;
      }
    }
    __syncwarp();
  }
  if (lane == 0) spend_out[(size_t)s * C + c] = flat;
}

unsigned long long g_device_kernels = 0;  // launched by fc_first_crossing

int crossing_levels(int block) {
  int levels = 0;
  for (long long len = block; len > kGroup; len = (len + kGroup - 1) / kGroup)
    ++levels;
  return levels;
}

template <bool kCross>
int launch_blocked(const int32_t* winners, const float* prices,
                   const float* budgets, const float* s0_in,
                   const int32_t* cap_in, int32_t* cap, float* spend,
                   float* s0_out, void* scratch, int S, int N, int C,
                   int block, int levels, int offset, int sentinel,
                   cudaStream_t stream) {
  const int nb = (int)(((long long)N + block - 1) / block);
  Scratch scr;
  carve(scratch, S, N, C, nb, &scr);
  const dim3 grid(nb, S, (C + kThreads - 1) / kThreads);
  if (nb > 0) {                      // N = 0: no block to walk
    block_kernel<kCross, false><<<grid, kThreads, 0, stream>>>(
        winners, prices, budgets, cap_in, cap, scr, N, C, block, levels,
        offset, sentinel);
    g_device_kernels += 1;
  }
  chain_kernel<kCross><<<S, kChainThreads, 0, stream>>>(
      scr, s0_in, cap_in, s0_out, cap, C, nb, sentinel);
  if (nb > 0) {
    block_kernel<kCross, true><<<grid, kThreads, 0, stream>>>(
        winners, prices, budgets, cap_in, cap, scr, N, C, block, levels,
        offset, sentinel);
    g_device_kernels += 1;
  }
  const long long chains = (long long)S * C;
  flat_kernel<<<(unsigned)((chains + kFlatWarps - 1) / kFlatWarps),
                32 * kFlatWarps, 0, stream>>>(scr, spend, S, N, C);
  g_device_kernels += 2;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch fc_first_crossing needs.
long long fc_scratch_bytes(int S, int N, int C, int block) {
  const int nb = (int)(((long long)N + block - 1) / block);
  return (long long)carve(nullptr, S, N, C, nb, nullptr);
}

// Spend totals (and, when `budgets` is not null, cap times) of S lanes.
// `block` is the crossing block (events); the number of grouped levels of
// XLA's scan is derived from it here. The carry (with budgets only):
// `s0_in`, `cap_in` and `s0_out` (S, C) or null, the rows' global
// `offset` (a multiple of `block`) and the cap-time `sentinel` (n_global +
// 1; N + 1 without a carry). `scratch` holds fc_scratch_bytes() bytes.
// Returns the cudaError_t of the launches.
int fc_first_crossing(const int32_t* winners, const float* prices,
                      const float* budgets, const float* s0_in,
                      const int32_t* cap_in, int32_t* cap, float* spend,
                      float* s0_out, void* scratch, int S, int N, int C,
                      int block, int offset, int sentinel,
                      cudaStream_t stream) {
  const int levels = crossing_levels(block);
  if (levels >= kMaxLevels || offset < 0 || offset % block != 0 ||
      (long long)offset + N >= (long long)sentinel)
    return (int)cudaErrorInvalidValue;
  if (budgets == nullptr &&
      (s0_in != nullptr || cap_in != nullptr || s0_out != nullptr))
    return (int)cudaErrorInvalidValue;
  return budgets != nullptr
             ? launch_blocked<true>(winners, prices, budgets, s0_in, cap_in,
                                    cap, spend, s0_out, scratch, S, N, C,
                                    block, levels, offset, sentinel, stream)
             : launch_blocked<false>(winners, prices, budgets, s0_in, cap_in,
                                     cap, spend, s0_out, scratch, S, N, C,
                                     block, levels, offset, sentinel, stream);
}

// Device kernels fc_first_crossing has launched in this process.
long long fc_device_kernels(void) { return (long long)g_device_kernels; }

}  // extern "C"
