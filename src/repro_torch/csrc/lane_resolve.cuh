// The resolve core shared by round_fused.cu (partials_kernel, the passes of
// the fused Algorithm-2 round) and sweep_resolve.cu (sweep_resolve_kernel):
// S scenario lanes resolved against one (N, C) valuation matrix, and each
// (lane, canonical block g, campaign) spend summed in event order.
//
// Work items. An item is one canonical block g and a group of up to L
// lanes whose windows meet g. A grid of one CTA per SM (512 threads) takes
// the items round-robin. Every CTA counts the live (lane, block) pairs from
// the windows in device memory and picks the same L: the most lanes per
// item (fewer re-reads of the valuation rows from L2) whose items still
// give three quarters of the CTAs one each, else 1. A full-day pass at
// S=32, G=32 gives 128 items of 8 lanes; windows inside one block, 32 items
// of one lane. An item owns its (lane, g) sums whole, so the result does
// not depend on which CTA takes it or when; the (lane, g) pairs no item
// owns are written as zeros.
//
// Loads. An item walks the union of its lanes' windows inside block g,
// kRows = 512 rows at a time, in stages of kCols = 16 columns (32 KB, two
// TMA boxes of 256 rows): TMA copies them into a ring of kStages slots,
// completing on one mbarrier a slot, so the next two stages load while
// this one is scanned (4-byte cp.async copies in the same layout when C is
// no multiple of 4).
//
// Scan. Thread r scans row r for all L lanes: one 16-byte shared load of
// four valuations feeds 4 * L bids, one 16-byte broadcast load of a lane's
// four multipliers (the item's multipliers, NaN for an inactive campaign,
// sit in shared memory) feeds four. Per lane a thread keeps the top bid,
// its first index and (second price) the second bid in registers: `best`
// and `second` start at the reserve, a bid replaces `best` only if
// strictly greater and a NaN bid never compares true, so `best` is the
// largest eligible bid and `second` the second price.
//
// Ordered sums. After a tile's last stage each thread writes its row's
// winner (-1 outside the lane's window) and price per lane to shared
// memory. Over the next tile's stages warp 8 + l adds lane l's tile onto
// the item's per-campaign running sums, 32 rows at a time: the rows with
// one winner are a group (__match_any_sync) whose first row adds the
// group's prices in row order, the 32 prices held in registers. So each
// sum is added in event order from +0.0, there are no float atomics, and
// the adds overlap the scan.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "auction_tile.cuh"

namespace lane_resolve {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kThreads;              // rows per tile, one a thread
constexpr int kCols = 16;                    // columns per stage: 64 bytes
constexpr int kQuads = kCols / 4;            // 16-byte quads a stage
constexpr int kBoxRows = 256;                // a TMA box's rows (at most 256)
constexpr int kStages = 3;                   // the ring
constexpr int kMaxLanes = 8;
constexpr size_t kStageBytes = sizeof(float) * kRows * kCols;
// A stage is kRows / kBoxRows (kBoxRows, kCols) boxes in TMA's 64-byte
// swizzle: row r's 16-byte quad q sits at quad q ^ ((r / 2) % 4) of its 64
// bytes, so the 16-byte loads of 8 threads on 8 consecutive rows hit 8
// bank groups. Slots are 1,024-byte aligned, beyond what the swizzle asks.
constexpr size_t kAlign = 1024;
constexpr size_t kRingBytes = kAlign + kStages * kStageBytes;
// per lane: two tiles of (winner, price)
constexpr size_t kLaneTileBytes = sizeof(float) * kRows * 2 * 2;

struct Args {
  const float* values;     // (n_local, C): global rows [offset, +n_local)
  const float* mult;       // (S, C)
  const uint8_t* act;      // (S, C), or (S, N, C) per event
  const float* reserves;   // (S,)
  const int32_t* lo;       // (S,) global, or null = 0
  const int32_t* hi;       // (S,) global, or null = the end of the log
  const uint8_t* alive;    // (S,), read when skip_retired
  float* parts;            // (S, G, C) event-ordered block sums
  int32_t* winners;        // (S, N) when the kernel stores them
  float* prices;           // (S, N)
  int S, n_local, C, offset, n_global, block_size, G;
  int skip_retired, max_lanes;
};

// Dynamic shared memory of an item of up to `lanes` lanes: the ring, the
// per-lane tiles, the lanes' multipliers (C rounded up to kCols) and their
// running sums.
inline size_t smem_bytes(int lanes, int C) {
  const size_t padded = (size_t)(C + kCols - 1) / kCols * kCols;
  return kRingBytes + (size_t)lanes * (kLaneTileBytes +
                                       sizeof(float) * (padded + C));
}

// The most lanes an item may take at C campaigns (8, 4, 2 or 1), 0 if even
// one lane does not fit.
inline int max_lanes(int C, size_t limit) {
  for (int l = kMaxLanes; l >= 1; l >>= 1)
    if (smem_bytes(l, C) <= limit) return l;
  return 0;
}

// The largest C an item of one lane holds.
inline int max_campaigns(size_t limit) {
  int c = (int)((limit - kRingBytes - kLaneTileBytes) / (2 * sizeof(float)));
  while (c > 0 && smem_bytes(1, c) > limit) --c;
  return c;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// TMA: the (kRows, kCols) box at column x, row y of the tensor map into
// `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

// Lane s's rows of the log: its window cut to this slice of the log, empty
// for a retired lane when skip_retired.
__device__ __forceinline__ void lane_window(const Args& a, int s,
                                            long long& w0, long long& w1) {
  if (a.skip_retired && !a.alive[s]) {
    w0 = w1 = 0;
    return;
  }
  w0 = max((long long)(a.lo != nullptr ? a.lo[s] : 0), (long long)a.offset);
  w1 = min((long long)(a.hi != nullptr ? a.hi[s] : a.n_global),
           (long long)a.offset + a.n_local);
}

// Lane s's rows inside canonical block g; empty when w0 >= w1.
__device__ __forceinline__ bool lane_in_block(const Args& a, int s, int g,
                                              long long& w0, long long& w1) {
  lane_window(a, s, w0, w1);
  const long long g0 = (long long)g * a.block_size;
  w0 = max(w0, g0);
  w1 = min(w1, g0 + a.block_size);
  return w0 < w1;
}

// The number of lanes whose windows meet block g (all 32 threads of a warp).
__device__ __forceinline__ int live_lanes(const Args& a, int g, int lane) {
  int n = 0;
  for (int s0 = 0; s0 < a.S; s0 += 32) {
    long long w0, w1;
    const bool live = s0 + lane < a.S && lane_in_block(a, s0 + lane, g, w0,
                                                       w1);
    n += __popc(__ballot_sync(0xffffffffu, live));
  }
  return n;
}

// What an item's threads share besides the dynamic buffers.
struct ItemInfo {
  int g;
  long long u0, u1;                 // the union of its lanes' rows in g
  int lane[kMaxLanes];              // lane of each slot, -1 = empty
  float reserve[kMaxLanes];
  long long w0[kMaxLanes], w1[kMaxLanes];
};

// Dynamic shared memory a CTA may take: the per-block limit less its static
// part (an ItemInfo, four counters, the ring's mbarriers).
constexpr size_t kStaticBytes = 512;
static_assert(sizeof(ItemInfo) + 4 * sizeof(int) +
                      kStages * sizeof(uint64_t) <= kStaticBytes,
              "static shared memory");
constexpr size_t kDynLimit = auction_tile::kMaxSmem - kStaticBytes;

// The largest C the kernels take (a one-lane item).
inline int campaign_limit() { return max_campaigns(kDynLimit); }

// Warp 0: block g and the lanes of item `item` of L lanes each.
template <int L>
__device__ void find_item(const Args& a, int item, ItemInfo& info,
                          int lane) {
  int g = 0, first = 0;
  for (int cum = 0; g < a.G; ++g) {
    const int k = (live_lanes(a, g, lane) + L - 1) / L;
    if (item < cum + k) {
      first = (item - cum) * L;
      break;
    }
    cum += k;
  }
  if (lane < kMaxLanes) {
    info.lane[lane] = -1;
    info.reserve[lane] = 0.0f;
    info.w0[lane] = info.w1[lane] = 0;
  }
  __syncwarp();
  int rank = 0;
  for (int s0 = 0; s0 < a.S && rank < first + L; s0 += 32) {
    const int s = s0 + lane;
    long long w0 = 0, w1 = 0;
    const bool live = s < a.S && lane_in_block(a, s, g, w0, w1);
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    const int r = rank + __popc(mask & ((1u << lane) - 1u));
    if (live && r >= first && r < first + L) {
      const int slot = r - first;
      info.lane[slot] = s;
      info.reserve[slot] = a.reserves[s];
      info.w0[slot] = w0;
      info.w1[slot] = w1;
    }
    rank += __popc(mask);
  }
  __syncwarp();
  if (lane == 0) {
    long long u0 = 0, u1 = 0;
    bool any = false;
    for (int l = 0; l < L; ++l) {
      if (info.lane[l] < 0) continue;
      u0 = any ? min(u0, info.w0[l]) : info.w0[l];
      u1 = any ? max(u1, info.w1[l]) : info.w1[l];
      any = true;
    }
    info.g = g;
    info.u0 = u0;
    info.u1 = u1;
  }
}

// Row r's quad q in a stage slot, in floats: TMA's 64-byte swizzle.
__device__ __forceinline__ int quad_at(int r, int q) {
  return r * kCols + ((q ^ ((r >> 1) & 3)) << 2);
}

// Copy stage (tile rows [row0, row0 + rows), columns [c0, c0 + cols)) into
// a ring slot by 4-byte cp.async copies, in the TMA box's swizzled layout:
// the path for a C that is no multiple of 4 (TMA wants 16-byte row
// strides).
__device__ __forceinline__ void stage_copy(const Args& a, float* slot,
                                           long long row0, int rows, int c0,
                                           int cols) {
  const float* src = a.values + (size_t)(row0 - a.offset) * a.C + c0;
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols, k = i - r * cols;
    cp_async4(slot + quad_at(r, k >> 2) + (k & 3), src + (size_t)r * a.C + k);
  }
}

// The scan of one stage's quads [0, quads) of this thread's row for the L
// lanes: v holds the slot and `off` the swizzled float offsets of the
// row's quads, m the stage's multipliers (lane l's at m + l * kCols), c
// the first column. Per lane: `best` the largest eligible bid so
// far (from the reserve), `second` the second price, `win` its first
// column (-1 if none). kGuard stops at `quads` (a chunk narrower than
// kCols). A bid replaces `best` only if strictly greater (the first index
// wins ties), and an inactive campaign's NaN bid never compares true.
template <int L, bool kSecond, bool kPerEvent, bool kGuard>
__device__ __forceinline__ void scan_row(const float* v, const int (&off)[
                                             kQuads],
                                          const float* m, int c, int quads,
                                          const uint8_t* const* act_rows,
                                          int C, float (&best)[L],
                                          float (&second)[L],
                                          int (&win)[L]) {
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    if (kGuard && j >= quads) break;
    const float4 x = *reinterpret_cast<const float4*>(v + off[j]);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float4 y = *reinterpret_cast<const float4*>(m + l * kCols + 4 * j);
      if constexpr (kPerEvent) {
        // the per-event mask, read per element (off the main path)
        const uint8_t* ar = act_rows[l];
        const int cj = c + 4 * j;
        if (!(ar && cj + 0 < C && ar[cj + 0])) y.x = nanf("");
        if (!(ar && cj + 1 < C && ar[cj + 1])) y.y = nanf("");
        if (!(ar && cj + 2 < C && ar[cj + 2])) y.z = nanf("");
        if (!(ar && cj + 3 < C && ar[cj + 3])) y.w = nanf("");
      }
      const float bids[4] = {x.x * y.x, x.y * y.y, x.z * y.z, x.w * y.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float bid = bids[e];
        const bool gt = bid > best[l];      // strict: first index wins ties
        // fmaxf(second, NaN) is second: an inactive campaign's bid drops
        if (kSecond) second[l] = gt ? best[l] : fmaxf(second[l], bid);
        best[l] = gt ? bid : best[l];
        win[l] = gt ? c + 4 * j + e : win[l];
      }
    }
  }
}

// What run_item keeps in the CTA across items.
struct Ring {
  float* slots;          // kStages slots of kStageBytes, 1,024-byte aligned
  uint64_t* full;        // kStages mbarriers (TMA)
  unsigned issued;       // stages this CTA has put into the ring so far
};

// One item: its lanes' sums over their windows in block g (and, when
// kStore, every (lane, row)'s winner and price).
template <int L, bool kSecond, bool kStore, bool kPerEvent, bool kTma>
__device__ void run_item(const Args& a, const CUtensorMap* tmap,
                         const ItemInfo& info, float* lanes_smem,
                         Ring& ring) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int C = a.C;
  const int n_chunks = (C + kCols - 1) / kCols;
  const int ml = a.max_lanes;
  // per lane (slot l of ml): two tiles of winners and prices; then the
  // multipliers by stage (chunk k's for lane l at (k * ml + l) * kCols)
  // and the sums
  int32_t* res_w = reinterpret_cast<int32_t*>(lanes_smem);
  float* res_p = reinterpret_cast<float*>(res_w + 2 * ml * kRows);
  float* mult_s = res_p + 2 * ml * kRows;
  float* acc = mult_s + (size_t)n_chunks * ml * kCols;

  // the lanes' multipliers, NaN where inactive or past C; zero sums
  for (int i = tid; i < n_chunks * L * kCols; i += kThreads) {
    const int k = i / (L * kCols), l = (i / kCols) % L;
    const int c = k * kCols + i % kCols;
    const int s = info.lane[l];
    const size_t sc = (size_t)s * C + c;
    mult_s[(k * ml + l) * kCols + i % kCols] =
        (s >= 0 && c < C && (kPerEvent || a.act[sc])) ? a.mult[sc]
                                                      : nanf("");
  }
  for (int i = tid; i < L * C; i += kThreads) acc[i] = 0.0f;

  const long long u0 = info.u0;
  const int n_tiles = (int)((info.u1 - u0 + kRows - 1) / kRows);
  const int n_stages = n_tiles * n_chunks;
  const unsigned first = ring.issued;
  auto slot_of = [&](int i) {
    return ring.slots + ((first + i) % kStages) * (kStageBytes / 4);
  };
  auto issue = [&](int i) {
    if (i < n_stages) {
      const int t = i / n_chunks, k = i - t * n_chunks;
      const long long row0 = u0 + (long long)t * kRows;
      if (kTma) {
        if (tid == 0) {
          uint64_t* bar = ring.full + (first + i) % kStages;
          mbar_expect(bar, (uint32_t)kStageBytes);
          for (int b = 0; b < kRows / kBoxRows; ++b)
            tma_load(slot_of(i) + b * kBoxRows * kCols, tmap, k * kCols,
                     (int)(row0 - a.offset) + b * kBoxRows, bar);
        }
      } else {
        stage_copy(a, slot_of(i), row0,
                   (int)min((long long)kRows, info.u1 - row0), k * kCols,
                   min(kCols, C - k * kCols));
      }
    }
    if (!kTma) cp_commit();
  };
  // the mbarriers and the ring have seen every earlier item's stages
  __syncthreads();
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  const int r = tid;                        // this thread's row of a tile
  int off[kQuads];                          // its quads, swizzled
#pragma unroll
  for (int j = 0; j < kQuads; ++j) off[j] = quad_at(r, j);
  float best[L], second[L];
  int win[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    best[l] = second[l] = info.reserve[l];
    win[l] = -1;
  }

  // Tile t's ordered adds, after the barrier that follows its (winner,
  // price) writes: warp kWarps/2 + l adds lane l's rows [r0, r1) in row
  // order, 32 at a time: each same-winner group's first row adds the
  // group's prices in row order. A tile's adds are spread over the next
  // tile's stages, so they overlap its scan.
  const int steps = (kRows / 32 + n_chunks - 1) / n_chunks;
  auto walk = [&](int t, int r0, int r1) {
    const int buf = t & 1;
    const int rows = (int)min((long long)kRows,
                              info.u1 - u0 - (long long)t * kRows);
    r1 = min(r1, rows);
    const int l = warp - kWarps / 2;
    if (l >= 0 && l < L && info.lane[l] >= 0) {
      const int32_t* w = res_w + (buf * ml + l) * kRows;
      const float* p = res_p + (buf * ml + l) * kRows;
      float* sums = acc + l * C;
      for (int rr = r0; rr < r1; rr += 32) {
        const int wi = w[rr + lane];
        const uint32_t peers = __match_any_sync(0xffffffffu, wi);
        // the step's 32 prices in registers, so that a group's adds are a
        // chain of register adds however long the group (adding +0.0 for
        // a row outside it is exact: a running sum is never -0.0)
        float pr[32];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 x = *reinterpret_cast<const float4*>(p + rr + 4 * q);
          pr[4 * q] = x.x;
          pr[4 * q + 1] = x.y;
          pr[4 * q + 2] = x.z;
          pr[4 * q + 3] = x.w;
        }
        if (wi >= 0 && (peers & ((1u << lane) - 1u)) == 0) {
          float s = sums[wi];
#pragma unroll
          for (int k = 0; k < 32; ++k)
            s = s + (((peers >> k) & 1u) ? pr[k] : 0.0f);
          sums[wi] = s;
        }
        __syncwarp();
      }
    }
    if (kStore && r1 > r0) {
      // winners and prices to device memory, a row segment a lane
      const long long row0 = u0 + (long long)t * kRows;
      for (int i = tid; i < L * (r1 - r0); i += kThreads) {
        const int ll = i / (r1 - r0), rr = r0 + i % (r1 - r0);
        const int s = info.lane[ll];
        if (s < 0) continue;
        const size_t at = (size_t)s * a.n_global + row0 + rr;
        a.winners[at] = res_w[(buf * ml + ll) * kRows + rr];
        a.prices[at] = res_p[(buf * ml + ll) * kRows + rr];
      }
    }
  };

  const uint8_t* act_rows[L];
  for (int i = 0; i < n_stages; ++i) {
    if (kTma) {
      mbar_wait(ring.full + (first + i) % kStages,
                ((first + i) / kStages) & 1);
    } else {
      cp_wait<kStages - 2>();
    }
    __syncthreads();                        // stage i is in; slot i-1 free
    issue(i + kStages - 1);
    const int t = i / n_chunks, k = i - t * n_chunks;
    if (t > 0) walk(t - 1, k * steps * 32, (k + 1) * steps * 32);

    const int c0 = k * kCols;
    const int cols = min(kCols, C - c0);
    const float* m = mult_s + (size_t)k * ml * kCols;
    const long long row = u0 + (long long)t * kRows + r;
    const bool row_ok = row < info.u1;
    if constexpr (kPerEvent) {
#pragma unroll
      for (int l = 0; l < L; ++l)
        act_rows[l] = (row_ok && info.lane[l] >= 0)
                          ? a.act + ((size_t)info.lane[l] * a.n_global +
                                     row) * C
                          : nullptr;
    }
    if (cols == kCols) {
      scan_row<L, kSecond, kPerEvent, false>(slot_of(i), off, m, c0, kQuads,
                                             act_rows, C, best, second, win);
    } else {
      scan_row<L, kSecond, kPerEvent, true>(slot_of(i), off, m, c0,
                                            (cols + 3) / 4, act_rows, C, best,
                                            second, win);
    }

    if (k == n_chunks - 1) {
      // the row's (winner, price) per lane, -1 outside the lane's window
      const int buf = t & 1;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const bool in = row_ok && row >= info.w0[l] && row < info.w1[l];
        const int w = in ? win[l] : -1;
        const int at = (buf * ml + l) * kRows + r;
        res_w[at] = w;
        // second price: max(second-highest eligible bid, reserve), which
        // is `second` because it started at the reserve
        res_p[at] = w >= 0 ? (kSecond ? second[l] : best[l]) : 0.0f;
        best[l] = second[l] = info.reserve[l];
        win[l] = -1;
      }
    }
  }
  if (!kTma) cp_wait<0>();
  ring.issued = first + n_stages;
  __syncthreads();
  if (n_tiles > 0) walk(n_tiles - 1, 0, kRows);
  __syncthreads();
  for (int i = tid; i < L * C; i += kThreads) {
    const int l = i / C, c = i - l * C;
    const int s = info.lane[l];
    if (s >= 0) a.parts[((size_t)s * a.G + info.g) * C + c] = acc[i];
  }
}

// The whole pass. Grid: one CTA per SM (or as many as fit); block kThreads.
template <bool kSecond, bool kStore, bool kPerEvent, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
lanes_kernel(const __grid_constant__ CUtensorMap tmap, Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ ItemInfo info;
  __shared__ int items_of[4];               // items of 1, 2, 4, 8 lanes
  __shared__ uint64_t full[kStages];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  Ring ring;
  ring.slots = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~(kAlign - 1));
  ring.full = full;
  ring.issued = 0;
  float* lanes_smem = reinterpret_cast<float*>(smem_raw + kRingBytes);
  if (kTma && tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(full + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // the (lane, block) pairs no item owns are zeros
  for (long long p = blockIdx.x; p < (long long)a.S * a.G; p += gridDim.x) {
    const int s = (int)(p / a.G), g = (int)(p % a.G);
    long long w0, w1;
    if (lane_in_block(a, s, g, w0, w1)) continue;
    float* out = a.parts + (size_t)p * a.C;
    for (int c = tid; c < a.C; c += kThreads) out[c] = 0.0f;
  }

  // L: the most lanes whose items still fill 3/4 of the grid, else 1
  if (tid < 4) items_of[tid] = 0;
  __syncthreads();
  for (int g = warp; g < a.G; g += kWarps) {
    const int n = live_lanes(a, g, lane);
    if (lane < 4) atomicAdd(&items_of[lane], (n + (1 << lane) - 1) >> lane);
  }
  __syncthreads();
  int k = 0;
  for (int kk = 3; kk > 0; --kk)
    if ((1 << kk) <= a.max_lanes && 4 * items_of[kk] >= 3 * (int)gridDim.x) {
      k = kk;
      break;
    }
  const int items = items_of[k];

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    if (warp == 0) {
      switch (k) {
        case 0: find_item<1>(a, item, info, lane); break;
        case 1: find_item<2>(a, item, info, lane); break;
        case 2: find_item<4>(a, item, info, lane); break;
        default: find_item<8>(a, item, info, lane); break;
      }
    }
    __syncthreads();
    switch (k) {
      case 0:
        run_item<1, kSecond, kStore, kPerEvent, kTma>(a, &tmap, info,
                                                      lanes_smem, ring);
        break;
      case 1:
        run_item<2, kSecond, kStore, kPerEvent, kTma>(a, &tmap, info,
                                                      lanes_smem, ring);
        break;
      case 2:
        run_item<4, kSecond, kStore, kPerEvent, kTma>(a, &tmap, info,
                                                      lanes_smem, ring);
        break;
      default:
        run_item<8, kSecond, kStore, kPerEvent, kTma>(a, &tmap, info,
                                                      lanes_smem, ring);
        break;
    }
    __syncthreads();
  }
}

// cuTensorMapEncodeTiled from the driver, looked up once (no link to
// libcuda).
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

template <bool kSecond, bool kStore, bool kPerEvent, bool kTma>
int launch_as(const CUtensorMap& tmap, const Args& a, cudaStream_t stream) {
  auto kernel = lanes_kernel<kSecond, kStore, kPerEvent, kTma>;
  const size_t dyn = smem_bytes(a.max_lanes, a.C);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, dyn);
  if (err != cudaSuccess) return (int)err;
  kernel<<<max(per_sm, 1) * sms, kThreads, dyn, stream>>>(tmap, a);
  return (int)cudaGetLastError();
}

// Launch the pass with one CTA per SM: stages by TMA when every valuation
// row starts on a 16-byte boundary (C a multiple of 4), else by 4-byte
// cp.async copies. Returns a cudaError_t.
template <bool kSecond, bool kStore, bool kPerEvent>
int launch(Args a, cudaStream_t stream) {
  a.max_lanes = max_lanes(a.C, kDynLimit);
  if (a.max_lanes == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tmap;
  memset(&tmap, 0, sizeof(tmap));
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  bool tma = encode != nullptr && a.C % 4 == 0 && a.n_local > 0 &&
             (reinterpret_cast<uintptr_t>(a.values) & 15) == 0;
  if (tma) {
    const cuuint64_t dims[2] = {(cuuint64_t)a.C, (cuuint64_t)a.n_local};
    const cuuint64_t strides[1] = {(cuuint64_t)a.C * sizeof(float)};
    const cuuint32_t box[2] = {kCols, kBoxRows};
    const cuuint32_t unit[2] = {1, 1};
    tma = encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                 const_cast<float*>(a.values), dims, strides, box, unit,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  return tma ? launch_as<kSecond, kStore, kPerEvent, true>(tmap, a, stream)
             : launch_as<kSecond, kStore, kPerEvent, false>(tmap, a, stream);
}

}  // namespace lane_resolve
