// Hand-written Hopper (sm_90a) kernels: per-campaign spend totals and first
// budget crossings of resolved auctions, in the reference's float order.
//
// Replaces no Pallas kernel. On the TPU this is XLA's work in
// repro/core/segments.py: `first_crossing_times` (:68, a blockwise
// `jnp.cumsum` at :89) and the flat segment sum `auction.spend_sums` that
// gives `aggregate`'s final spend (:55). SORT2AGGREGATE runs it once per
// refine pass (caps only) and once for the aggregate pass; the port's
// `auction.spend_sums` uses its flat sum on CUDA tensors too, in place of
// `index_add_`, whose atomics add in an order that changes from run to run.
//
// What it computes. S lanes of resolved events, winners (S, N) int32 (-1 =
// no sale) and prices (S, N) float32. For each (lane, campaign):
//  * spend (unless the call asks for caps only): the flat sum of the
//    campaign's prices in event order, from 0.0 (what XLA's segment sum and
//    the CPU's index_add_ add);
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
// per (lane, event)): 0.08 ms for 32 lanes of 1e6 events at 3.35 TB/s. The
// flat sum is one chain of float32 adds per (lane, campaign), as long as
// the campaign's sales: its floor is the longest such run times the add
// latency.
//
// What the design does about it.
//  * Tiles. A crossing block is cut into tiles of 4,096 = 16^3 rows from
//    its first row: each tile is one entry of the scan's level 3, so the
//    levels below it never cross a tile edge. A tile depends on the rest
//    of its block only through three numbers per campaign, the exclusive
//    prefixes of its first level-0, level-1 and level-2 groups (st0, st1,
//    st2 below), and a block of 250,000 rows is 62 tiles walked at once,
//    not one chain of 250,000 rows.
//  * A walk over sales. A CTA takes one (lane, tile, 128 campaigns): it
//    stages the tile and sorts its rows by campaign, stably (counts, then
//    ranks by __match_any_sync), so each campaign's sales in each level-1
//    group of 256 rows, an item, lie together in row order. A thread walks
//    an item's sales, not its 16-row groups: inside an item the scan's
//    value changes only at the campaign's sales and at a few group starts
//    (below). A campaign's ~N/C sales a lane spread over the 16 items of
//    each tile, so one busy campaign does not hold a CTA.
//  * Few walks. Pass C walks a campaign only in the tiles where its
//    crossing may lie (a bound on the tile's values from pass B); asked
//    for caps only, a CTA with no such campaign stops before reading.
//  * Caps only. A call may skip the spends: no counts, no list, no flat
//    sums (SORT2AGGREGATE's refine passes and the carried replay).
//
// The kernels of a call, each wide:
//  A. tile_kernel<pass A>, grid (tiles, S, ceil(C / 128)): per campaign the
//     tile's in-group sums c0, c1, c2 at its last row (below), and its
//     number of sales when spends are asked (without budgets only that);
//  B. chain_kernel, one CTA per lane, a thread per campaign: per block, the
//     XLA scan of its tiles' totals (the levels above 3), each tile's start
//     state, the value at the block's last row and the s0 chain
//     s0[b+1] = s0[b] + last[b]; with spends, each tile's place in the
//     lane's list of sales grouped by campaign;
//  C. tile_kernel<pass C>, the grid of A: the tile sorted again, its sales
//     copied into the list, and the walks testing `s0 + value >= budget`
//     at the rows where the value changes; the earliest crossing taken
//     with an integer atomicMin (order-free);
//  D. flat_kernel, one warp per (lane, campaign), with spends: the flat sum
//     of its contiguous run of the list, staged in shared memory by
//     coalesced loads and added in order by one lane while the next chunk
//     loads.
// fc_device_kernels() counts the device kernels the calls launched: 4, or
// 3 for caps only (A and C are skipped at N = 0).
//
// The scan inside a tile. Let P_l[x] be the in-group prefix of level l at
// entry x (level 0 the rows, level l+1 the totals of level l's 16-entry
// groups; sums of +0.0 change nothing, so only a campaign's sales add).
// With the tile's start state, the value at row r of level-0 group a is
//   E0(a) + P_0[r],   E0(0) = st0,  E0(a) = E1((a-1) >> 4) + P_1[a-1],
//   E1(0) = st1,      E1(y) = st2 + P_2[y-1],
// each `+` one float32 add, XLA's. Inside an item (level-1 group y) E1 is
// fixed and E0(16 y) = E1(y-1) + V2[y-1] (V2 a level-1 group's total), so
// E0 moves only at the item's first two groups and after a group with a
// sale; pass C tests there and at each sale. The next tile's start state
// and the block's last value follow from c0 = P_0 at the tile's last row
// i, c1 = P_1[(i >> 4) - 1] and c2 = P_2[((i >> 4) - 1 >> 4) - 1] (0
// where the index is < 0): after a whole tile, st0' = (E + c2) + (c1 +
// c0), st1' = E + tot with tot = c2 + (c1 + c0), st2' = the scan of the
// tiles' totals, E this tile's st2; the value at a last row is ((st2 +
// c2) + c1) + c0, or (st1 + c1) + c0 when (i >> 4) - 1 < 16, or st0 + c0
// when i < 16. XLA pushes the group total up a level, not the value at a
// tile's last row: the two differ in rounding, and only the s0 chain
// between blocks takes the last value (`cum[-1]`). Blocks of at most 4,096
// rows are one tile, whose start state is 0 (XLA's top level adds from
// 0.0 as well).
//
// A carry (the chunked SORT2AGGREGATE replay and the sharded crossing). A
// call may take the rows [offset, offset + N) of a longer log of n_global
// events, offset a multiple of `block`, with the running spend s0_in (S,
// C) and the cap times cap_in (S, C) that the earlier rows left (sentinel
// n_global + 1 = not capped). Pass B's chain then starts at s0_in, a
// crossing's time is offset + row + 1, a campaign already capped keeps its
// time, and s0_out gets the running spend after the call's last row. Every
// block is the same block of the whole log, so a log replayed chunk by
// chunk gives the cap times of one call and its running total. With no
// carry (s0_in and cap_in null, offset 0, sentinel N + 1) the bits are a
// plain call's.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kTile = 4096;        // rows of a tile: 16^3, a level-3 entry
constexpr int kThreads = 256;      // tile_kernel
constexpr int kChunk = 128;        // campaigns of a tile CTA
constexpr int kY = kTile / 256;    // level-1 groups (256 rows) of a tile
constexpr int kYS = kY + 1;        // (campaign, level-1 group) row stride
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = kTile / kWarps;  // rows a warp counts and places
constexpr int kGroup = 16;         // XLA's scan group
constexpr int kMaxLevels = 8;      // grouped levels of a block < 2^31 rows
constexpr int kUpLevels = kMaxLevels - 3;  // levels above a tile
constexpr int kChainThreads = 256; // chain_kernel
constexpr int kChainAhead = 16;    // chain_kernel: tiles loaded ahead
// pass C's bound on a tile's values: its last row's value times this
constexpr float kHiMargin = 1.0f + 1.0f / 4096.0f;
constexpr int kFlatWarps = 4;      // flat_kernel: runs (warps) per CTA
constexpr int kFlatChunk = 256;    // flat_kernel: values staged at a time

static_assert(kChunk <= kThreads, "a thread per campaign of the chunk");
static_assert(kWarpRows % 256 == 0, "a warp's rows are whole level-1 groups");

// XLA's grouped inclusive scan of a sequence fed one entry at a time (the
// tiles' totals of one block): entry k's value is the exclusive prefix of
// its level-0 group plus its in-group prefix; a finished group's total is
// pushed up the `levels` grouped levels above level 0. The top level adds
// from an exclusive prefix of 0.0, which equals XLA's sequential prefix.
struct UpScan {
  float g[kUpLevels], ex[kUpLevels];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int l = 0; l < kUpLevels; ++l) g[l] = ex[l] = 0.0f;
  }

  __device__ __forceinline__ float next(float x, int k, int levels) {
    g[0] = (k & (kGroup - 1)) == 0 ? 0.0f + x : g[0] + x;
    const float out = ex[0] + g[0];
    if ((k & (kGroup - 1)) == kGroup - 1) {
      float t = g[0];
#pragma unroll
      for (int l = 1; l < kUpLevels; ++l) {
        if (l > levels) break;
        const int j = (k >> (4 * l)) & (kGroup - 1);
        g[l] = j == 0 ? 0.0f + t : g[l] + t;
        ex[l - 1] = ex[l] + g[l];
        if (j != kGroup - 1) break;
        t = g[l];
      }
    }
    return out;
  }
};

// Scratch of the four passes, carved from one buffer. Cells are (S, T, C),
// T the tiles of a lane, or (S, nb, C) for blocks.
struct Scratch {
  float* f0;          // pass A's c0, then B's st0 (tiles after the first)
  float* f1;          // c1, then st1
  float* f2;          // c2, then st2
  float* hi;          // B's bound on the tile's values (NaN: none)
  int32_t* neg;       // (S, T): A's flag, a negative price in the tile
  float* s0b;         // (S, nb, C): each block's s0
  int32_t* cnt_off;   // pass A's sale counts, then B's places in the list
  int32_t* start;     // (S, C+1): each campaign's first place in the list
  float* list;        // (S, N): each lane's sales grouped by campaign
};

inline size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

inline size_t carve(void* base, int S, int N, int C, int nb, int T,
                    bool cross, bool spends, Scratch* out) {
  const size_t cells = (size_t)S * T * C;
  size_t at = 0;
  char* p = static_cast<char*>(base);
  auto take = [&](size_t bytes) -> void* {
    void* q = p != nullptr ? p + at : nullptr;
    at += align256(bytes);
    return q;
  };
  Scratch s{};
  if (cross) {
    s.f0 = static_cast<float*>(take(cells * sizeof(float)));
    s.f1 = static_cast<float*>(take(cells * sizeof(float)));
    s.f2 = static_cast<float*>(take(cells * sizeof(float)));
    s.hi = static_cast<float*>(take(cells * sizeof(float)));
    s.neg = static_cast<int32_t*>(take((size_t)S * T * sizeof(int32_t)));
    s.s0b = static_cast<float*>(take((size_t)S * nb * C * sizeof(float)));
  }
  if (spends) {
    s.cnt_off = static_cast<int32_t*>(take(cells * sizeof(int32_t)));
    s.start = static_cast<int32_t*>(
        take((size_t)S * (C + 1) * sizeof(int32_t)));
    s.list = static_cast<float*>(take((size_t)S * N * sizeof(float)));
  }
  if (out != nullptr) *out = s;
  return at;
}

// Where a tile lies: tile g of a lane is tile j of block b.
struct TilePlace {
  int b, j, rows;
  long long row0;
};

__device__ __forceinline__ TilePlace place(int g, int N, int block,
                                           int ntb) {
  TilePlace t;
  t.b = g / ntb;
  t.j = g - t.b * ntb;
  const long long b0 = (long long)t.b * block;
  t.row0 = b0 + (long long)t.j * kTile;
  const int len = (int)min((long long)block, (long long)N - b0);
  t.rows = min(kTile, len - t.j * kTile);
  return t;
}

// Shared memory of a tile CTA, carved from its dynamic buffer.
struct TileSmem {
  uint16_t* idx;      // (kTile) the chunk's sales, by campaign, rows in order
  float* price;       // (kTile) their prices, in that order
  int32_t* at;        // (kChunk, kYS) an item's count, then its end
  float* x;           // (kChunk, kYS) an item's total V2; pass C: then E0
                      // at its first group
  float* e1;          // (kChunk, kYS) pass C: E1 of the item's group
  int32_t* cstart;    // (kChunk + 1) each campaign's first place
  float* cam;         // (5, kChunk) per campaign: pass A c0, c1; pass C
                      // s0, budget, the list's base
  int32_t* walk;      // (kChunk) pass C: the campaign is walked
  int32_t* warp;      // (kWarps) the scan's warp totals
};

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

template <bool kCross, bool kPassC>
constexpr size_t tile_smem_bytes() {
  return align16((size_t)kTile * sizeof(float)) +
         align16((size_t)kChunk * kYS * 4) *
             (kPassC && kCross ? 3 : kCross ? 2 : 1) +
         align16((size_t)(kChunk + 1) * 4) + align16((size_t)5 * kChunk * 4) +
         align16((size_t)kChunk * 4) + align16((size_t)kWarps * 4) +
         align16((size_t)kTile * sizeof(uint16_t));
}

template <bool kCross, bool kPassC>
__device__ __forceinline__ TileSmem carve_smem(unsigned char* base) {
  TileSmem m;
  unsigned char* q = base;
  auto take = [&](size_t bytes) {
    unsigned char* r = q;
    q += align16(bytes);
    return r;
  };
  m.price = reinterpret_cast<float*>(take((size_t)kTile * sizeof(float)));
  m.at = reinterpret_cast<int32_t*>(take((size_t)kChunk * kYS * 4));
  m.x = kCross ? reinterpret_cast<float*>(take((size_t)kChunk * kYS * 4))
               : nullptr;
  m.e1 = kCross && kPassC
             ? reinterpret_cast<float*>(take((size_t)kChunk * kYS * 4))
             : nullptr;
  m.cstart = reinterpret_cast<int32_t*>(take((size_t)(kChunk + 1) * 4));
  m.cam = reinterpret_cast<float*>(take((size_t)5 * kChunk * 4));
  m.walk = reinterpret_cast<int32_t*>(take((size_t)kChunk * 4));
  m.warp = reinterpret_cast<int32_t*>(take((size_t)kWarps * 4));
  m.idx = reinterpret_cast<uint16_t*>(take((size_t)kTile * sizeof(uint16_t)));
  return m;
}

// Pass A (kPassC false) or C (kPassC true) over one tile of one lane, for
// campaigns [c0, c0 + kChunk). grid (T, S, ceil(C / kChunk)). The tile's
// rows are sorted by campaign, stably; the work is cut into items, a
// campaign's sales in one level-1 group (256 rows), kY a campaign, so a
// campaign with many sales is walked by kY threads.
template <bool kCross, bool kPassC, bool kSpends>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const int32_t* __restrict__ winners,   // (S, N)
            const float* __restrict__ prices,      // (S, N)
            const float* __restrict__ budgets,     // (S, C)
            const int32_t* __restrict__ cap_in,    // (S, C) or null
            int32_t* __restrict__ cap_out,         // (S, C)
            Scratch scr, int N, int C, int block, int ntb, int nb,
            int offset, int sentinel) {
  constexpr bool kSort = kCross || kPassC;   // else pass A only counts
  constexpr int kRows = kWarpRows / 32;      // rows a lane stages
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TileSmem sm = carve_smem<kCross, kPassC>(smem_raw);
  const int g = blockIdx.x;
  const int s = blockIdx.y;
  const int c0 = blockIdx.z * kChunk;
  const int T = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const TilePlace tp = place(g, N, block, ntb);
  const int32_t* w_t = winners + (size_t)s * N + tp.row0;
  const float* p_t = prices + (size_t)s * N + tp.row0;
  const int n_chunk = min(kChunk, C - c0);   // the chunk's campaigns
  const int t0 = offset + (int)tp.row0 + 1;  // global time of row 0
  const int ng = (tp.rows + kGroup - 1) / kGroup;

  // pass C: a campaign needs the walk unless the earlier rows capped it
  // (cap_in, read from the input: the output is written by other tiles
  // meanwhile), the tile's first row crosses (s0 + st0 >= budget: that
  // row's value is st0 plus a price) or no row can (s0 + hi < budget).
  // With prices >= 0 every value of the tile is a float32 sum, over fewer
  // than 256 adds on any path, of the terms the last row's value sums or
  // fewer: value <= exact * (1 + u)^256 and last >= exact * (1 - u)^256
  // (u = 2^-24), so every value is below last * kHiMargin = hi, and float
  // addition keeps the order. A negative price in the block so far makes
  // hi NaN: every campaign walks. The walked campaigns' E1 and E0 at each
  // level-1 group come from st0, st1, st2 (pass B) and the items' totals.
  bool walk = false;
  float st0 = 0.0f, st1 = 0.0f, st2 = 0.0f;
  if (kPassC && kCross && tid < n_chunk) {
    const int c = c0 + tid;
    const size_t cell = ((size_t)s * T + g) * C + c;
    if (cap_in == nullptr || cap_in[(size_t)s * C + c] == sentinel) {
      const float budget = budgets[(size_t)s * C + c];
      const float s0 = scr.s0b[((size_t)s * nb + tp.b) * C + c];
      if (tp.j > 0) {
        st0 = scr.f0[cell];
        st1 = scr.f1[cell];
        st2 = scr.f2[cell];
      }
      const float hi = scr.hi[cell];
      if (s0 + hi < budget) {
      } else if (hi == hi && s0 + st0 >= budget) {
        atomicMin(cap_out + (size_t)s * C + c, t0);
      } else {
        walk = true;
        sm.cam[2 * kChunk + tid] = s0;
        sm.cam[3 * kChunk + tid] = budget;
      }
    }
  }
  if (kPassC && kCross) {
    if (tid < kChunk) sm.walk[tid] = walk;
    if (!kSpends && !__syncthreads_or(walk)) return;
  }

  // stage: each warp its kWarpRows rows (two level-1 groups), a lane 32
  // apart, in registers; count each item's sales (integer atomics)
  for (int i = tid; i < kChunk * kYS; i += kThreads) sm.at[i] = 0;
  if (!kPassC && tid < kChunk) {
    sm.cam[tid] = 0.0f;              // c0, c1 of campaigns without a sale
    sm.cam[kChunk + tid] = 0.0f;
  }
  __syncthreads();
  const int wr0 = warp * kWarpRows;
  int lcs[kRows];
  float ps[kRows];
  bool neg = false;                  // a negative price in the tile
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = wr0 + 32 * k + lane;
    lcs[k] = -1;
    ps[k] = 0.0f;
    if (row < tp.rows) {
      const int w = w_t[row] - c0;
      if (w >= 0 && w < n_chunk) lcs[k] = w;
      if (kSort) {
        ps[k] = p_t[row];
        neg |= ps[k] < 0.0f;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k)
    if (lcs[k] >= 0)
      atomicAdd(&sm.at[lcs[k] * kYS + ((wr0 + 32 * k) >> 8)], 1);
  neg = __syncthreads_or(neg);
  if (kCross && !kPassC && tid == 0 && blockIdx.z == 0)
    scr.neg[(size_t)s * T + g] = neg;
  // each campaign's items in order: their first places, and the
  // campaign's first place by an exclusive scan over the chunk
  int total = 0;
  if (tid < kChunk) {
#pragma unroll
    for (int y = 0; y < kY; ++y) {
      const int n = sm.at[tid * kYS + y];
      sm.at[tid * kYS + y] = total;
      total += n;
    }
  }
  if (!kSort) {
    if (tid < n_chunk) scr.cnt_off[((size_t)s * T + g) * C + c0 + tid] = total;
    return;
  }
  int incl = total;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) sm.warp[warp] = incl;
  __syncthreads();
  int first = incl - total;
  for (int w = 0; w < warp; ++w) first += sm.warp[w];
  if (tid < kChunk) {
    sm.cstart[tid] = first;
#pragma unroll
    for (int y = 0; y < kY; ++y) sm.at[tid * kYS + y] += first;
  }
  if (tid == kChunk - 1) sm.cstart[kChunk] = first + total;
  __syncthreads();
  // place the rows, a warp its rows 32 at a time in order (32 rows lie in
  // one level-1 group), so each item keeps row order; a place's end
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = wr0 + 32 * k + lane;
    const int it = lcs[k] * kYS + (row >> 8);
    const unsigned peers = __match_any_sync(0xffffffffu, (unsigned)lcs[k]);
    int at = 0;
    if (lcs[k] >= 0) at = sm.at[it] + __popc(peers & below);
    __syncwarp();
    if (lcs[k] >= 0) {
      sm.idx[at] = (uint16_t)row;
      sm.price[at] = ps[k];
      if (lane == 31 - __clz(peers)) sm.at[it] = at + 1;
    }
    __syncwarp();
  }
  __syncthreads();
  // an item's sales are [its start, sm.at): the previous item's end
  auto item_start = [&](int lc, int y) {
    return y == 0 ? sm.cstart[lc] : sm.at[lc * kYS + y - 1];
  };

  const int ai = (tp.rows - 1) >> 4;           // the tile's last group
  const int ya = (ai - 1) >> 4;                // the level-1 group of ai - 1
  if (kCross) {
    // walk 1, an item a thread: the item's total V2, the sequential sum of
    // its 16-row groups' sequential sums; pass A also the last row's c0 =
    // P_0 at the last row and c1 = P_1 at group ai - 1
    for (int it = tid; it < n_chunk * kY; it += kThreads) {
      const int lc = it / kY, y = it - lc * kY;
      if (kPassC && !sm.walk[lc]) continue;
      const int kb = item_start(lc, y), ke = sm.at[lc * kYS + y];
      float g0 = 0.0f, g1 = 0.0f;
      int a0 = -1;
      for (int k = kb; k < ke; ++k) {
        const int a = sm.idx[k] >> 4;
        if (a != a0) {
          if (a0 >= 0) g1 = g1 + g0;
          a0 = a;
          g0 = 0.0f;
        }
        g0 = g0 + sm.price[k];
      }
      if (!kPassC) {
        if (y == (ai >> 4) && a0 == ai) sm.cam[lc] = g0;
        if (ai > 0 && y == ya)
          sm.cam[kChunk + lc] = a0 == ai || a0 < 0 ? g1 : g1 + g0;
      }
      sm.x[lc * kYS + y] = a0 >= 0 ? g1 + g0 : 0.0f;
    }
    __syncthreads();
  }

  if (!kPassC) {                     // pass A: c0, c1, c2 at the last row
    if (tid < n_chunk) {
      const size_t cell = ((size_t)s * T + g) * C + c0 + tid;
      if (kSpends) scr.cnt_off[cell] = total;
      if (kCross) {
        float p2 = 0.0f;             // P_2 at level-1 group ya - 1
        if (ai > 0)
          for (int y = 0; y < ya; ++y) p2 = p2 + sm.x[tid * kYS + y];
        const float v0 = sm.cam[tid], v1 = sm.cam[kChunk + tid];
        if (ntb == 1) {
          // the tile is its block, from a start state of 0: its last
          // value for the s0 chain, its bound for pass C
          const float last = ai == 0    ? 0.0f + v0
                             : ya == 0  ? (0.0f + v1) + v0
                                        : ((0.0f + p2) + v1) + v0;
          scr.f0[cell] = last;
          scr.hi[cell] = neg ? __int_as_float(0x7fffffff) : last * kHiMargin;
        } else {
          scr.f0[cell] = v0;
          scr.f1[cell] = v1;
          scr.f2[cell] = p2;
        }
      }
    }
    return;
  }

  // pass C: each walked campaign's E1 and E0 at its level-1 groups:
  // E1(0) = st1, E1(y) = st2 + P_2[y-1]; E0(0) = st0, E0(16 y) =
  // E1(y-1) + V2[y-1] (x's total, replaced by E0)
  if (kCross && walk) {
    float p2 = 0.0f, e1p = 0.0f, vp = 0.0f;
    for (int y = 0; y < kY; ++y) {
      const float v = sm.x[tid * kYS + y];
      const float e1 = y == 0 ? st1 : st2 + p2;
      sm.x[tid * kYS + y] = y == 0 ? st0 : e1p + vp;
      sm.e1[tid * kYS + y] = e1;
      p2 = p2 + v;
      e1p = e1;
      vp = v;
    }
  }
  // the sales into the list, a warp a campaign: places from pass B
  if (kSpends) {
    if (tid < n_chunk)
      sm.cam[4 * kChunk + tid] = __int_as_float(
          scr.start[(size_t)s * (C + 1) + c0 + tid] +
          scr.cnt_off[((size_t)s * T + g) * C + c0 + tid]);
    __syncthreads();
    float* list = scr.list + (size_t)s * N;
    for (int lc = warp; lc < n_chunk; lc += kWarps) {
      const int base = __float_as_int(sm.cam[4 * kChunk + lc]);
      const int kb = sm.cstart[lc], ke = sm.cstart[lc + 1];
      for (int k = kb + lane; k < ke; k += 32) list[base + k - kb] = sm.price[k];
    }
  }
  if (!kCross) return;
  __syncthreads();
  // walk 2, an item a thread: s0 + value >= budget at the item's first two
  // groups, after each of its groups with a sale and at each sale; values
  // E0(a) + P_0[r], E0(a) = E1 + P_1[a-1] past the item's first group
  for (int it = tid; it < n_chunk * kY; it += kThreads) {
    const int lc = it / kY, y = it - lc * kY;
    const int a_lo = kGroup * y;
    if (!sm.walk[lc] || a_lo >= ng) continue;
    const int a_hi = min(a_lo + kGroup, ng);
    const int kb = item_start(lc, y), ke = sm.at[lc * kYS + y];
    const float s0 = sm.cam[2 * kChunk + lc];
    const float budget = sm.cam[3 * kChunk + lc];
    const float e0_lo = sm.x[lc * kYS + y], e1 = sm.e1[lc * kYS + y];
    int32_t* cap = cap_out + (size_t)s * C + c0 + lc;
    float g1 = 0.0f;                 // P_1 over the item's closed groups
    int f = a_lo, u = INT_MAX;       // the next group starts to test
    int k = kb;
    bool crossed = false;
    while (!crossed) {
      const int an = k < ke ? sm.idx[k] >> 4 : a_hi;  // the next sale group
      for (;;) {
        const int a = min(f, u);
        if (a > an || a >= a_hi) break;
        if (f == a) f = f == a_lo ? a_lo + 1 : INT_MAX;
        if (u == a) u = INT_MAX;
        if (a == an && (sm.idx[k] & (kGroup - 1)) == 0) continue;
        if (s0 + (a == a_lo ? e0_lo : e1 + g1) >= budget) {
          atomicMin(cap, t0 + kGroup * a);
          crossed = true;
          break;
        }
      }
      if (crossed || k >= ke) break;
      const float e0 = an == a_lo ? e0_lo : e1 + g1;
      float g0 = 0.0f;
      for (; k < ke && (sm.idx[k] >> 4) == an; ++k) {
        g0 = g0 + sm.price[k];
        if (s0 + (e0 + g0) >= budget) {
          atomicMin(cap, t0 + sm.idx[k]);
          crossed = true;
          break;
        }
      }
      g1 = g1 + g0;
      u = an + 1;
    }
  }
}

// Pass B, one CTA per lane, a thread per campaign: the tiles' start states
// and the s0 chain (from s0_in when given, the last value to s0_out), the
// cap times set to cap_in (the sentinel without a carry); with spends, each
// tile's place in the list and each campaign's first place.
template <bool kCross, bool kSpends>
__global__ void __launch_bounds__(kChainThreads)
chain_kernel(Scratch scr, const float* __restrict__ s0_in,
             const int32_t* __restrict__ cap_in, float* __restrict__ s0_out,
             int32_t* __restrict__ cap_out, int N, int C, int block,
             int ntb, int nb, int T, int up_levels, int sentinel) {
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
      // the block's scan of its tiles' totals, E = the exclusive prefix of
      // the current tile; the previous whole tile's c2, c1 + c0 and total
      UpScan up;
      up.reset();
      float e = 0.0f, e_prev = 0.0f, c2p = 0.0f, full1p = 0.0f, totp = 0.0f;
      int block_neg = 0;             // a negative price in the block so far
      const size_t first = (size_t)s * T * C + c;
      // blocks of one tile: pass A gave each block's last value (in f0)
      // and its bound; the chain adds them up
      for (int g0 = 0; ntb == 1 && g0 < T; g0 += kChainAhead) {
        int n_g[kChainAhead];
        float last[kChainAhead];
#pragma unroll
        for (int k = 0; k < kChainAhead; ++k) {
          if (g0 + k >= T) break;
          const size_t cell = first + (size_t)(g0 + k) * C;
          if (kSpends) n_g[k] = scr.cnt_off[cell];
          if (kCross) last[k] = scr.f0[cell];
        }
#pragma unroll
        for (int k = 0; k < kChainAhead; ++k) {
          if (g0 + k >= T) break;
          if (kSpends) {
            scr.cnt_off[first + (size_t)(g0 + k) * C] = total;
            total += n_g[k];
          }
          if (kCross) {
            scr.s0b[((size_t)s * nb + g0 + k) * C + c] = s0;
            s0 = s0 + last[k];
          }
        }
      }
      for (int g0 = 0; ntb > 1 && g0 < T; g0 += kChainAhead) {
        int n_g[kChainAhead], neg[kChainAhead];  // loads, then the chain
        float v0[kChainAhead], v1[kChainAhead], v2[kChainAhead];
#pragma unroll
        for (int k = 0; k < kChainAhead; ++k) {
          if (g0 + k >= T) break;
          const size_t cell = first + (size_t)(g0 + k) * C;
          if (kSpends) n_g[k] = scr.cnt_off[cell];
          if (kCross) {
            v0[k] = scr.f0[cell];
            v1[k] = scr.f1[cell];
            v2[k] = scr.f2[cell];
            neg[k] = scr.neg[(size_t)s * T + g0 + k];
          }
        }
#pragma unroll
        for (int k = 0; k < kChainAhead; ++k) {
          const int g = g0 + k;
          if (g >= T) break;
          const size_t cell = first + (size_t)g * C;
          if (kSpends) {
            scr.cnt_off[cell] = total;
            total += n_g[k];
          }
          if (!kCross) continue;
          const int b = g / ntb, j = g - b * ntb;
          const int len = (int)min((long long)block,
                                   (long long)N - (long long)b * block);
          const int nt = (len + kTile - 1) / kTile;
          float st0 = 0.0f, st1 = 0.0f, st2 = 0.0f;
          if (j == 0) {
            scr.s0b[((size_t)s * nb + b) * C + c] = s0;
            up.reset();
            e = 0.0f;
            block_neg = 0;
          } else {
            st0 = (e_prev + c2p) + full1p;
            st1 = e_prev + totp;
            st2 = e;
            scr.f0[cell] = st0;
            scr.f1[cell] = st1;
            scr.f2[cell] = st2;
          }
          // the value at the tile's last row
          const int ai = (min(len - j * kTile, kTile) - 1) >> 4;
          const float last = ai == 0 ? st0 + v0[k]
                             : ((ai - 1) >> 4) == 0 ? (st1 + v1[k]) + v0[k]
                             : ((st2 + v2[k]) + v1[k]) + v0[k];
          block_neg |= neg[k];
          scr.hi[cell] = block_neg ? __int_as_float(0x7fffffff)
                                   : last * kHiMargin;
          if (j < nt - 1) {          // a whole tile: its total goes up
            full1p = v1[k] + v0[k];
            totp = v2[k] + full1p;
            c2p = v2[k];
            e_prev = e;
            e = up.next(totp, j, up_levels);
          } else {                   // the block's last row
            s0 = s0 + last;
          }
        }
      }
      if (kCross) {
        cap_out[(size_t)s * C + c] =
            cap_in != nullptr ? cap_in[(size_t)s * C + c] : sentinel;
        if (s0_out != nullptr) s0_out[(size_t)s * C + c] = s0;
      }
    }
    if (!kSpends) continue;
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
  if (kSpends && threadIdx.x == 0) scr.start[(size_t)s * (C + 1) + C] = carry;
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

int crossing_levels(long long len) {
  int levels = 0;
  for (; len > kGroup; len = (len + kGroup - 1) / kGroup) ++levels;
  return levels;
}

// The shape of a call's tiles: blocks, tiles a whole block, tiles a lane.
struct Tiling {
  int nb, ntb, T;
};

Tiling tiling(int N, int block) {
  Tiling t;
  t.nb = (int)(((long long)N + block - 1) / block);
  t.ntb = (int)(((long long)block + kTile - 1) / kTile);
  const long long last = N - (long long)(t.nb - 1) * block;
  t.T = t.nb == 0 ? 0
                  : (t.nb - 1) * t.ntb + (int)((last + kTile - 1) / kTile);
  return t;
}

template <bool kCross, bool kSpends>
int launch(const int32_t* winners, const float* prices, const float* budgets,
           const float* s0_in, const int32_t* cap_in, int32_t* cap,
           float* spend, float* s0_out, void* scratch, int S, int N, int C,
           int block, int offset, int sentinel, cudaStream_t stream) {
  const Tiling tl = tiling(N, block);
  Scratch scr;
  carve(scratch, S, N, C, tl.nb, tl.T, kCross, kSpends, &scr);
  const int up_levels = crossing_levels(tl.ntb);
  const dim3 grid(tl.T, S, (C + kChunk - 1) / kChunk);
  constexpr size_t smem_a = tile_smem_bytes<kCross, false>();
  constexpr size_t smem_c = tile_smem_bytes<kCross, true>();
  // above 48 KB a kernel opts in, on the current device
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<kCross, false, kSpends>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tile_kernel<kCross, true, kSpends>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_c);
  if (err != cudaSuccess) return (int)err;
  if (tl.T > 0) {                    // N = 0: no tile to walk
    tile_kernel<kCross, false, kSpends><<<grid, kThreads, smem_a, stream>>>(
        winners, prices, budgets, cap_in, cap, scr, N, C, block, tl.ntb,
        tl.nb, offset, sentinel);
    g_device_kernels += 1;
  }
  chain_kernel<kCross, kSpends><<<S, kChainThreads, 0, stream>>>(
      scr, s0_in, cap_in, s0_out, cap, N, C, block, tl.ntb, tl.nb, tl.T,
      up_levels, sentinel);
  g_device_kernels += 1;
  if (tl.T > 0) {
    tile_kernel<kCross, true, kSpends><<<grid, kThreads, smem_c, stream>>>(
        winners, prices, budgets, cap_in, cap, scr, N, C, block, tl.ntb,
        tl.nb, offset, sentinel);
    g_device_kernels += 1;
  }
  if (kSpends) {
    const long long chains = (long long)S * C;
    flat_kernel<<<(unsigned)((chains + kFlatWarps - 1) / kFlatWarps),
                  32 * kFlatWarps, 0, stream>>>(scr, spend, S, N, C);
    g_device_kernels += 1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch fc_first_crossing needs; `modes` bit 0: budgets given,
// bit 1: spends asked.
long long fc_scratch_bytes(int S, int N, int C, int block, int modes) {
  const Tiling tl = tiling(N, block);
  return (long long)carve(nullptr, S, N, C, tl.nb, tl.T, modes & 1,
                          (modes & 2) != 0, nullptr);
}

// Spend totals (unless `spend` is null: caps only) and, when `budgets` is
// not null, cap times of S lanes. `block` is the crossing block (events);
// the number of grouped levels of XLA's scan is derived from it here. The
// carry (with budgets only): `s0_in`, `cap_in` and `s0_out` (S, C) or
// null, the rows' global `offset` (a multiple of `block`) and the cap-time
// `sentinel` (n_global + 1; N + 1 without a carry). `scratch` holds
// fc_scratch_bytes() bytes. Returns the cudaError_t of the launches.
int fc_first_crossing(const int32_t* winners, const float* prices,
                      const float* budgets, const float* s0_in,
                      const int32_t* cap_in, int32_t* cap, float* spend,
                      float* s0_out, void* scratch, int S, int N, int C,
                      int block, int offset, int sentinel,
                      cudaStream_t stream) {
  if (block < 1 || crossing_levels(block) >= kMaxLevels || offset < 0 ||
      offset % block != 0 || (long long)offset + N >= (long long)sentinel)
    return (int)cudaErrorInvalidValue;
  if (budgets == nullptr &&
      (spend == nullptr || s0_in != nullptr || cap_in != nullptr ||
       s0_out != nullptr))
    return (int)cudaErrorInvalidValue;
  if (budgets == nullptr)
    return launch<false, true>(winners, prices, budgets, s0_in, cap_in, cap,
                               spend, s0_out, scratch, S, N, C, block,
                               offset, sentinel, stream);
  return spend != nullptr
             ? launch<true, true>(winners, prices, budgets, s0_in, cap_in,
                                  cap, spend, s0_out, scratch, S, N, C,
                                  block, offset, sentinel, stream)
             : launch<true, false>(winners, prices, budgets, s0_in, cap_in,
                                   cap, spend, s0_out, scratch, S, N, C,
                                   block, offset, sentinel, stream);
}

// Device kernels fc_first_crossing has launched in this process.
long long fc_device_kernels(void) { return (long long)g_device_kernels; }

}  // extern "C"
