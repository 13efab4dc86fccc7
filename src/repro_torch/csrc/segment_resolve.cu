// Hand-written Hopper (sm_90a) kernel: every event of the log resolved for
// S scenario lanes, each under its own segment history (SORT2AGGREGATE's
// replay passes), in one launch that reads the segment table in place.
//
// Replaces, on the port's SORT2AGGREGATE path, the per-lane launches of the
// counterpart of the Pallas TPU kernel `auction_resolve_pallas`
// (repro/kernels/auction_resolve/auction_resolve.py:80, ported as
// csrc/auction_resolve.cu's MatrixTile) on the gathered (N, C) mask
// `segments.masks[seg_ids]`: one resolve and one 100 MB mask gather per lane
// and pass.
//
// What it computes. For lane s and event n: j = the number of inner
// boundaries bounds[s][1..K] that are <= n (`Segments.seg_ids`, a
// searchsorted(right=True); bounds[s][0] and bounds[s][K+1] are not read,
// duplicate boundaries give empty segments); then n is resolved as
// `resolve_masked(values, mult[s], masks[s][j], reserves[s])` does: bid =
// v * mult, eligible = masks[s][j][c] and bid > reserve, the first index of
// the largest eligible bid wins (-1 if none), first price pays the top bid,
// second price max(second-largest eligible bid, reserve). Out: winners
// (S, N) int32 and prices (S, N) float32. Nothing is summed here
// (first_crossing does that), so row tiles are independent.
//
// What bounds it on the H100. The valuations, N*C*4 bytes (400 MB at
// N=1e6, C=100), read once, and S*N*8 bytes of output: 0.12 ms at S=1 and
// 0.20 ms at S=32 at 3.35 TB/s. At S=32 the instructions bind: per (lane,
// event, campaign) a multiply and a max (first price; a max and a min more
// for second price), 6.4e9 at S=32, 0.19 ms at one instruction a thread a
// cycle on 132 SMs. Counting a lane's boundaries and gathering its
// multiplier vector are dependent reads of device memory: done for every
// tile, they cost about a third of a tile.
//
// What the design does about it. A persistent grid: one CTA (512 threads,
// four a row) an SM per 32 lanes, each walking a contiguous run of 128-row
// tiles. With 8 lanes or fewer (simulate's passes: one), whose replay is
// bound by reading the log, each CTA (128 threads, one a row) takes one
// tile and several share an SM, so the hardware balances the stream. A lane's segment changes at most K times over the log, so a CTA
// keeps each lane's current segment, its next boundary and its multiplier
// vector (the segment's mask applied to the lane's multipliers, NaN where
// inactive, which never compares true) in shared memory and rebuilds them
// only where a boundary falls. The tiles stream through a ring of up to
// four stages by TMA (one bulk copy a tile when the rows are an odd number
// of 16-byte quads, as C=100's 25 are; a bulk copy a row into rows padded
// to an odd number of quads otherwise; 4-byte cp.async completing on the
// same mbarrier when C is not a multiple of 4). A thread takes one row and
// 8 of the 32 lanes: per quad one 16-byte load of four valuations feeds 8
// lanes, each keeping its best bid by fmaxf (and second by
// fminf(fmaxf(second, bid), best); a NaN changes neither) and the quad
// where best last rose; the winning column is found in that quad after
// the scan. Rows of a tile past a lane's next boundary are cut pieces: in
// rounds, every lane with a boundary in the tile advances to its next
// segment, rebuilds its vector, and the rows of that piece are scanned
// again under it. The (N, C) mask is never built and the valuations are
// read once. The tile and vectors need about 160*C floats of shared
// memory: above `sg_max_campaigns()`, `kernels/auction_resolve/ops.py`
// takes the per-lane MatrixTile route.
//
// At a row offset (the chunked SORT2AGGREGATE replay): row n of `values`
// is global event offset + n, its segment counted against the global
// boundaries and the last segment ending at offset + N, so a chunk's rows
// get the bits of the same rows of a call over the whole log.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "auction_tile.cuh"

namespace {

constexpr int kRows = 128;                   // rows a tile
constexpr int kPartLanes = 8;                // lanes a thread scans
constexpr int kLaneChunk = 32;               // lanes a CTA, at most

// A CTA of kParts threads a row: kParts * 8 lanes.
template <int kParts>
struct Layout {
  static constexpr int threads = kRows * kParts;
  static constexpr int warps = threads / 32;
  static constexpr int lanes = kPartLanes * kParts;
};
constexpr int kMaxStages = 4;                // tiles in flight, at most
constexpr int kMaxDevices = 64;              // devices whose state is kept

struct Args {
  const float* values;     // (N, C)
  const float* mult;       // (S, C)
  const float* reserves;   // (S,)
  const int32_t* bounds;   // (S, K + 2)
  const uint8_t* masks;    // (S, K + 1, C)
  int32_t* winners;        // (S, N)
  float* prices;           // (S, N)
  int S, N, C, K;
  int offset;              // global index of row 0
  int stages;              // tiles in flight
  int tiles;               // ceil(N / kRows)
};

// A multiplier vector's floats (C up to a multiple of 4, NaN past C).
__host__ __device__ inline int padded(int C) { return (C + 3) & ~3; }

// A staged row's floats: an odd number of 16-byte quads.
__host__ __device__ inline int row_stride(int C) {
  int q = (C + 3) / 4;
  if (q % 2 == 0) ++q;
  return 4 * q;
}

// Per lane: its current segment and next boundary, and a cut piece's rows.
struct LaneState {
  long long next;          // the first global event of the next segment
  long long lo, hi;        // this round's cut piece
  int seg;                 // the segment its vector holds
  int cut;                 // 1: a non-empty piece this round
};

// The ring's tiles, the lanes' vectors, their state and the mbarriers.
inline size_t smem_bytes(int C, int stages, int lanes = kLaneChunk) {
  return sizeof(float) * ((size_t)stages * kRows * row_stride(C) +
                          (size_t)lanes * padded(C)) +
         sizeof(LaneState) * lanes + 8 * kMaxStages;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
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

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Stage the tile's rows into `tile` (rows `stride` floats apart), completing
// on `bar`. kTma: bulk copies, one for the whole tile when rows are not
// padded, else one a row, issued by warp 0; otherwise every thread's 4-byte
// cp.async, each thread's arrival on `bar` when they are done.
template <bool kTma, int kThreads>
__device__ __forceinline__ void stage_tile(const Args& a, float* tile,
                                           uint64_t* bar, long long r0,
                                           int rows, int stride) {
  const int tid = threadIdx.x;
  const int C = a.C;
  const float* src = a.values + (size_t)r0 * C;
  if (kTma) {
    if (tid >= 32) return;
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect(bar, (uint32_t)(4 * rows * C));
    }
    __syncwarp();
    if (stride == C) {
      if (tid == 0) bulk_copy(tile, src, (uint32_t)(4 * rows * C), bar);
    } else {
      for (int r = tid; r < rows; r += 32)
        bulk_copy(tile + (size_t)r * stride, src + (size_t)r * C,
                  (uint32_t)(4 * C), bar);
    }
  } else {
    for (int i = tid; i < rows * C; i += kThreads) {
      const int r = i / C, c = i - r * C;
      cp_async4(tile + (size_t)r * stride + c, src + (size_t)r * C + c);
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                     "r"(smem_addr(bar))
                 : "memory");
  }
}

// Lane s's multipliers under segment j's mask, NaN where inactive or past
// C: element c of the vector.
__device__ __forceinline__ float masked_mult(const Args& a, int s, int j,
                                             int c) {
  return c < a.C && a.masks[((size_t)s * (a.K + 1) + j) * a.C + c]
             ? a.mult[(size_t)s * a.C + c]
             : nanf("");
}

// One row scanned for L lanes: `v` the staged row, lane l's vector at
// vec + l * cp. Per lane best and second start at the reserve; per bid
// best = fmaxf(best, bid) and second = fminf(fmaxf(second, bid), best
// before it) (a NaN bid changes neither), and wq is the quad where best
// last rose strictly. The first column of that quad whose bid equals best
// is the first index of the largest eligible bid.
template <int L, bool kSecond>
__device__ __forceinline__ void scan(const float* v, const float* vec,
                                     int cp, float (&best)[L],
                                     float (&second)[L], int (&win)[L]) {
  int wq[L];
#pragma unroll
  for (int l = 0; l < L; ++l) wq[l] = -1;
  const int quads = cp / 4;
  for (int q = 0; q < quads; ++q) {
    const float4 x = *reinterpret_cast<const float4*>(v + 4 * q);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float4 y =
          *reinterpret_cast<const float4*>(vec + l * cp + 4 * q);
      const float b0 = x.x * y.x, b1 = x.y * y.y, b2 = x.z * y.z,
                  b3 = x.w * y.w;
      const float before = best[l];
      if (kSecond) {
        float bst = before, sec = second[l];
        sec = fminf(fmaxf(sec, b0), bst);
        bst = fmaxf(bst, b0);
        sec = fminf(fmaxf(sec, b1), bst);
        bst = fmaxf(bst, b1);
        sec = fminf(fmaxf(sec, b2), bst);
        bst = fmaxf(bst, b2);
        sec = fminf(fmaxf(sec, b3), bst);
        bst = fmaxf(bst, b3);
        second[l] = sec;
        best[l] = bst;
      } else {
        best[l] = fmaxf(before, fmaxf(fmaxf(b0, b1), fmaxf(b2, b3)));
      }
      wq[l] = best[l] > before ? q : wq[l];
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    win[l] = -1;
    if (wq[l] < 0) continue;
    const float4 x = *reinterpret_cast<const float4*>(v + 4 * wq[l]);
    const float4 y =
        *reinterpret_cast<const float4*>(vec + l * cp + 4 * wq[l]);
    const int e = x.x * y.x == best[l]   ? 0
                  : x.y * y.y == best[l] ? 1
                  : x.z * y.z == best[l] ? 2
                                         : 3;
    win[l] = 4 * wq[l] + e;
  }
}

__device__ __forceinline__ void store(const Args& a, int s, long long row,
                                      int win, float best, float second,
                                      bool second_price) {
  const size_t at = (size_t)s * a.N + row;
  a.winners[at] = win;
  // second price: max(second-highest eligible bid, reserve), which is
  // `second` because it started at the reserve
  a.prices[at] = win >= 0 ? (second_price ? second : best) : 0.0f;
}

// The first pieces of lanes l0 .. l0+L-1 of the chunk: this thread's row,
// stored where it lies before the lane's next boundary.
template <int L, bool kSecond>
__device__ __forceinline__ void first_pieces(const Args& a, const float* v,
                                             const float* vecs, int cp,
                                             const LaneState* st, int s0,
                                             int l0, long long row,
                                             long long g) {
  float best[L], second[L];
  int win[L];
#pragma unroll
  for (int l = 0; l < L; ++l) best[l] = second[l] = a.reserves[s0 + l0 + l];
  scan<L, kSecond>(v, vecs + (size_t)l0 * cp, cp, best, second, win);
#pragma unroll
  for (int l = 0; l < L; ++l)
    if (g < st[l0 + l].next)
      store(a, s0 + l0 + l, row, win[l], best[l], second[l], kSecond);
}

template <bool kSecond, bool kTma, int kParts>
__global__ void __launch_bounds__(Layout<kParts>::threads, 1)
segment_resolve_kernel(Args a) {
  constexpr int kThreads = Layout<kParts>::threads;
  constexpr int kWarps = Layout<kParts>::warps;
  constexpr int kLanes = Layout<kParts>::lanes;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = a.C, K = a.K;
  const int cp = padded(C), stride = row_stride(C);
  const int stages = a.stages;
  float* ring = smem;                                    // stages tiles
  float* vecs = ring + (size_t)stages * kRows * stride;  // (kLanes, cp)
  LaneState* st = reinterpret_cast<LaneState*>(vecs + (size_t)kLanes * cp);
  uint64_t* full = reinterpret_cast<uint64_t*>(st + kLanes);
  const int s0 = blockIdx.y * kLanes;
  const int n_lanes = min(kLanes, a.S - s0);
  // this CTA's run of tiles
  const int t0 = (int)((long long)blockIdx.x * a.tiles / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * a.tiles / gridDim.x);
  const long long g_end = (long long)a.offset + a.N;
  const int part = tid / kRows, row_in = tid % kRows;

  auto rows_of = [&](int t) {
    return (int)min((long long)kRows, (long long)a.N - (long long)t * kRows);
  };
  if (tid == 0)
    for (int i = 0; i < stages; ++i) mbar_init(full + i, kTma ? 1 : kThreads);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  for (int i = 0; i < stages && t0 + i < t1; ++i)
    stage_tile<kTma, kThreads>(a, ring + (size_t)i * kRows * stride,
                               full + i, (long long)(t0 + i) * kRows,
                               rows_of(t0 + i), stride);

  // each lane's segment at the run's first row: a warp a lane counts the
  // inner boundaries at or below it
  const long long g_first = (long long)a.offset + (long long)t0 * kRows;
  for (int l = warp; l < n_lanes; l += kWarps) {
    const int32_t* b = a.bounds + (size_t)(s0 + l) * (K + 2);
    int j = 0;
#pragma unroll 4
    for (int i0 = 1; i0 <= K; i0 += 32) {
      const int i = i0 + lane;
      const long long x = i <= K ? (long long)b[i] : 0;
      j += __popc(__ballot_sync(0xffffffffu, i <= K && x <= g_first));
    }
    if (lane == 0) {
      st[l].seg = j;
      st[l].next = j < K ? (long long)b[j + 1] : g_end;
    }
  }
  __syncthreads();
  for (int i = tid; i < n_lanes * cp; i += kThreads) {
    const int l = i / cp;
    vecs[i] = masked_mult(a, s0 + l, st[l].seg, i - l * cp);
  }
  __syncthreads();

  for (int t = t0; t < t1; ++t) {
    const int it = t - t0;
    const int slot = it % stages;
    const float* tile = ring + (size_t)slot * kRows * stride;
    const long long r0 = (long long)t * kRows;
    const int rows = rows_of(t);
    const long long g0 = a.offset + r0;
    const long long g_last = g0 + rows - 1;
    const long long row = r0 + row_in;
    const long long g = a.offset + row;
    const bool row_ok = row_in < rows;
    const float* v = tile + (size_t)row_in * stride;
    mbar_wait(full + slot, (uint32_t)((it / stages) & 1));

    // every lane's first piece: this part's lanes, 8, 4, 2 or 1 at a time
    if (row_ok) {
      const int end = min(kPartLanes * (part + 1), n_lanes);
      int l = kPartLanes * part;
      for (; l + 8 <= end; l += 8)
        first_pieces<8, kSecond>(a, v, vecs, cp, st, s0, l, row, g);
      if (l + 4 <= end) {
        first_pieces<4, kSecond>(a, v, vecs, cp, st, s0, l, row, g);
        l += 4;
      }
      if (l + 2 <= end) {
        first_pieces<2, kSecond>(a, v, vecs, cp, st, s0, l, row, g);
        l += 2;
      }
      if (l < end) first_pieces<1, kSecond>(a, v, vecs, cp, st, s0, l, row, g);
    }

    // the pieces after a boundary inside the tile, in rounds: each lane
    // with its next boundary in the tile advances one segment
    for (;;) {
      __syncthreads();            // the vectors and the pieces are read
      int more = 0;
      if (tid < n_lanes) {
        LaneState& ls = st[tid];
        ls.cut = 0;
        if (ls.next <= g_last) {
          const int j = ++ls.seg;
          ls.lo = ls.next;
          ls.next = j < K ? (long long)a.bounds[(size_t)(s0 + tid) * (K + 2)
                                                + j + 1]
                          : g_end;
          ls.hi = min(ls.next, g_last + 1);
          ls.cut = ls.lo < ls.hi;   // duplicate boundaries: empty pieces
          more = 1;
        }
      }
      if (!__syncthreads_or(more)) break;
      for (int i = tid; i < n_lanes * cp; i += kThreads) {
        const int l = i / cp;
        if (st[l].cut) vecs[i] = masked_mult(a, s0 + l, st[l].seg, i - l * cp);
      }
      __syncthreads();
      if (row_ok) {
        const int end = min(kPartLanes * (part + 1), n_lanes);
        for (int l = kPartLanes * part; l < end; ++l) {
          if (!st[l].cut || g < st[l].lo || g >= st[l].hi) continue;
          float best[1] = {a.reserves[s0 + l]}, second[1] = {best[0]};
          int win[1];
          scan<1, kSecond>(v, vecs + (size_t)l * cp, cp, best, second, win);
          store(a, s0 + l, row, win[0], best[0], second[0], kSecond);
        }
      }
    }
    // every thread is past the tile: its slot takes the tile `stages` on
    if (t + stages < t1)
      stage_tile<kTma, kThreads>(a, ring + (size_t)slot * kRows * stride,
                                 full + slot, (long long)(t + stages) * kRows,
                                 rows_of(t + stages), stride);
  }
}

template <bool kSecond, bool kTma, int kParts>
int launch_as(const Args& a, dim3 grid, int dev, cudaStream_t stream) {
  auto kernel = segment_resolve_kernel<kSecond, kTma, kParts>;
  // the opt-in is set once a device, to the most any launch may ask
  static bool opted[kMaxDevices] = {false};
  if (!opted[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)auction_tile::kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  const size_t dyn = smem_bytes(a.C, a.stages, Layout<kParts>::lanes);
  kernel<<<grid, Layout<kParts>::threads, dyn, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int kParts>
int launch_rule(const Args& a, dim3 grid, int dev, bool second, bool tma,
                cudaStream_t stream) {
  if (second)
    return tma ? launch_as<true, true, kParts>(a, grid, dev, stream)
               : launch_as<true, false, kParts>(a, grid, dev, stream);
  return tma ? launch_as<false, true, kParts>(a, grid, dev, stream)
             : launch_as<false, false, kParts>(a, grid, dev, stream);
}

}  // namespace

extern "C" {

// The largest C whose tile and vectors fit in a block's shared memory.
int sg_max_campaigns(void) {
  // smem_bytes(c, 1) > 4 c (kRows + kLaneChunk): start above the answer
  int c = (int)(auction_tile::kMaxSmem /
                (sizeof(float) * (kRows + kLaneChunk)));
  while (c > 0 && smem_bytes(c, 1) > auction_tile::kMaxSmem) --c;
  return c;
}

// Resolve N events for S lanes under their segment tables: `bounds` (S,
// K+2) int32, each row sorted, `masks` (S, K+1, C) bool; row n is global
// event offset + n. Writes winners (S, N) int32 and prices (S, N) float32.
// Returns the launch's cudaError_t.
int sg_segment_resolve(const float* values, const float* mult,
                       const float* reserves, const int32_t* bounds,
                       const uint8_t* masks, int32_t* winners, float* prices,
                       int S, int N, int C, int K, int offset,
                       int second_price, cudaStream_t stream) {
  if (S <= 0 || N <= 0) return 0;
  if (C <= 0 || K < 0 || offset < 0 ||
      smem_bytes(C, 1) > auction_tile::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  // the SMs of each device, asked once
  static int sms_of[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int sms = sms_of[dev];
  const int tiles = (N + kRows - 1) / kRows;
  const bool tma =
      C % 4 == 0 && (reinterpret_cast<uintptr_t>(values) & 15) == 0;
  if (S <= kPartLanes) {
    // a few lanes: a CTA of one thread a row a tile, several an SM, the
    // hardware handing the tiles out (a CTA's whole run is one tile)
    const Args a{values, mult, reserves, bounds, masks, winners, prices,
                 S,      N,    C,        K,      offset, 1,      tiles};
    return launch_rule<1>(a, dim3((unsigned)tiles, 1), dev,
                          second_price != 0, tma, stream);
  }
  int stages = kMaxStages;
  while (stages > 1 && smem_bytes(C, stages) > auction_tile::kMaxSmem)
    --stages;
  const Args a{values, mult, reserves, bounds, masks, winners, prices,
               S,      N,    C,        K,      offset, stages, tiles};
  const dim3 grid((unsigned)min(tiles, sms),
                  (unsigned)((S + kLaneChunk - 1) / kLaneChunk));
  return launch_rule<4>(a, grid, dev, second_price != 0, tma, stream);
}

}  // extern "C"
