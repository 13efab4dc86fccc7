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
// 0.20 ms at S=32 at 3.35 TB/s. A multiply and a compare per (lane, event,
// campaign), 6.4e9 at S=32, take 0.10 ms at the float32 rate.
//
// What the design does about it. A grid of 128-row tiles, one CTA (128
// threads) each, fills every SM at any S, S=1 included. A CTA stages its
// tile once (cp.async, 16-byte copies when C is a multiple of 4, rows
// padded to an odd number of 16-byte quads so eight rows' quads fall in
// eight bank groups) and scans it for every lane. Lanes come 32 at a time:
// a warp per lane counts the boundaries at or below the tile's first and
// last rows (ballots over the boundary table, which stays in L1/L2), so a
// lane's segments in the tile are j_lo .. j_hi. Its first piece (segment
// j_lo, the whole tile unless a boundary cuts it) gets a vector of NaN
// multipliers (the segment's mask applied to the lane's multipliers, NaN
// where inactive, which never compares true) in shared memory, and a
// thread scans its row for four lanes at once from one 16-byte load of
// four valuations, the top two bids of each lane in registers. A tile that
// a boundary cuts splits there: each later piece of the lane stages its
// own vector and the rows in it are scanned again under it. The (N, C)
// mask is never built and the valuations are read once a tile. The wide
// tile needs C*128 floats of shared memory: above `sg_max_campaigns()`,
// `kernels/auction_resolve/ops.py` takes the per-lane MatrixTile route.
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

constexpr int kRows = 128;                   // rows a tile, one a thread
constexpr int kThreads = kRows;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneChunk = 32;               // lanes staged together
constexpr int kGroup = 4;                    // lanes a thread scans at once

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
};

// A multiplier vector's floats (C up to a multiple of 4, NaN past C).
__host__ __device__ inline int padded(int C) { return (C + 3) & ~3; }

// A staged row's floats: an odd number of 16-byte quads.
__host__ __device__ inline int row_stride(int C) {
  int q = (C + 3) / 4;
  if (q % 2 == 0) ++q;
  return 4 * q;
}

// The tile, kLaneChunk first-piece vectors, one cut-piece vector, and each
// lane's first and last segment in the tile.
inline size_t smem_bytes(int C) {
  return sizeof(float) * ((size_t)kRows * row_stride(C) +
                          (size_t)(kLaneChunk + 1) * padded(C)) +
         2 * kLaneChunk * sizeof(int);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
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
// vec + l * stride. Per lane `best` starts at the reserve and a bid
// replaces it only if strictly greater (the first index wins ties); a NaN
// bid never compares true and fmaxf(second, NaN) is second.
template <int L, bool kSecond>
__device__ __forceinline__ void scan(const float* v, const float* vec,
                                     int stride, int quads, float (&best)[L],
                                     float (&second)[L], int (&win)[L]) {
  for (int q = 0; q < quads; ++q) {
    const float4 x = *reinterpret_cast<const float4*>(v + 4 * q);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float4 y =
          *reinterpret_cast<const float4*>(vec + l * stride + 4 * q);
      const float bids[4] = {x.x * y.x, x.y * y.y, x.z * y.z, x.w * y.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool gt = bids[e] > best[l];
        if (kSecond) second[l] = gt ? best[l] : fmaxf(second[l], bids[e]);
        best[l] = gt ? bids[e] : best[l];
        win[l] = gt ? 4 * q + e : win[l];
      }
    }
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

// The first pieces of lanes s .. s+L-1 (vectors at `vec`): this thread's
// row, stored where it lies in the piece.
template <int L, bool kSecond>
__device__ __forceinline__ void scan_first_pieces(const Args& a,
                                                  const float* v,
                                                  const float* vec, int s,
                                                  const int* j_lo,
                                                  long long row) {
  float best[L], second[L];
  int win[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    best[l] = second[l] = a.reserves[s + l];
    win[l] = -1;
  }
  scan<L, kSecond>(v, vec, padded(a.C), padded(a.C) / 4, best, second, win);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int j = j_lo[l];
    const long long end =
        j < a.K ? (long long)a.bounds[(size_t)(s + l) * (a.K + 2) + j + 1]
                : (long long)a.offset + a.N;
    if (a.offset + row < end)
      store(a, s + l, row, win[l], best[l], second[l], kSecond);
  }
}

template <bool kSecond>
__global__ void __launch_bounds__(kThreads)
segment_resolve_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = a.C, K = a.K;
  const int cp = padded(C), stride = row_stride(C);
  float* tile = smem;
  float* vecs = tile + (size_t)kRows * stride;   // (kLaneChunk, cp)
  float* cut_vec = vecs + (size_t)kLaneChunk * cp;
  int* j_lo = reinterpret_cast<int*>(cut_vec + cp);
  int* j_hi = j_lo + kLaneChunk;
  const long long r0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, (long long)a.N - r0);
  const long long row = r0 + tid;
  const long long g0 = a.offset + r0;           // the tile's global rows
  const long long g_end = (long long)a.offset + a.N;
  const bool row_ok = tid < rows;
  const float* v = tile + (size_t)tid * stride;

  // the tile, staged once for every lane
  {
    const float* src = a.values + (size_t)r0 * C;
    if (C % 4 == 0 && (reinterpret_cast<uintptr_t>(a.values) & 15) == 0) {
      const int q = C / 4;
      for (int i = tid; i < rows * q; i += kThreads) {
        const int r = i / q, j = i - r * q;
        cp_async16(tile + (size_t)r * stride + 4 * j,
                   src + (size_t)r * C + 4 * j);
      }
    } else {
      for (int i = tid; i < rows * C; i += kThreads) {
        const int r = i / C, c = i - r * C;
        cp_async4(tile + (size_t)r * stride + c, src + (size_t)r * C + c);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  for (int s0 = 0; s0 < a.S; s0 += kLaneChunk) {
    const int n_lanes = min(kLaneChunk, a.S - s0);
    // each lane's segments at the tile's first and last rows: a warp a
    // lane counts the inner boundaries at or below them
    for (int l = warp; l < n_lanes; l += kWarps) {
      const int32_t* b = a.bounds + (size_t)(s0 + l) * (K + 2);
      int lo = 0, hi = 0;
      for (int i0 = 1; i0 <= K; i0 += 32) {
        const int i = i0 + lane;
        const long long x = i <= K ? (long long)b[i] : 0;
        lo += __popc(__ballot_sync(0xffffffffu, i <= K && x <= g0));
        hi += __popc(__ballot_sync(0xffffffffu,
                                   i <= K && x <= g0 + rows - 1));
      }
      if (lane == 0) {
        j_lo[l] = lo;
        j_hi[l] = hi;
      }
    }
    __syncthreads();
    for (int i = tid; i < n_lanes * cp; i += kThreads) {
      const int l = i / cp;
      vecs[i] = masked_mult(a, s0 + l, j_lo[l], i - l * cp);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // every lane's first piece, four lanes at a time
    if (row_ok) {
      for (int l0 = 0; l0 < n_lanes; l0 += kGroup) {
        const float* vec = vecs + (size_t)l0 * cp;
        switch (min(kGroup, n_lanes - l0)) {
          case 4:
            scan_first_pieces<4, kSecond>(a, v, vec, s0 + l0, j_lo + l0, row);
            break;
          case 3:
            scan_first_pieces<3, kSecond>(a, v, vec, s0 + l0, j_lo + l0, row);
            break;
          case 2:
            scan_first_pieces<2, kSecond>(a, v, vec, s0 + l0, j_lo + l0, row);
            break;
          default:
            scan_first_pieces<1, kSecond>(a, v, vec, s0 + l0, j_lo + l0, row);
            break;
        }
      }
    }

    // the pieces after a boundary inside the tile, one at a time
    for (int l = 0; l < n_lanes; ++l) {
      const int s = s0 + l;
      const int32_t* b = a.bounds + (size_t)s * (K + 2);
      for (int j = j_lo[l] + 1; j <= j_hi[l]; ++j) {
        const long long p0 = max((long long)b[j], g0);
        const long long p1 =
            min(j < K ? (long long)b[j + 1] : g_end, g0 + rows);
        if (p0 >= p1) continue;                // an empty segment
        __syncthreads();                       // the last vector is read
        for (int c = tid; c < cp; c += kThreads)
          cut_vec[c] = masked_mult(a, s, j, c);
        __syncthreads();
        if (row_ok && a.offset + row >= p0 && a.offset + row < p1) {
          float best[1] = {a.reserves[s]}, second[1] = {a.reserves[s]};
          int win[1] = {-1};
          scan<1, kSecond>(v, cut_vec, cp, cp / 4, best, second, win);
          store(a, s, row, win[0], best[0], second[0], kSecond);
        }
      }
    }
    __syncthreads();                 // before the next lanes' vectors
  }
}

template <bool kSecond>
int launch_as(const Args& a, cudaStream_t stream) {
  auto kernel = segment_resolve_kernel<kSecond>;
  const size_t dyn = smem_bytes(a.C);
  if (dyn > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned tiles = (unsigned)((a.N + kRows - 1) / kRows);
  kernel<<<tiles, kThreads, dyn, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest C whose tile and vectors fit in a block's shared memory.
int sg_max_campaigns(void) {
  // smem_bytes(c) > 4 c (kRows + kLaneChunk + 1): start above the answer
  int c = (int)(auction_tile::kMaxSmem /
                (sizeof(float) * (kRows + kLaneChunk + 1)));
  while (c > 0 && smem_bytes(c) > auction_tile::kMaxSmem) --c;
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
      smem_bytes(C) > auction_tile::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const Args a{values, mult, reserves, bounds, masks, winners, prices,
               S,      N,    C,        K,      offset};
  return second_price ? launch_as<true>(a, stream)
                      : launch_as<false>(a, stream);
}

}  // extern "C"
