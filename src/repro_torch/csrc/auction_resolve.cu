// Hand-written Hopper (sm_90a) kernels: auctions resolved under a
// per-campaign or per-event activation mask, for one design or for S
// designs (lanes) at once.
//
// Replaces the Pallas TPU kernel `auction_resolve_pallas` of
// repro/kernels/auction_resolve/auction_resolve.py (:80, body `_kernel` :28).
// In the port the valuation-matrix kernel (`matrix_lanes_kernel`, with
// `merge_kernel`) resolves every lane of a round of the back-end that takes
// any C (`core/executor.py`, one launch a round) and each segment replay of
// a C above segment_resolve.cu's limit (one lane, mask
// `segments.masks[seg_ids]`); the embedding kernel (`auction_resolve_kernel`,
// "EmbTile") serves `ops.auction_resolve`. SORT2AGGREGATE's main path
// runs vi.cu and segment_resolve.cu instead.
//
// What it computes. For each lane s and event n: bid[c] = v[n, c] *
// mult[s, c]; eligible = act & bid > reserve[s] & live[n], with `act` the
// lane's (C,) mask or, for one lane, an (N, C) mask; the winner is the first
// index of the largest eligible bid (-1 if none); first price pays the top
// bid, second price max(second-largest eligible bid, reserve); no sale pays
// 0. Out: winners (S, N) int32 and prices (S, N) float32. The per-campaign
// spend sums of the TPU kernel are not computed here: ops.py takes them
// from first_crossing.cu's flat sum, added in event order from 0.0 as XLA's
// segment sum is on the CPU. With --fmad=false every product rounds as the
// plain PyTorch version's separate operations do, so winners and prices are
// its bits.
//
// What bounds it on the H100. The valuation matrix is read once for all
// lanes: at the any-C back-end's shape (N=512, C=15,553) 32 MB, ~0.0095 ms
// at 3.35 TB/s; at N=1e6, C=100 with an (N, C) mask 500 MB, ~0.15 ms. With
// many lanes the scan's issue bounds it: per (lane, row, campaign) a
// multiply and a compare, more where a bid enters the top two (N=65,536,
// C=16,384, S=32: 3.4e10 lane-elements; the bytes take 1.28 ms).
//
// What the design does about it (`matrix_lanes_kernel`). The grid runs over
// (128-row tile, campaign chunk): the chunk count is picked from N so that
// about 2 x 132 CTAs run (66 chunks of 236 columns at N=512, C=15,553; one
// chunk from N=33,665). A CTA streams its chunk in windows of 64 floats a row
// through a double buffer by 16-byte cp.async (XOR-swizzled by row, so the
// threads' 16-byte shared loads are conflict-free). C need not be a multiple of
// 4: a row's window starts at the aligned float below its first column, so the
// row's columns sit at a shift of 0-3 floats; the rows of a warp are taken from
// one shift class (rows n, n + P, n + 2P, ... with P = 4 / gcd(C, 4)), so a
// warp scans one column at a time and reads its multipliers by broadcast. The
// multipliers of a window (NaN for an inactive campaign, a column outside the
// chunk or a lane past S, so such a bid never compares true) are loaded into
// registers during the previous window's scan and stored after it. Each window
// is scanned for every lane: a thread holds up to 8 lanes of one row in
// registers (best and second start at the reserve; a bid replaces best only if
// strictly greater, so the first index of the largest wins and second ends as
// the second price), and up to 4 slots of 128 threads share the window, so one
// launch takes 32 lanes a pass over the matrix (more lanes take more passes in
// the same launch). A row tile with one chunk writes winners and prices; with
// several each CTA writes its (best, win, second) per (lane, chunk, row), and
// `merge_kernel`, one thread a (lane, row), merges the chunks in ascending
// column order: a later chunk wins only on a strictly larger best, the second
// price is max(its second, the earlier best) if it wins, else max(the earlier
// second, its best). Every step is a comparison, so the bits are the unchunked
// scan's; no atomics. For one lane an (N, C) mask is staged beside the
// valuations by 4-byte cp.async (the same flat offsets as bytes).
//
// The embedding kernel (`auction_resolve_kernel`, one design): one thread
// per event row, 128 rows a CTA, the valuations computed in registers from
// embeddings (Eq. 12): min(exp((e . r) * (1 / (2 sqrt d))) / 10, 1), the
// dot a fixed-order float32 loop over d with the campaign embeddings staged
// in shared memory, IEEE expf (never __expf) and IEEE division; bf16
// embeddings are widened to float32 on load, as the TPU kernel does. A
// per-event mask is staged 64 columns at a time. It reads 40 MB of
// embeddings at N=1e6, d=10 and does ~2d+30 operations per (event,
// campaign), ~5e9: ~0.08 ms at 67 TFLOP/s, so operations bound it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "auction_tile.cuh"

namespace {

constexpr int kRows = 128;                   // rows (threads) per CTA
constexpr int kCols = 64;                    // columns staged per chunk
constexpr size_t kStaticSmem = kRows * kCols + kCols * sizeof(float);

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The embedding kernel: valuations computed from embeddings (Eq. 12). The
// campaign embeddings (C, d) and the CTA's event rows (kRows, d), widened to
// float32, live in dynamic shared memory, C*d + kRows*d floats.
template <typename T, bool kPerEvent>
__global__ void __launch_bounds__(kRows)
auction_resolve_kernel(const T* __restrict__ event_emb,    // (N, d)
                       const T* __restrict__ campaign_emb, // (C, d)
                       int d, float inv_scale,             // 1 / (2 sqrt d)
                       const float* __restrict__ mult,       // (C,)
                       const uint8_t* __restrict__ act,      // ([N,] C)
                       const uint8_t* __restrict__ live,     // (N,) or null
                       const float* __restrict__ reserve_p,  // ()
                       int32_t* __restrict__ winners,        // (N,)
                       float* __restrict__ prices,           // (N,)
                       int N, int C, int second_price) {
  __shared__ uint8_t act_s[kRows][kCols];
  __shared__ float mult_s[kCols];            // NaN = inactive campaign
  extern __shared__ float smem[];            // campaign, then event rows

  const int r = threadIdx.x;
  const long long base = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, (long long)N - base);
  const long long row = base + r;
  const bool mine = r < rows && (live == nullptr || live[row] != 0);
  const float reserve = *reserve_p;
  float best = reserve, second = reserve;    // eligible means bid > reserve
  int win = -1;
  float* e_s = smem + (size_t)C * d;
  for (int i = r; i < C * d; i += kRows) smem[i] = widen(campaign_emb[i]);
  for (int i = r; i < rows * d; i += kRows)
    e_s[i] = widen(event_emb[base * d + i]);
  const float* e = e_s + (size_t)r * d;

  for (int c0 = 0; c0 < C; c0 += kCols) {
    const int cols = min(kCols, C - c0);
    __syncthreads();                         // the previous chunk is read
    if (kPerEvent) {
      for (int i = r; i < rows * cols; i += kRows) {
        const int rr = i / cols, k = i % cols;
        act_s[rr][k] = act[(base + rr) * C + c0 + k];
      }
    }
    for (int k = r; k < cols; k += kRows)
      mult_s[k] = (kPerEvent || act[c0 + k]) ? mult[c0 + k] : nanf("");
    __syncthreads();
    if (mine) {
      for (int k = 0; k < cols; ++k) {
        if (kPerEvent && !act_s[r][k]) continue;
        const float* q = smem + (size_t)(c0 + k) * d;
        float dot = e[0] * q[0];
        for (int j = 1; j < d; ++j) dot = dot + e[j] * q[j];
        const float value = fminf(expf(dot * inv_scale) / 10.0f, 1.0f);
        const float bid = value * mult_s[k];
        if (bid > best) {                    // strict: first index wins ties
          second = best;
          best = bid;
          win = c0 + k;
        } else if (bid > second) {
          second = bid;
        }
      }
    }
  }
  if (r < rows) {
    const int winner = mine ? win : -1;
    // second price: max(second-highest eligible bid, reserve), which is
    // `second` because it started at the reserve
    winners[row] = winner;
    prices[row] = winner >= 0 ? (second_price ? second : best) : 0.0f;
  }
}

template <typename T>
int launch_emb(const T* event_emb, const T* campaign_emb, int d,
               float inv_scale, const float* mult, const uint8_t* act,
               const uint8_t* live, const float* reserve, int32_t* winners,
               float* prices, int N, int C, int per_event, int second_price,
               cudaStream_t stream) {
  const size_t dyn = (size_t)(C + kRows) * d * sizeof(float);
  auto kernel = per_event ? auction_resolve_kernel<T, true>
                          : auction_resolve_kernel<T, false>;
  if (kStaticSmem + dyn > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((N + kRows - 1) / kRows);
  kernel<<<blocks, kRows, dyn, stream>>>(event_emb, campaign_emb, d,
                                         inv_scale, mult, act, live, reserve,
                                         winners, prices, N, C, second_price);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The valuation-matrix kernel: S lanes a launch, campaign chunks merged
// ---------------------------------------------------------------------------

constexpr int kTileRows = 128;               // rows of a CTA, a thread a slot
constexpr int kWin = 64;                     // floats of a staged window row
constexpr int kWinChunks = kWin / 4;         // its 16-byte chunks
constexpr int kMultCols = kWin + 4;          // multiplier columns a window
constexpr int kMaxSlots = 4;                 // 128-thread slots of lanes

struct LaneArgs {
  const float* values;                       // (N, C)
  const float* mult;                         // (S, C)
  const uint8_t* act;                        // (S, C), or (N, C) per event
  const uint8_t* live;                       // (N,) or null
  const float* reserves;                     // (S,)
  int32_t* winners;                          // (S, N), or
  float* prices;
  float* part_best;                          // (S, K, N) when not null
  float* part_sec;
  int32_t* part_win;
  long long N;
  int C, S, chunks, chunk_cols, slots, period, second_price;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 (4) bytes from global to shared memory, asynchronously; the first
// src_bytes are copied, the rest zero-filled (the address stays valid)
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// L lanes' multipliers of one column, from 16-, 8- or 4-byte aligned
// shared memory
template <int L>
__device__ __forceinline__ void load_lanes(const float* p, float (&m)[L]) {
  if constexpr (L >= 4) {
#pragma unroll
    for (int l = 0; l < L; l += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + l);
      m[l] = x.x;
      m[l + 1] = x.y;
      m[l + 2] = x.z;
      m[l + 3] = x.w;
    }
  } else if constexpr (L == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    m[0] = x.x;
    m[1] = x.y;
  } else {
    m[0] = p[0];
  }
}

template <int L, bool kPerEvent>
__global__ void __launch_bounds__(kTileRows * kMaxSlots)
matrix_lanes_kernel(LaneArgs a) {
  // each thread stages (kMultCols * L) / kTileRows multipliers a window
  constexpr int kMultPer = (kMultCols * L + kTileRows - 1) / kTileRows;
  extern __shared__ __align__(16) float lane_smem[];
  const int Q = a.slots;
  float* vals = lane_smem;                            // [2][rows][kWin]
  float* mults = vals + 2 * kTileRows * kWin;         // [2][Q][kMultCols][L]
  uint32_t* acts = reinterpret_cast<uint32_t*>(
      mults + 2 * Q * kMultCols * L);                 // [2][rows][kWinChunks]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int u = tid % kTileRows, q = tid / kTileRows;
  const int warp = u / 32, x = u % 32;
  const int P = a.period;
  // this thread's row: a warp's 32 rows share one shift class
  const int cls = warp % P;
  const int r = cls + P * (32 * (warp / P) + x);
  const long long n0 = (long long)blockIdx.x * kTileRows;
  const long long n = n0 + r;
  const int c_lo = blockIdx.y * a.chunk_cols;
  const int c_hi = min(a.C, c_lo + a.chunk_cols);
  const long long total = a.N * (long long)a.C;
  const int nw = (c_hi - c_lo + 3 + kWin - 1) / kWin;   // windows a pass
  const int per_pass = L * Q;
  const int steps = (a.S + per_pass - 1) / per_pass * nw;
  // the shift of the row's first column above its aligned float
  const int shift = (int)(((long long)cls * a.C + c_lo) & 3);
  const int key = (r / P) & 7;
  const bool mine =
      n < a.N && (a.live == nullptr || a.live[n] != 0);

  // valuations (and a per-event mask) of step t into buffer t & 1
  auto stage = [&](int t) {
    const int j = t % nw, buf = t & 1;
    float* vb = vals + buf * kTileRows * kWin;
    uint32_t* ab = acts + buf * kTileRows * kWinChunks;
    for (int idx = tid; idx < kTileRows * kWinChunks; idx += nthreads) {
      const int rr = idx / kWinChunks, i = idx % kWinChunks;
      const long long nn = n0 + rr;
      const long long flat =
          ((nn * a.C + c_lo) & ~3LL) + (long long)j * kWin + 4 * i;
      const bool in = nn < a.N && flat < total;
      const int slot = rr * kWinChunks + (i ^ ((rr / P) & 7));
      copy16(vb + 4 * slot, in ? a.values + flat : a.values,
             in ? (int)min(16LL, (total - flat) * 4) : 0);
      if constexpr (kPerEvent)
        copy4(ab + slot, in ? a.act + flat : a.act,
              in ? (int)min(4LL, total - flat) : 0);
    }
  };
  // the multipliers of step t: loaded into registers and tested when
  // stored, after the scan, so no thread waits on the loads before it
  float pm[kMultPer];
  uint32_t pa[kMultPer];
  auto fetch = [&](int t) {
    const int j = t % nw, lane0 = t / nw * per_pass;
#pragma unroll
    for (int e = 0; e < kMultPer; ++e) {
      const int idx = tid + e * nthreads;
      const int k = idx % kMultCols, rest = idx / kMultCols;
      const int s = lane0 + rest;            // rest = slot * L + lane
      const int col = c_lo - 3 + j * kWin + k;
      const bool ok = rest < per_pass && s < a.S && col >= c_lo && col < c_hi;
      const long long at = (long long)s * a.C + col;
      pm[e] = ok ? a.mult[at] : 0.0f;
      pa[e] = ok ? (kPerEvent ? 1u : (uint32_t)a.act[at]) : 0u;
    }
  };
  auto store = [&](int t) {
    float* mb = mults + (t & 1) * Q * kMultCols * L;
#pragma unroll
    for (int e = 0; e < kMultPer; ++e) {
      const int idx = tid + e * nthreads;
      const int k = idx % kMultCols, rest = idx / kMultCols;
      if (rest < per_pass)
        mb[(rest / L * kMultCols + k) * L + rest % L] =
            pa[e] != 0 ? pm[e] : __int_as_float(0x7fffffff);
    }
  };

  stage(0);
  cp_commit_group();
  fetch(0);
  store(0);

  float best[L], sec[L];
  int win[L];
  for (int t = 0; t < steps; ++t) {
    const int j = t % nw, buf = t & 1;
    const int lane0 = t / nw * per_pass + q * L;    // this slot's lanes
    if (t + 1 < steps) {
      stage(t + 1);
      fetch(t + 1);
    }
    cp_commit_group();
    cp_wait_group<1>();                      // step t has landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float res = lane0 + l < a.S ? a.reserves[lane0 + l] : 0.0f;
        best[l] = res;
        sec[l] = res;
        win[l] = -1;
      }
    }
    if (mine) {
      const float* vrow = vals + buf * kTileRows * kWin + r * kWin;
      const uint32_t* arow =
          acts + buf * kTileRows * kWinChunks + r * kWinChunks;
      const float* mrow =
          mults + (buf * Q * kMultCols + q * kMultCols + 3 - shift) * L;
      const int col0 = c_lo - shift + j * kWin;
#pragma unroll 2
      for (int i = 0; i < kWinChunks; ++i) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(vrow + 4 * (i ^ key));
        uint32_t a4 = 0xffffffffu;
        if constexpr (kPerEvent) a4 = arow[i ^ key];
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked-out event's bid is NaN: it never compares true
          const float v = ((a4 >> (8 * e)) & 0xffu)
                              ? vv[e] : __int_as_float(0x7fffffff);
          float m[L], bid[L];
          load_lanes<L>(mrow + (4 * i + e) * L, m);
          bool any = false;
#pragma unroll
          for (int l = 0; l < L; ++l) {
            bid[l] = v * m[l];
            any |= bid[l] > sec[l];
          }
          if (any) {
            const int col = col0 + 4 * i + e;
#pragma unroll
            for (int l = 0; l < L; ++l) {
              if (bid[l] > best[l]) {        // strict: first index wins ties
                sec[l] = best[l];
                best[l] = bid[l];
                win[l] = col;
              } else if (bid[l] > sec[l]) {
                sec[l] = bid[l];
              }
            }
          }
        }
      }
    }
    if (j == nw - 1 && n < a.N) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int s = lane0 + l;
        if (s >= a.S) continue;
        if (a.part_best == nullptr) {
          // second price: max(second-highest eligible bid, reserve), which
          // is `sec` because it started at the reserve
          a.winners[s * a.N + n] = win[l];
          a.prices[s * a.N + n] =
              win[l] >= 0 ? (a.second_price ? sec[l] : best[l]) : 0.0f;
        } else {
          const long long at = ((long long)s * a.chunks + blockIdx.y) * a.N + n;
          a.part_best[at] = best[l];
          a.part_sec[at] = sec[l];
          a.part_win[at] = win[l];
        }
      }
    }
    if (t + 1 < steps) store(t + 1);         // buffer t + 1 was left at the
    __syncthreads();                         // previous step's barrier
  }
}

// One thread a (lane, row): the chunks' (best, win, second) merged in
// ascending column order into winners and prices.
__global__ void merge_kernel(const float* __restrict__ part_best,
                             const float* __restrict__ part_sec,
                             const int32_t* __restrict__ part_win,
                             int32_t* __restrict__ winners,
                             float* __restrict__ prices, long long N, int S,
                             int K, int second_price) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)S * N) return;
  const long long s = idx / N, n = idx % N;
  long long at = s * K * N + n;
  float best = part_best[at], sec = part_sec[at];
  int win = part_win[at];
  for (int k = 1; k < K; ++k) {
    at += N;
    const float b = part_best[at], s2 = part_sec[at];
    if (b > best) {                   // strict: an earlier chunk wins ties
      sec = s2 > best ? s2 : best;
      best = b;
      win = part_win[at];
    } else if (b > sec) {
      sec = b;
    }
  }
  winners[idx] = win;
  prices[idx] = win >= 0 ? (second_price ? sec : best) : 0.0f;
}

template <int L, bool kPerEvent>
int launch_lanes(const LaneArgs& a, long long row_tiles, cudaStream_t stream) {
  auto kernel = matrix_lanes_kernel<L, kPerEvent>;
  const size_t bytes =
      (size_t)(2 * kTileRows * kWin + 2 * a.slots * kMultCols * L) *
          sizeof(float) +
      (kPerEvent ? (size_t)2 * kTileRows * kWinChunks * sizeof(uint32_t) : 0);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)row_tiles, (unsigned)a.chunks);
  kernel<<<grid, kTileRows * a.slots, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Resolve S lanes of N events of an (N, C) valuation matrix in one launch:
// multipliers (S, C), `act` (S, C) or, when `per_event` (S = 1), (N, C);
// `live` (N,) may be null; reserves (S,). The columns go to `chunks`
// campaign chunks of `chunk_cols`. With `part_best` null (one chunk)
// winners (S, N) and prices (S, N) are written, else the per-chunk (best,
// second, win) (S, chunks, N) for ar_merge_chunks. `values` must be 16-byte aligned (and a
// per-event `act` 4-byte aligned). Returns the cudaError_t of the launch.
int ar_resolve_lanes(const float* values, const float* mult,
                     const uint8_t* act, const uint8_t* live,
                     const float* reserves, int32_t* winners, float* prices,
                     float* part_best, float* part_sec, int32_t* part_win,
                     int N, int C, int S, int chunks, int chunk_cols,
                     int per_event, int second_price, cudaStream_t stream) {
  if (N < 1 || C < 1 || S < 1 || chunks < 1 || (per_event && S != 1) ||
      (long long)(chunks - 1) * chunk_cols >= C ||
      (chunks > 1 && part_best == nullptr))
    return (int)cudaErrorInvalidValue;
  const int lanes = S >= 8 ? 8 : S >= 4 ? 4 : S >= 2 ? 2 : 1;
  const int slots = min(kMaxSlots, (S + lanes - 1) / lanes);
  int g = C & 3 ? (C & 1 ? 1 : 2) : 4;       // gcd(C, 4)
  LaneArgs a{values, mult, act, live, reserves, winners, prices, part_best,
             part_sec, part_win, (long long)N, C, S, chunks, chunk_cols,
             slots, 4 / g, second_price};
  const long long tiles = ((long long)N + kTileRows - 1) / kTileRows;
  if (per_event) return launch_lanes<1, true>(a, tiles, stream);
  switch (lanes) {
    case 8: return launch_lanes<8, false>(a, tiles, stream);
    case 4: return launch_lanes<4, false>(a, tiles, stream);
    case 2: return launch_lanes<2, false>(a, tiles, stream);
    default: return launch_lanes<1, false>(a, tiles, stream);
  }
}

// Merge ar_resolve_lanes' `chunks` partial results of S lanes into winners
// (S, N) and prices (S, N). Returns the cudaError_t of the launch.
int ar_merge_chunks(const float* part_best, const float* part_sec,
                    const int32_t* part_win, int32_t* winners, float* prices,
                    int N, int S, int chunks, int second_price,
                    cudaStream_t stream) {
  const long long total = (long long)S * N;
  const int threads = 256;
  merge_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                 stream>>>(part_best, part_sec, part_win, winners, prices,
                           (long long)N, S, chunks, second_price);
  return (int)cudaGetLastError();
}

// Resolve N events whose valuations come from event embeddings (N, d) and
// campaign embeddings (C, d), both float32 or both bf16 (`bf16`).
int ar_resolve_emb(const void* event_emb, const void* campaign_emb, int bf16,
                   int d, float inv_scale, const float* mult,
                   const uint8_t* act, const uint8_t* live,
                   const float* reserve, int32_t* winners, float* prices,
                   int N, int C, int per_event, int second_price,
                   cudaStream_t stream) {
  if (bf16)
    return launch_emb((const __nv_bfloat16*)event_emb,
                      (const __nv_bfloat16*)campaign_emb, d, inv_scale, mult,
                      act, live, reserve, winners, prices, N, C, per_event,
                      second_price, stream);
  return launch_emb((const float*)event_emb, (const float*)campaign_emb, d,
                    inv_scale, mult, act, live, reserve, winners, prices, N,
                    C, per_event, second_price, stream);
}

// Shared memory (floats) left for the embedding kernel's embeddings, C*d +
// 128*d of them.
int ar_max_shared_floats(void) {
  return (int)((auction_tile::kMaxSmem - kStaticSmem) / sizeof(float));
}

}  // extern "C"
