// Hand-written Hopper (sm_90a) kernel: one design's auctions resolved under
// a per-campaign or per-event activation mask.
//
// Replaces the Pallas TPU kernel `auction_resolve_pallas` of
// repro/kernels/auction_resolve/auction_resolve.py (:80, body `_kernel` :28).
// In the port it carries every resolve of SORT2AGGREGATE: each segment
// replay of `segments.aggregate` (mask `segments.masks[seg_ids]`) and each
// Algorithm-4 batch of `vi.estimate_pi` (mask `u < pi`, padded rows dead).
//
// What it computes. For each event n: bid[c] = v[n, c] * mult[c];
// eligible = act & bid > reserve & live[n], with `act` a (C,) or (N, C)
// mask; the winner is the first index of the largest eligible bid (-1 if
// none); first price pays the top bid, second price max(second-largest
// eligible bid, reserve); no sale pays 0. Out: winners (N,) int32, prices
// (N,) float32 and, on request, the per-campaign spend sums (C,), added in
// event order from 0.0 (a flat segment sum, as XLA's is on the CPU).
// The valuations come from one of two tile sources, a template parameter:
//  * EmbTile computes them in registers from embeddings (Eq. 12):
//    min(exp((e . r) * (1 / (2 sqrt d))) / 10, 1), the dot a fixed-order
//    float32 loop over d with the campaign embeddings staged in shared
//    memory, IEEE expf (never __expf) and IEEE division; bf16 embeddings are
//    widened to float32 on load, as the TPU kernel does;
//  * MatrixTile reads them from an (N, C) valuation matrix.
// With --fmad=false every product and sum rounds as the plain PyTorch
// version's separate operations do, so winners and prices are its bits.
//
// What bounds it on the H100. MatrixTile at N=1e6, C=100 with an (N, C)
// mask reads 400 MB of valuations and 100 MB of mask and writes 8 MB:
// ~0.15 ms at 3.35 TB/s; bytes bound it. EmbTile reads 40 MB of embeddings
// and does ~2d+30 operations per (event, campaign), ~5e9 at d=10: ~0.08 ms
// at the 67 TFLOP/s float32 rate, so operations bound it.
//
// What the design does about it. One thread per event row, 128 rows a CTA.
// Each 64-column chunk of the row tile (MatrixTile's valuations, the
// per-event mask) is staged in shared memory with coalesced loads; the
// thread then scans its row with the top two bids in registers (`best` and
// `second` start at the reserve and a bid replaces `best` only if strictly
// greater: the first index of the largest eligible bid wins and `second`
// ends as the second price), as round_fused.cu's scan does. An inactive
// campaign of a (C,) mask gets a NaN multiplier, which never compares true.
// The sums are a second launch, one warp walking the rows 32 at a time and
// adding same-winner groups in row order (auction_tile.cuh's
// add_in_row_order): no float atomics, and the bits of a sequential sum.

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

// Valuations read from an (N, C) matrix, staged a (kRows, kCols) chunk at
// a time.
struct MatrixTile {
  const float* values;
  int C;

  static size_t smem_floats(int, int) { return kRows * (kCols + 1); }
  __device__ __forceinline__ void begin(float*, long long, int) const {}
  __device__ __forceinline__ void stage(float* smem, long long base,
                                        int rows, int c0, int cols) const {
    for (int i = threadIdx.x; i < rows * cols; i += kRows) {
      const int rr = i / cols, k = i % cols;
      smem[rr * (kCols + 1) + k] = values[(base + rr) * C + c0 + k];
    }
  }
  __device__ __forceinline__ float value(const float* smem, int r, int k,
                                         int) const {
    return smem[r * (kCols + 1) + k];
  }
};

// Valuations computed from embeddings (Eq. 12): the campaign embeddings
// (C, d) and the CTA's event rows (kRows, d), widened to float32, live in
// shared memory.
template <typename T>
struct EmbTile {
  const T* event_emb;
  const T* campaign_emb;
  int C, d;
  float inv_scale;                           // float32(1 / (2 sqrt d))

  static size_t smem_floats(int C, int d) {
    return (size_t)C * d + (size_t)kRows * d;
  }
  __device__ __forceinline__ void begin(float* smem, long long base,
                                        int rows) const {
    for (int i = threadIdx.x; i < C * d; i += kRows)
      smem[i] = widen(campaign_emb[i]);
    float* e = smem + (size_t)C * d;
    for (int i = threadIdx.x; i < rows * d; i += kRows)
      e[i] = widen(event_emb[base * d + i]);
  }
  __device__ __forceinline__ void stage(float*, long long, int, int,
                                        int) const {}
  __device__ __forceinline__ float value(const float* smem, int r, int,
                                         int c) const {
    const float* e = smem + (size_t)C * d + (size_t)r * d;
    const float* q = smem + (size_t)c * d;
    float dot = e[0] * q[0];
    for (int j = 1; j < d; ++j) dot = dot + e[j] * q[j];
    return fminf(expf(dot * inv_scale) / 10.0f, 1.0f);
  }
};

template <class Tile, bool kPerEvent>
__global__ void __launch_bounds__(kRows)
auction_resolve_kernel(Tile tile,
                       const float* __restrict__ mult,       // (C,)
                       const uint8_t* __restrict__ act,      // ([N,] C)
                       const uint8_t* __restrict__ live,     // (N,) or null
                       const float* __restrict__ reserve_p,  // ()
                       int32_t* __restrict__ winners,        // (N,)
                       float* __restrict__ prices,           // (N,)
                       int N, int C, int second_price) {
  __shared__ uint8_t act_s[kRows][kCols];
  __shared__ float mult_s[kCols];            // NaN = inactive campaign
  extern __shared__ float smem[];            // the tile source's

  const int r = threadIdx.x;
  const long long base = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, (long long)N - base);
  const long long row = base + r;
  const bool mine = r < rows && (live == nullptr || live[row] != 0);
  const float reserve = *reserve_p;
  float best = reserve, second = reserve;    // eligible means bid > reserve
  int win = -1;
  tile.begin(smem, base, rows);

  for (int c0 = 0; c0 < C; c0 += kCols) {
    const int cols = min(kCols, C - c0);
    __syncthreads();                         // the previous chunk is read
    tile.stage(smem, base, rows, c0, cols);
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
        const float bid = tile.value(smem, r, k, c0 + k) * mult_s[k];
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

// sums[c] = the prices of the events campaign c won, added in event order
// from 0.0. One warp; same-winner groups of 32 rows added in row order.
__global__ void __launch_bounds__(32)
ordered_sums_kernel(const int32_t* __restrict__ winners,
                    const float* __restrict__ prices,
                    float* __restrict__ sums, int N, int C) {
  __shared__ float warp_prices[32];
  extern __shared__ float acc[];             // (C,)
  const int lane = threadIdx.x;
  for (int c = lane; c < C; c += 32) acc[c] = 0.0f;
  __syncwarp();
  for (long long base = 0; base < N; base += 32) {
    const long long row = base + lane;
    int w = row < N ? winners[row] : -1;
    if (w >= C) w = -1;                      // never index past the sums
    warp_prices[lane] = row < N ? prices[row] : 0.0f;
    __syncwarp();
    auction_tile::add_in_row_order(acc, w, warp_prices, lane);
    __syncwarp();
  }
  for (int c = lane; c < C; c += 32) sums[c] = acc[c];
}

template <class Tile>
int launch(const Tile& tile, int d, const float* mult, const uint8_t* act,
           const uint8_t* live, const float* reserve, int32_t* winners,
           float* prices, float* sums, int N, int C, int per_event,
           int second_price, cudaStream_t stream) {
  const size_t dyn = Tile::smem_floats(C, d) * sizeof(float);
  auto kernel = per_event ? auction_resolve_kernel<Tile, true>
                          : auction_resolve_kernel<Tile, false>;
  if (kStaticSmem + dyn > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((N + kRows - 1) / kRows);
  kernel<<<blocks, kRows, dyn, stream>>>(tile, mult, act, live, reserve,
                                         winners, prices, N, C, second_price);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || sums == nullptr) return (int)err;
  const size_t acc = (size_t)C * sizeof(float);
  if (acc + 32 * sizeof(float) > 48 * 1024) {
    err = cudaFuncSetAttribute(ordered_sums_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)acc);
    if (err != cudaSuccess) return (int)err;
  }
  ordered_sums_kernel<<<1, 32, acc, stream>>>(winners, prices, sums, N, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Resolve N events of an (N, C) valuation matrix. `act` is (N, C) when
// `per_event`, else (C,); `live` (N,) may be null (every row live); `sums`
// may be null (no sums). Returns the cudaError_t of the launches.
int ar_resolve_matrix(const float* values, const float* mult,
                      const uint8_t* act, const uint8_t* live,
                      const float* reserve, int32_t* winners, float* prices,
                      float* sums, int N, int C, int per_event,
                      int second_price, cudaStream_t stream) {
  return launch(MatrixTile{values, C}, 0, mult, act, live, reserve, winners,
                prices, sums, N, C, per_event, second_price, stream);
}

// Resolve N events whose valuations come from event embeddings (N, d) and
// campaign embeddings (C, d), both float32 or both bf16 (`bf16`).
int ar_resolve_emb(const void* event_emb, const void* campaign_emb, int bf16,
                   int d, float inv_scale, const float* mult,
                   const uint8_t* act, const uint8_t* live,
                   const float* reserve, int32_t* winners, float* prices,
                   float* sums, int N, int C, int per_event, int second_price,
                   cudaStream_t stream) {
  if (bf16)
    return launch(
        EmbTile<__nv_bfloat16>{(const __nv_bfloat16*)event_emb,
                               (const __nv_bfloat16*)campaign_emb, C, d,
                               inv_scale},
        d, mult, act, live, reserve, winners, prices, sums, N, C, per_event,
        second_price, stream);
  return launch(EmbTile<float>{(const float*)event_emb,
                               (const float*)campaign_emb, C, d, inv_scale},
                d, mult, act, live, reserve, winners, prices, sums, N, C,
                per_event, second_price, stream);
}

// Shared memory (floats) left for EmbTile's embeddings, C*d + 128*d of
// them, and for the sums' C running totals.
int ar_max_shared_floats(void) {
  return (int)((auction_tile::kMaxSmem - kStaticSmem) / sizeof(float));
}

}  // extern "C"
