// Hand-written Hopper (sm_90a) kernel: S scenario lanes resolved against one
// shared valuation matrix.
//
// Replaces the Pallas TPU kernel `sweep_resolve_pallas` of
// repro/kernels/auction_resolve/sweep_resolve.py (:81, body `_kernel` :37).
//
// What it computes. For every lane s and event n: bid = values[n, c] *
// mult[s, c]; eligible = active & bid > reserve[s], with the activation an
// (S, C) mask or an (S, N, C) per-event mask; the winner is the first index
// of the largest eligible bid (-1 if none); first price pays the top bid,
// second price max(second-largest eligible bid, reserve); no sale pays 0.
// Out: winners (S, N) int32, prices (S, N) float32 and each lane's spend
// sums (S, C).
//
// What bounds it on the H100. It reads the (N, C) valuations once (400 MB at
// N=1e6, C=100) and writes winners and prices (256 MB at S=32): ~0.2 ms at
// 3.35 TB/s. The work is a multiply and two compares per (lane, event,
// campaign), 9.6e9 at S=32, ~0.14 ms at the 67 TFLOP/s fp32 rate. So bytes
// bound it.
//
// What the design does about it. It is the scan of round_fused.cu's
// partials_kernel, written out here as there: one CTA per (kLanes lanes,
// canonical block g) stages a 64-row tile of valuations in shared memory
// once for its lanes and scans each (lane, row) in one thread with the top
// two bids in registers (`best` and `second` start at the reserve and a bid
// replaces `best` only if strictly greater, so the winner is the first index
// of the largest eligible bid and `second` ends as the second price; an
// inactive campaign gets a NaN multiplier, which never compares true). It
// writes each (lane, row)'s winner and price with coalesced stores. The
// spend sums are deterministic: each CTA adds its block's prices per
// campaign in event order (auction_tile.cuh's add_in_row_order, the two
// warps of a lane taking turns) into (S, G, C) partials, and `fold_kernel`
// folds them over g = 0 .. G-1 in order, as segments.fold_blocks does. The
// TPU kernel sums each tile as a tree, so the sums agree with it to float32
// tolerance, not bit for bit.
// The (S, N, C) mask is read from device memory per element, uncoalesced:
// it is off the main path.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "auction_tile.cuh"

namespace {

using namespace auction_tile;

constexpr size_t kStaticSmem =
    sizeof(float) * (kRows * (kCols + 1) + kLanes * kCols + kLanes * kRows);

template <bool kPerEvent>
__global__ void __launch_bounds__(kThreads)
sweep_resolve_kernel(const float* __restrict__ values,     // (N, C)
                     const float* __restrict__ mult,       // (S, C)
                     const uint8_t* __restrict__ act,      // (S,[N,] C)
                     const float* __restrict__ reserves,   // (S,)
                     int32_t* __restrict__ winners,        // (S, N)
                     float* __restrict__ prices,           // (S, N)
                     float* __restrict__ parts,            // (S, G, C)
                     int S, int N, int C, int block_size, int G,
                     int second_price) {
  __shared__ float tile[kRows][kCols + 1];    // +1: conflict-free row reads
  __shared__ float mult_s[kLanes][kCols];     // NaN = inactive campaign
  __shared__ float price_s[kLanes][kRows];
  extern __shared__ float acc[];              // (kLanes, C) running sums

  const int tid = threadIdx.x;
  const int l = tid / kRows;                  // this thread's lane ...
  const int r = tid % kRows;                  // ... and row in the tile
  const int s0 = blockIdx.x * kLanes;
  const int g = blockIdx.y;
  const int s = s0 + l;
  for (int i = tid; i < kLanes * C; i += kThreads) acc[i] = 0.0f;
  __syncthreads();
  const long long g0 = (long long)g * block_size;
  const long long g1 = min(g0 + block_size, (long long)N);
  const float reserve = s < S ? reserves[s] : 0.0f;
  const int col = tid % kCols;                // staging: a row segment per
  const int step = kThreads / kCols;          // kCols threads, coalesced

  for (long long base = g0; base < g1; base += kRows) {
    const int rows = (int)min((long long)kRows, g1 - base);
    const long long row = base + r;
    const bool mine = s < S && r < rows;
    const uint8_t* act_row =
        (kPerEvent && mine) ? act + ((size_t)s * N + row) * C : nullptr;
    float best = reserve, second = reserve;   // eligible means bid > reserve
    int win = -1;
    for (int c0 = 0; c0 < C; c0 += kCols) {
      const int cols = min(kCols, C - c0);
      if (col < cols) {
        for (int rr = tid / kCols; rr < rows; rr += step)
          tile[rr][col] = values[(size_t)(base + rr) * C + c0 + col];
        for (int ll = tid / kCols; ll < kLanes; ll += step) {
          const int st = s0 + ll;
          const size_t sc = (size_t)st * C + c0 + col;
          mult_s[ll][col] =
              (st < S && (kPerEvent || act[sc])) ? mult[sc] : nanf("");
        }
      }
      __syncthreads();
      if (mine) {
        const float* vrow = tile[r];
        const float* mrow = mult_s[l];
        for (int k = 0; k < cols; ++k) {
          if (kPerEvent && !act_row[c0 + k]) continue;
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
    const int winner = (win >= 0 && mine) ? win : -1;
    // second price: max(second-highest eligible bid, reserve), which is
    // `second` because it started at the reserve
    const float price = winner >= 0 ? (second_price ? second : best) : 0.0f;
    if (mine) {
      winners[(size_t)s * N + row] = winner;
      prices[(size_t)s * N + row] = price;
    }
    price_s[l][r] = price;
    __syncwarp();
    for (int half = 0; half < kRows / 32; ++half) {
      if (r / 32 == half)                     // whole warps
        add_in_row_order(acc + (size_t)l * C, winner, price_s[l] + half * 32,
                         r % 32);
      __syncthreads();
    }
  }

  if (s < S) {
    float* out = parts + ((size_t)s * G + g) * C;
    for (int c = r; c < C; c += kRows) out[c] = acc[l * C + c];
  }
}

// sums[s, c] = parts[s, 0, c] + parts[s, 1, c] + ... in order of g.
__global__ void fold_kernel(const float* __restrict__ parts,   // (S, G, C)
                            float* __restrict__ sums,          // (S, C)
                            int S, int C, int G) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)S * C) return;
  const long long s = i / C, c = i % C;
  const float* p = parts + (size_t)s * G * C + c;
  float sum = p[0];
  for (int g = 1; g < G; ++g) sum = sum + p[(size_t)g * C];
  sums[i] = sum;
}

template <bool kPerEvent>
int launch(const float* values, const float* mult, const uint8_t* act,
           const float* reserves, int32_t* winners, float* prices,
           float* parts, float* sums, int S, int N, int C, int block_size,
           int G, int second_price, cudaStream_t stream) {
  const size_t dyn = (size_t)kLanes * C * sizeof(float);
  if (kStaticSmem + dyn > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_resolve_kernel<kPerEvent>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((S + kLanes - 1) / kLanes, G);
  sweep_resolve_kernel<kPerEvent><<<grid, kThreads, dyn, stream>>>(
      values, mult, act, reserves, winners, prices, parts, S, N, C,
      block_size, G, second_price);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)S * C;
  fold_kernel<<<(unsigned)((cells + 255) / 256), 256, 0, stream>>>(
      parts, sums, S, C, G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Resolve S lanes; `per_event` says whether `act` is (S, N, C) or (S, C).
// `parts` is (S, G, C) scratch for the ordered block sums. Returns the
// cudaError_t of the launches.
int sr_sweep_resolve(const float* values, const float* mult,
                     const uint8_t* act, const float* reserves,
                     int32_t* winners, float* prices, float* parts,
                     float* sums, int S, int N, int C, int block_size, int G,
                     int second_price, int per_event, cudaStream_t stream) {
  return per_event
             ? launch<true>(values, mult, act, reserves, winners, prices,
                            parts, sums, S, N, C, block_size, G, second_price,
                            stream)
             : launch<false>(values, mult, act, reserves, winners, prices,
                             parts, sums, S, N, C, block_size, G,
                             second_price, stream);
}

// Largest C whose running sums fit the kernel's shared memory.
int sr_max_campaigns(void) {
  return (int)((kMaxSmem - kStaticSmem) / (kLanes * sizeof(float)));
}

}  // extern "C"
