// Hand-written Hopper (sm_90a) kernel: Algorithm 4 (the VI estimate of the
// cap-out times, `core/vi.py`) for S scenario lanes in one persistent
// launch.
//
// Replaces, on the port's Algorithm-4 path, one launch per 64-row batch of
// the counterpart of the Pallas TPU kernel `auction_resolve_pallas`
// (repro/kernels/auction_resolve/auction_resolve.py:80, ported as
// csrc/auction_resolve.cu) and the host loop around it (repro's
// `estimate_pi` scan body, repro/core/vi.py): 3,140 batches a simulate,
// each a resolve, an ordered-sums launch and a few (C,) torch ops.
//
// What it computes, bit for bit `vi._run` on the CPU. For every lane s and
// step t = 0 .. total-1, with b = t mod n_batches and rows [b*B, b*B + B)
// of the sampled valuations (rows at or past `sample_size` are dead):
// active[r, c] = u[t, r, 0 or c] < pi[c] (W = 1: "shared" coupling, W = C:
// "independent"); each live row resolved as `resolve_masked` does (bid =
// v * mult, eligible = active and bid > reserve, the first index of the
// largest eligible bid wins, second price max(second bid, reserve));
// sums[c] = the prices campaign c won, added in row order from +0.0;
// delta = btilde - sums / denom[b] (an IEEE division, then a subtraction);
// pi = clamp(fma(step[t], delta, pi), 0, 1) with one rounding (`floats.fma`)
// and torch.clamp's semantics (NaN passes). With `history`, pi after step
// t is kept when t is a multiple of `track_every`.
//
// What bounds it on the H100. The bytes are small: the sampled rows (B*C
// floats a batch, read from L2 every epoch) and the uniforms (B*W a
// step), 4 MB and 0.8 MB at simulate's shape. The chain is what bounds it:
// step t+1's activations depend on step t's pi, so a lane is `total`
// dependent steps, each at least a resolve of B*C compares spread over one
// SM, an ordered add of B prices and a (C,) update, with barriers between.
//
// What the design does about it. One CTA (512 threads) carries a lane
// through every step, and all lanes run at once, one CTA each. pi, btilde
// and the multipliers live in shared memory; the next step's valuation rows
// and uniforms do not depend on pi, so they are copied by cp.async into the
// other half of a double buffer while this step runs. Threads per row: the
// most (a power of two up to 32) that B rows fill; each scans every tpr-th
// column of its row with the top two bids in registers, then the row's
// slices merge by shuffles (the larger bid wins, the lower column on a
// tie, so the first index of the maximum wins). After one barrier a thread
// a campaign adds the prices of the rows it won in row order (no float
// atomics) and updates its pi: two barriers a step. Where the staged state
// does not fit in shared memory (B*(C + W) and C large), the same code runs
// with the state in device memory (a scratch buffer and the output pi) and
// reads the batch from device memory, unstaged.
//
// With a scenario overlay (repro's `estimate_pi(overlay_row=)`, vmapped by
// `estimate_pi_sweep(overlay=)`) two inputs change, and nothing else:
// `sampled` may hold one lane's perturbed rows after another (a lane
// stride of n_batches*B*C floats; 0 = one set of rows shared by every
// lane), and an optional per-lane eligibility (S, n_batches, EB) bytes (EB
// = B*C rounded up to 16; padded rows 0) is ANDed into u < pi. The mask is
// staged with its batch (16-byte copies), and counts in the staged size.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "auction_tile.cuh"

namespace {

constexpr int kThreads = 512;

struct Args {
  const float* sampled;    // (n_batches * B, C) a lane, rows past
                           // sample_size zero; lanes sampled_stride apart
  const float* u;          // (total, B, W)
  const float* step;       // (total,)
  const float* denom;      // (n_batches,)
  const float* btilde;     // (S, C)
  const float* mult;       // (S, C)
  const float* reserves;   // (S,)
  float* pi;               // (S, C): the initial pi in, the estimate out
  float* history;          // (S, n_tracked, C) or null
  float* scratch;          // (S, 2B) when the state is in device memory
  const uint8_t* elig;     // (S, n_batches, EB) eligibility, or null
  int S, C, B, W, n_batches, total, sample_size, track_every;
  long long sampled_stride;  // floats between lanes' rows; 0 = shared
};

__host__ __device__ inline long long round4(long long n) {
  return (n + 3) & ~3LL;
}

// Bytes of one batch's eligibility: B*C rounded up to 16, so every
// batch's mask starts on 16 bytes.
__host__ __device__ inline long long elig_bytes(int B, int C) {
  return ((long long)B * C + 15) & ~15LL;
}

// Shared memory of the staged state, in floats: two batch buffers (B*C
// valuations, B*W uniforms and, with an overlay, the batch's eligibility
// bytes each), pi, btilde and the multipliers (C each), the rows' winners
// and prices (B each); every region starts on 16 bytes.
__host__ __device__ inline long long batch_floats(int B, int C, int W,
                                                  bool elig) {
  return round4((long long)B * C) + round4((long long)B * W) +
         (elig ? elig_bytes(B, C) / 4 : 0);
}
inline long long staged_bytes(int B, int C, int W, bool elig) {
  return 4 * (2 * batch_floats(B, C, W, elig) + 3 * round4(C) +
              2 * round4(B));
}

// Threads per batch row: the most, a power of two up to 32, that B rows
// fill (a warp holds whole rows).
__host__ __device__ inline int threads_per_row(int B) {
  int tpr = 32;
  while (tpr > 1 && (long long)tpr * B > kThreads) tpr >>= 1;
  return tpr;
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

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// n floats from device memory into shared memory by cp.async: 16-byte
// copies when both ends are on 16 bytes, else 4-byte ones.
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           long long n) {
  const bool vec = ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  long long i0 = 0;
  if (vec) {
    const long long quads = n >> 2;
    for (long long q = threadIdx.x; q < quads; q += kThreads)
      cp_async16(dst + 4 * q, src + 4 * q);
    i0 = 4 * quads;
  }
  for (long long i = i0 + threadIdx.x; i < n; i += kThreads)
    cp_async4(dst + i, src + i);
}

// n bytes (a multiple of 16, both ends on 16 bytes) by 16-byte cp.async.
__device__ __forceinline__ void copy_async_bytes(uint8_t* dst,
                                                 const uint8_t* src,
                                                 long long n) {
  for (long long q = threadIdx.x; q < (n >> 4); q += kThreads)
    cp_async16(dst + 16 * q, src + 16 * q);
}

// Stage step t's batch (its valuation rows, its uniforms and, with an
// overlay, its eligibility bytes) into buffer t & 1 by cp.async. Scalars
// by value: a reference to the kernel's parameters would copy them to the
// stack.
template <bool kElig>
__device__ __forceinline__ void prefetch_batch(
    float* smem, int t, long long nbuf, long long rv, long long ru,
    long long eb, const float* lane_sampled, const uint8_t* lane_elig,
    const float* u, int n_batches, int B, int C, int W) {
  float* dst = smem + (t & 1) * nbuf;
  const int b = t % n_batches;
  copy_async(dst, lane_sampled + (size_t)b * B * C, (long long)B * C);
  copy_async(dst + rv, u + (size_t)t * B * W, (long long)B * W);
  if (kElig)
    copy_async_bytes(reinterpret_cast<uint8_t*>(dst + ru),
                     lane_elig + (size_t)b * eb, eb);
  cp_commit();
}

// kElig: the run has an overlay's eligibility (a separate instantiation, so
// the runs without one compile to the scan they had before)
template <bool kSecond, bool kStaged, bool kElig>
__global__ void __launch_bounds__(kThreads) vi_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int C = a.C, B = a.B, W = a.W;
  const float reserve = a.reserves[s];
  float* pi_out = a.pi + (size_t)s * C;
  constexpr bool has_elig = kElig;
  const long long nbuf = batch_floats(B, C, W, has_elig);
  const long long rv = round4((long long)B * C);
  const long long ru = rv + round4((long long)B * W);   // the mask's start
  const long long eb = elig_bytes(B, C);
  const float* lane_sampled = a.sampled + (size_t)s * a.sampled_stride;
  const uint8_t* lane_elig =
      has_elig ? a.elig + (size_t)s * a.n_batches * eb : nullptr;
  const long long n_tracked =
      a.track_every > 0 ? (a.total + a.track_every - 1) / a.track_every : 0;

  float *pi, *prices;
  int* winners;
  const float *btilde, *mult;
  if (kStaged) {
    float* p = smem + 2 * nbuf;
    const long long rc = round4(C);
    pi = p;
    float* bt = p + rc;
    float* m = p + 2 * rc;
    winners = reinterpret_cast<int*>(p + 3 * rc);
    prices = p + 3 * rc + round4(B);
    for (int c = tid; c < C; c += kThreads) {
      pi[c] = pi_out[c];
      bt[c] = a.btilde[(size_t)s * C + c];
      m[c] = a.mult[(size_t)s * C + c];
    }
    // the rows past B of the last quad are nobody's
    for (int r = B + tid; r < round4(B); r += kThreads) winners[r] = -1;
    btilde = bt;
    mult = m;
  } else {
    float* scr = a.scratch + (size_t)s * 2 * B;
    pi = pi_out;
    winners = reinterpret_cast<int*>(scr);
    prices = scr + B;
    btilde = a.btilde + (size_t)s * C;
    mult = a.mult + (size_t)s * C;
  }

  const int tpr = threads_per_row(B);
  const int rows_per_pass = kThreads / tpr;
  const int k = tid & (tpr - 1);             // this thread's column slice
  if (kStaged)
    prefetch_batch<kElig>(smem, 0, nbuf, rv, ru, eb, lane_sampled,
                          lane_elig, a.u, a.n_batches, B, C, W);

  // each step's size and batch count, loaded a step ahead
  float st = a.step[0], dn = a.denom[0];
  for (int t = 0; t < a.total; ++t) {
    const int b = t % a.n_batches;
    const bool more = t + 1 < a.total;
    const float st_next = more ? a.step[t + 1] : 0.0f;
    const float dn_next = more ? a.denom[(t + 1) % a.n_batches] : 0.0f;
    const float *v, *u;
    const uint8_t* el = nullptr;
    if (kStaged) {
      cp_wait_all();
      __syncthreads();       // batch t is in; step t-1's update is done
      if (t + 1 < a.total)
        prefetch_batch<kElig>(smem, t + 1, nbuf, rv, ru, eb, lane_sampled,
                              lane_elig, a.u, a.n_batches, B, C, W);
      v = smem + (t & 1) * nbuf;
      u = v + rv;
      if (has_elig) el = reinterpret_cast<const uint8_t*>(v + ru);
    } else {
      __syncthreads();
      v = lane_sampled + (size_t)b * B * C;
      u = a.u + (size_t)t * B * W;
      if (has_elig) el = lane_elig + (size_t)b * eb;
    }

    // resolve: the warp-uniform loop keeps every lane of a warp in the
    // shuffles
    for (int r0 = 0; r0 < B; r0 += rows_per_pass) {
      const int r = r0 + tid / tpr;
      const bool row_ok = r < B;
      float best = reserve, second = reserve;  // eligible: bid > reserve
      int win = -1;
      if (row_ok && (long long)b * B + r < a.sample_size) {
        const float* vr = v + (size_t)r * C;
        const float* ur = u + (size_t)r * W;
        const uint8_t* er = kElig ? el + (size_t)r * C : nullptr;
        const float u0 = ur[0];
#pragma unroll 4
        for (int c = k; c < C; c += tpr) {
          const float uu = W == 1 ? u0 : ur[c];
          const bool on = kElig ? uu < pi[c] && er[c] != 0 : uu < pi[c];
          // an inactive campaign's NaN bid never compares true
          const float bid = on ? vr[c] * mult[c] : nanf("");
          const bool gt = bid > best;          // strict: first index wins
          if (kSecond) second = gt ? best : fmaxf(second, bid);
          best = gt ? bid : best;
          win = gt ? c : win;
        }
      }
      // merge the row's slices: the larger best wins, the lower column on
      // a tie; the second price is the larger of the loser's best and the
      // winner's second
      for (int o = 1; o < tpr; o <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int ow = __shfl_xor_sync(0xffffffffu, win, o);
        const float os = kSecond ? __shfl_xor_sync(0xffffffffu, second, o)
                                 : 0.0f;
        const bool take = ob > best || (ob == best && ow >= 0 && ow < win);
        if (kSecond) second = take ? fmaxf(best, os) : fmaxf(second, ob);
        best = take ? ob : best;
        win = take ? ow : win;
      }
      if (row_ok && k == 0) {
        winners[r] = win;
        // second price: max(second-highest eligible bid, reserve), which
        // is `second` because it started at the reserve
        prices[r] = win >= 0 ? (kSecond ? second : best) : 0.0f;
      }
    }
    __syncthreads();

    // the update of pi, a thread a campaign: its sum is the prices of the
    // rows it won added in row order from +0.0 (a row it did not win adds
    // +0.0, which leaves a sum that is never -0.0 unchanged), then one
    // rounding in the multiply-add, then the clamp
    const bool keep = a.history != nullptr && t % a.track_every == 0;
    for (int c = tid; c < C; c += kThreads) {
      float acc = 0.0f;
      if (kStaged) {          // 16-byte broadcast loads, four rows each
        const int4* w4 = reinterpret_cast<const int4*>(winners);
        const float4* p4 = reinterpret_cast<const float4*>(prices);
#pragma unroll 4
        for (int q = 0; q < (B + 3) / 4; ++q) {
          const int4 w = w4[q];
          const float4 p = p4[q];
          acc = acc + (w.x == c ? p.x : 0.0f);
          acc = acc + (w.y == c ? p.y : 0.0f);
          acc = acc + (w.z == c ? p.z : 0.0f);
          acc = acc + (w.w == c ? p.w : 0.0f);
        }
      } else {
#pragma unroll 4
        for (int r = 0; r < B; ++r)
          acc = acc + (winners[r] == c ? prices[r] : 0.0f);
      }
      const float delta = __fsub_rn(btilde[c], __fdiv_rn(acc, dn));
      const float x = __fmaf_rn(st, delta, pi[c]);
      const float p = x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
      pi[c] = p;
      if (keep)
        a.history[((size_t)s * n_tracked + t / a.track_every) * C + c] = p;
    }
    st = st_next;
    dn = dn_next;
  }
  if (kStaged) {
    __syncthreads();
    for (int c = tid; c < C; c += kThreads) pi_out[c] = pi[c];
  }
}

template <bool kSecond, bool kStaged, bool kElig>
int launch_as(const Args& a, size_t dyn, cudaStream_t stream) {
  auto kernel = vi_kernel<kSecond, kStaged, kElig>;
  if (dyn > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<a.S, kThreads, dyn, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kStaged>
int launch_rule(const Args& a, bool second, bool elig, size_t dyn,
                cudaStream_t stream) {
  if (second)
    return elig ? launch_as<true, kStaged, true>(a, dyn, stream)
                : launch_as<true, kStaged, false>(a, dyn, stream);
  return elig ? launch_as<false, kStaged, true>(a, dyn, stream)
              : launch_as<false, kStaged, false>(a, dyn, stream);
}

bool fits(int B, int C, int W, bool elig) {
  return staged_bytes(B, C, W, elig) <= (long long)auction_tile::kMaxSmem;
}

}  // namespace

extern "C" {

// 1 when the staged state of a (B, C, W) run (with a per-lane eligibility
// when `elig` is 1) fits in shared memory, 0 when the run keeps it in
// device memory (and needs `scratch`).
int vi_staged(int B, int C, int W, int elig) {
  return fits(B, C, W, elig != 0) ? 1 : 0;
}

// Run Algorithm 4 for S lanes, one CTA each. `pi` (S, C) holds the initial
// pi and receives the estimate; `history` (S, ceil(total / track_every),
// C) may be null; `scratch` (S, 2B) is required when vi_staged() is 0;
// `elig` (S, n_batches, EB) bytes may be null; `sampled_stride` is 0 (one
// set of rows) or n_batches*B*C (a set a lane). Returns the cudaError_t of
// the launch.
int vi_run(const float* sampled, const float* u, const float* step,
           const float* denom, const float* btilde, const float* mult,
           const float* reserves, float* pi, float* history, float* scratch,
           const unsigned char* elig, int S, int C, int B, int W,
           int n_batches, int total, int sample_size, int track_every,
           int second_price, long long sampled_stride, cudaStream_t stream) {
  if (S <= 0 || total <= 0) return 0;
  if (B <= 0 || C <= 0 || (W != 1 && W != C) || n_batches <= 0 ||
      (history != nullptr && track_every <= 0) ||
      (sampled_stride != 0 &&
       sampled_stride != (long long)n_batches * B * C))
    return (int)cudaErrorInvalidValue;
  const Args a{sampled, u, step, denom, btilde, mult, reserves, pi,
               history, scratch, elig, S, C, B, W, n_batches, total,
               sample_size, track_every, sampled_stride};
  const bool has_elig = elig != nullptr;
  if (fits(B, C, W, has_elig)) {
    const size_t dyn = (size_t)staged_bytes(B, C, W, has_elig);
    return launch_rule<true>(a, second_price != 0, has_elig, dyn, stream);
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  return launch_rule<false>(a, second_price != 0, has_elig, 0, stream);
}

}  // extern "C"
