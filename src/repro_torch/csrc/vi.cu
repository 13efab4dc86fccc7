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
// SM, an ordered add of the won prices and a (C,) update, with barriers
// between. Within a step the scan of the B*C bids binds (on the H100 it
// runs at about half an instruction a cycle a scheduler), then the
// merge's shuffles, the update's latency and the barriers.
//
// What the design does about it. One CTA carries a lane through every
// step, and all lanes run at once, one CTA each: 8 warps resolve rows and
// update campaigns, one more stages the batches. pi, btilde and the
// multipliers live in shared memory.
// * The copy is off the chain: a batch's valuation rows, its uniforms, its
//   eligibility bytes, the step's size and the batch's live count are each
//   one contiguous span, so the staging warp's lane 0 stages a step with
//   bulk TMA copies (`cp.async.bulk`, each span widened to 16 bytes at
//   both ends) into a ring of up to four stages, each completing on its
//   own mbarrier, `stages` steps ahead: at the start of step t it refills
//   the slot step t-1 read. The others only wait on the stage's mbarrier
//   phase. The batch, the slot and the phase are counted from step to
//   step (no division on the chain).
// * The scan: threads per row the most (a power of two up to 32) that B
//   rows fill; a warp holds 32 / tpr whole rows, lane = slice * rows + row,
//   so one 16-byte load of a quad feeds eight rows without bank conflicts
//   when C / 4 is odd. A thread scans every tpr-th quad of its row (every
//   tpr-th column when C is not a multiple of 4 or an input is not on 16
//   bytes) keeping the top two bids with fmaxf/fminf (a NaN bid, an
//   inactive campaign, leaves both as they were) and the quad where the
//   best bid last rose; the winning column is found in that quad after the
//   scan. The row's slices merge by shuffles (the larger bid wins, the
//   lower column on a tie).
// * The update adds only what was won: a row's winner sets its bit in the
//   campaign's row mask (an integer shared-memory atomic), and a thread a
//   campaign adds the prices of its set bits in row order from +0.0 (a
//   row it did not win would add +0.0, which leaves a sum that is never
//   -0.0 unchanged), divides only when it won something (0.0 / denom =
//   +0.0 and btilde - (+0.0) = btilde), then one rounding in the
//   multiply-add, then the clamp. Two
//   barriers a step remain: one before the update (every row's winner) and
//   one after it (every campaign's pi); the update is 0-2 adds long
//   instead of B.
// Where the staged state does not fit in shared memory (large B*C), the
// same scan runs with the state in device memory (a scratch buffer of the
// rows' winners and prices, and the output pi), reads the batch from
// device memory unstaged, and updates by the dense row-order add.
//
// With a scenario overlay (repro's `estimate_pi(overlay_row=)`, vmapped by
// `estimate_pi_sweep(overlay=)`) two inputs change, and nothing else:
// `sampled` may hold one lane's perturbed rows after another (a lane
// stride of n_batches*B*C floats; 0 = one set of rows shared by every
// lane), and an optional per-lane eligibility (S, n_batches, EB) bytes (EB
// = B*C rounded up to 16; padded rows 0) is ANDed into u < pi. The mask is
// staged with its batch, and counts in the staged size.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "auction_tile.cuh"

namespace {

constexpr int kWarps = 8;                    // warps that resolve and update
constexpr int kWorkers = kWarps * 32;
constexpr int kThreads = kWorkers + 32;      // and one warp that stages
constexpr int kIssuer = kWorkers;            // the staging warp's lane 0
constexpr int kMaxStages = 4;
constexpr int kMinStages = 2;

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
  int stages;                // the ring's stages (staged state only)
  int quad;                  // 1: C % 4 == 0 and the inputs on 16 bytes
};

__host__ __device__ inline long long round4(long long n) {
  return (n + 3) & ~3LL;
}

__host__ __device__ inline long long round16(long long n) {
  return (n + 15) & ~15LL;
}

// Bytes of one batch's eligibility: B*C rounded up to 16, so every
// batch's mask starts on 16 bytes.
__host__ __device__ inline long long elig_bytes(int B, int C) {
  return round16((long long)B * C);
}

// A stage of the ring, in bytes: the step's size and the batch's live
// count (the 16 bytes around each), the batch's rows, its uniforms and its
// eligibility bytes, each with 32 bytes of room for the 16-byte-aligned
// span a bulk copy takes.
constexpr int kScalars = 32;
__host__ __device__ inline long long rows_region(int B, int C) {
  return round16(4LL * B * C + 32);
}
__host__ __device__ inline long long u_region(int B, int W) {
  return round16(4LL * B * W + 32);
}
__host__ __device__ inline long long elig_region(int B, int C) {
  return elig_bytes(B, C) + 32;
}
__host__ __device__ inline long long stage_bytes(int B, int C, int W,
                                                 bool elig) {
  return kScalars + rows_region(B, C) + u_region(B, W) +
         (elig ? elig_region(B, C) : 0);
}

// 32-bit words of a campaign's row mask.
__host__ __device__ inline int mask_words(int B) { return (B + 31) / 32; }

// Threads per batch row: the most, a power of two up to 32, that B rows
// fill (a warp holds whole rows).
__host__ __device__ inline int threads_per_row(int B) {
  int tpr = 32;
  while (tpr > 1 && (long long)tpr * B > kWorkers) tpr >>= 1;
  return tpr;
}

// Shared memory of the staged state: the ring, pi, btilde and the
// multipliers (C each), the rows' prices (B), each campaign's row mask and
// the ring's mbarriers; every region starts on 16 bytes.
inline long long staged_bytes(int B, int C, int W, bool elig, int stages) {
  return stages * stage_bytes(B, C, W, elig) +
         4 * (3 * round4(C) + round4(B) +
              round4((long long)C * mask_words(B))) +
         8 * kMaxStages;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

// A bulk TMA copy of `bytes` (a multiple of 16) from 16-byte-aligned
// `src` to 16-byte-aligned shared `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The 16-byte-aligned span around [p, p + bytes): its start and length.
// It never leaves the pages that hold the span, since pages are aligned.
__device__ __forceinline__ uint32_t span(const void* p, long long bytes,
                                         const char*& lo) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  lo = reinterpret_cast<const char*>(a & ~uintptr_t(15));
  return (uint32_t)(((a + bytes + 15) & ~uintptr_t(15)) - (a & ~uintptr_t(15)));
}

__device__ __forceinline__ uint32_t lead(const void* p) {
  return (uint32_t)(reinterpret_cast<uintptr_t>(p) & 15);
}

// Where step t's inputs lie in device memory.
struct StepSrc {
  const float* v;
  const float* u;
  const uint8_t* e;
  const float* step;
  const float* denom;
};

// (step t, its batch b = t mod n_batches, counted by the caller: a
// division on the chain costs a few hundred cycles)
template <bool kElig>
__device__ __forceinline__ StepSrc step_src(const Args& a,
                                            const float* lane_sampled,
                                            const uint8_t* lane_elig, int t,
                                            int b, long long eb) {
  return {lane_sampled + (size_t)b * a.B * a.C,
          a.u + (size_t)t * a.B * a.W,
          kElig ? lane_elig + (size_t)b * eb : nullptr, a.step + t,
          a.denom + b};
}

// i + 1 modulo n, for 0 <= i < n
__device__ __forceinline__ int next_mod(int i, int n) {
  return i + 1 == n ? 0 : i + 1;
}

// Stage step t into its slot: one thread, bulk copies completing on the
// slot's mbarrier.
template <bool kElig>
__device__ __forceinline__ void issue_step(unsigned char* slot,
                                           uint64_t* bar, StepSrc src,
                                           int B, int C, int W,
                                           long long eb) {
  const char *lo_v, *lo_u, *lo_e = nullptr, *lo_st, *lo_dn;
  const uint32_t nv = span(src.v, 4LL * B * C, lo_v);
  const uint32_t nu = span(src.u, 4LL * B * W, lo_u);
  const uint32_t ne = kElig ? span(src.e, eb, lo_e) : 0u;
  span(src.step, 4, lo_st);
  span(src.denom, 4, lo_dn);
  unsigned char* rows = slot + kScalars;
  // every thread read the slot before the barrier the caller passed
  mbar_expect(bar, kScalars + nv + nu + ne);
  bulk_copy(slot, lo_st, 16, bar);
  bulk_copy(slot + 16, lo_dn, 16, bar);
  bulk_copy(rows, lo_v, nv, bar);
  bulk_copy(rows + rows_region(B, C), lo_u, nu, bar);
  if (kElig)
    bulk_copy(rows + rows_region(B, C) + u_region(B, W), lo_e, ne, bar);
}

// G columns (a quad, or one) of a row: the bids, NaN where the campaign
// is inactive (which never compares true and which fmaxf ignores).
template <int G, bool kElig>
__device__ __forceinline__ void group_bids(const float* vr, const float* ur,
                                           bool shared_u, float u0,
                                           const float* pi, const float* m,
                                           const uint8_t* er, int c,
                                           float (&bid)[G]) {
  float v[G], p[G], mm[G], uu[G];
  uint32_t e4 = 0xffffffffu;
  if (G == 4) {
    const float4 v4 = *reinterpret_cast<const float4*>(vr + c);
    const float4 p4 = *reinterpret_cast<const float4*>(pi + c);
    const float4 m4 = *reinterpret_cast<const float4*>(m + c);
    v[0] = v4.x, v[1] = v4.y, v[2] = v4.z, v[3] = v4.w;
    p[0] = p4.x, p[1] = p4.y, p[2] = p4.z, p[3] = p4.w;
    mm[0] = m4.x, mm[1] = m4.y, mm[2] = m4.z, mm[3] = m4.w;
    if (!shared_u) {
      const float4 u4 = *reinterpret_cast<const float4*>(ur + c);
      uu[0] = u4.x, uu[1] = u4.y, uu[2] = u4.z, uu[3] = u4.w;
    }
    if (kElig) e4 = *reinterpret_cast<const uint32_t*>(er + c);
  } else {
    v[0] = vr[c];
    p[0] = pi[c];
    mm[0] = m[c];
    if (!shared_u) uu[0] = ur[c];
    if (kElig) e4 = er[c];
  }
#pragma unroll
  for (int e = 0; e < G; ++e) {
    const float x = shared_u ? u0 : uu[e];
    const bool on =
        kElig ? x < p[e] && ((e4 >> (8 * e)) & 0xffu) != 0 : x < p[e];
    bid[e] = on ? v[e] * mm[e] : nanf("");
  }
}

// One row's scan of its slice (groups first, first + step, ... below n):
// best and second start at the reserve; per bid, best = fmaxf(best, bid)
// and second = fminf(fmaxf(second, bid), best before it) (the top two of
// the eligible bids and the reserve; a NaN changes neither), and `wg` is
// the group where best last rose strictly. The winning column is the
// first in that group whose bid equals best. Returns it, or -1.
template <int G, bool kSecond, bool kElig>
__device__ __forceinline__ int scan_row(const float* vr, const float* ur,
                                        bool shared_u, const float* pi,
                                        const float* m, const uint8_t* er,
                                        int first, int step, int n,
                                        float& best, float& second) {
  const float u0 = shared_u ? ur[0] : 0.0f;
  int wg = -1;
#pragma unroll 2
  for (int g = first; g < n; g += step) {
    float bid[G];
    group_bids<G, kElig>(vr, ur, shared_u, u0, pi, m, er, G * g, bid);
    const float before = best;
    if (kSecond) {
#pragma unroll
      for (int e = 0; e < G; ++e) {
        second = fminf(fmaxf(second, bid[e]), best);
        best = fmaxf(best, bid[e]);
      }
    } else if (G == 4) {
      best = fmaxf(best, fmaxf(fmaxf(bid[0], bid[1]), fmaxf(bid[2], bid[3])));
    } else {
      best = fmaxf(best, bid[0]);
    }
    wg = best > before ? g : wg;
  }
  if (wg < 0 || G == 1) return wg;
  float bid[G];
  group_bids<G, kElig>(vr, ur, shared_u, u0, pi, m, er, G * wg, bid);
  int e = 0;
#pragma unroll
  for (int i = G - 1; i >= 0; --i) e = bid[i] == best ? i : e;
  return G * wg + e;
}

// kElig: the run has an overlay's eligibility (a separate instantiation,
// so the runs without one compile to the scan they had before)
template <bool kSecond, bool kStaged, bool kElig>
__global__ void __launch_bounds__(kThreads) vi_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = a.C, B = a.B, W = a.W;
  const bool shared_u = W == 1;
  const float reserve = a.reserves[s];
  float* pi_out = a.pi + (size_t)s * C;
  const long long eb = elig_bytes(B, C);
  const float* lane_sampled = a.sampled + (size_t)s * a.sampled_stride;
  const uint8_t* lane_elig =
      kElig ? a.elig + (size_t)s * a.n_batches * eb : nullptr;
  const long long n_tracked =
      a.track_every > 0 ? (a.total + a.track_every - 1) / a.track_every : 0;
  const int words = mask_words(B);
  const int stages = a.stages;
  const long long sb = stage_bytes(B, C, W, kElig);

  float *pi, *prices;
  int* winners = nullptr;
  uint32_t* masks = nullptr;
  uint64_t* full = nullptr;
  const float *btilde, *mult;
  if (kStaged) {
    float* p = reinterpret_cast<float*>(smem + stages * sb);
    const long long rc = round4(C);
    pi = p;
    float* bt = p + rc;
    float* m = p + 2 * rc;
    prices = p + 3 * rc;
    masks = reinterpret_cast<uint32_t*>(p + 3 * rc + round4(B));
    full = reinterpret_cast<uint64_t*>(
        p + 3 * rc + round4(B) + round4((long long)C * words));
    for (int c = tid; c < C; c += kThreads) {
      pi[c] = pi_out[c];
      bt[c] = a.btilde[(size_t)s * C + c];
      m[c] = a.mult[(size_t)s * C + c];
    }
    for (int i = tid; i < C * words; i += kThreads) masks[i] = 0;
    btilde = bt;
    mult = m;
    if (tid == kIssuer) {
      for (int i = 0; i < stages; ++i) mbar_init(full + i);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int t = 0, b = 0; t < stages && t < a.total;
           ++t, b = next_mod(b, a.n_batches))
        issue_step<kElig>(smem + t * sb, full + t,
                          step_src<kElig>(a, lane_sampled, lane_elig, t, b,
                                          eb),
                          B, C, W, eb);
    }
    __syncthreads();
  } else {
    float* scr = a.scratch + (size_t)s * 2 * B;
    pi = pi_out;
    winners = reinterpret_cast<int*>(scr);
    prices = scr + B;
    btilde = a.btilde + (size_t)s * C;
    mult = a.mult + (size_t)s * C;
  }

  // the row layout: tpr threads a row (the lanes of a warp, slice k of
  // rows rw), quads when C is a multiple of 4 and every input on 16 bytes
  const int tpr = threads_per_row(B);
  const int rpw = 32 / tpr;                  // rows a warp, a power of two
  const int rows_per_pass = kWorkers / tpr;
  const int k = lane >> (__ffs(rpw) - 1);    // this thread's slice
  const int rw = lane & (rpw - 1);           // its row in the warp
  const bool quad = a.quad != 0;
  const bool worker = warp < kWarps;

  // the batch, the ring's slot and phase, the batch `stages` steps on and
  // the tracking count, carried from step to step
  int b = 0, slot = 0, b_ahead = stages % a.n_batches, tracked = 0;
  uint32_t phase = 0;
  for (int t = 0; t < a.total; ++t) {
    const StepSrc src = step_src<kElig>(a, lane_sampled, lane_elig, t, b,
                                        eb);
    const float *v, *u;
    const uint8_t* el = nullptr;
    float st, dn;           // the step's size and the batch's live count
    if (kStaged) {
      const unsigned char* base = smem + slot * sb;
      // the last step's slot is read (two barriers ago): it takes the step
      // `stages` on from it, copied while this step runs
      if (tid == kIssuer && t > 0 && t - 1 + stages < a.total) {
        const int prev = slot == 0 ? stages - 1 : slot - 1;
        issue_step<kElig>(smem + prev * sb, full + prev,
                          step_src<kElig>(a, lane_sampled, lane_elig,
                                          t - 1 + stages, b_ahead, eb),
                          B, C, W, eb);
      }
      mbar_wait(full + slot, phase);
      st = *reinterpret_cast<const float*>(base + lead(src.step));
      dn = *reinterpret_cast<const float*>(base + 16 + lead(src.denom));
      base += kScalars;
      v = reinterpret_cast<const float*>(base + lead(src.v));
      u = reinterpret_cast<const float*>(base + rows_region(B, C) +
                                         lead(src.u));
      if (kElig)
        el = base + rows_region(B, C) + u_region(B, W) + lead(src.e);
    } else {
      st = *src.step;
      dn = *src.denom;
      v = src.v;
      u = src.u;
      el = src.e;
    }

    // resolve: a warp holds 32 / tpr rows, lane = slice * rows + row, so
    // a 16-byte load of a quad feeds eight rows without bank conflicts
    // when C / 4 is odd; the warp-uniform loop keeps every lane of a warp
    // in the shuffles
    for (int r0 = 0; worker && r0 < B; r0 += rows_per_pass) {
      const int r = r0 + warp * rpw + rw;
      const bool row_ok = r < B;
      float best = reserve, second = reserve;  // eligible: bid > reserve
      int win = -1;
      if (row_ok && (long long)b * B + r < a.sample_size)
        win = quad ? scan_row<4, kSecond, kElig>(
                         v + (size_t)r * C, u + (size_t)r * W, shared_u, pi,
                         mult, kElig ? el + (size_t)r * C : nullptr, k, tpr,
                         C / 4, best, second)
                   : scan_row<1, kSecond, kElig>(
                         v + (size_t)r * C, u + (size_t)r * W, shared_u, pi,
                         mult, kElig ? el + (size_t)r * C : nullptr, k, tpr,
                         C, best, second);
      // merge the row's slices: the larger best wins, the lower column on
      // a tie; the second price is the larger of the loser's best and the
      // winner's second
      for (int o = rpw; o < 32; o <<= 1) {
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
        // second price: max(second-highest eligible bid, reserve), which
        // is `second` because it started at the reserve
        const float price = win >= 0 ? (kSecond ? second : best) : 0.0f;
        if (kStaged) {
          if (win >= 0) {
            prices[r] = price;
            atomicOr(masks + (size_t)win * words + (r >> 5), 1u << (r & 31));
          }
        } else {
          winners[r] = win;
          prices[r] = price;
        }
      }
    }
    __syncthreads();        // every row resolved; the stage is read

    // the update of pi, a thread a campaign: its sum is the prices of the
    // rows it won added in row order from +0.0, then one rounding in the
    // multiply-add, then the clamp
    const bool keep = a.history != nullptr && tracked == 0;
    const long long row_h = ((size_t)s * n_tracked +
                             (keep ? t / a.track_every : 0)) * C;
    for (int c = worker ? tid : C; c < C; c += kWorkers) {
      float acc = 0.0f;
      bool won = false;
      if (kStaged) {
        for (int w = 0; w < words; ++w) {
          uint32_t mk = masks[(size_t)c * words + w];
          if (mk == 0) continue;
          masks[(size_t)c * words + w] = 0;
          won = true;
          do {
            acc = acc + prices[32 * w + __ffs(mk) - 1];
            mk &= mk - 1;
          } while (mk != 0);
        }
      } else {
        // a row it did not win adds +0.0, which leaves a sum that is
        // never -0.0 unchanged
        won = true;
        for (int r = 0; r < B; ++r)
          acc = acc + (winners[r] == c ? prices[r] : 0.0f);
      }
      const float delta =
          won ? __fsub_rn(btilde[c], __fdiv_rn(acc, dn)) : btilde[c];
      const float x = __fmaf_rn(st, delta, pi[c]);
      const float p = x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
      pi[c] = p;
      if (keep) a.history[row_h + c] = p;
    }
    b = next_mod(b, a.n_batches);
    if (t > 0) b_ahead = next_mod(b_ahead, a.n_batches);
    if (kStaged) {
      slot = next_mod(slot, stages);
      phase ^= slot == 0 ? 1u : 0u;
    }
    if (a.history != nullptr) tracked = next_mod(tracked, a.track_every);
    __syncthreads();        // pi is updated
  }
  if (kStaged)
    for (int c = tid; c < C; c += kThreads) pi_out[c] = pi[c];
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

// The ring's stages for a staged run: the most, up to kMaxStages, that
// fit; 0 when not even kMinStages do (the state lives in device memory).
bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int ring_stages(int B, int C, int W, bool elig) {
  for (int n = kMaxStages; n >= kMinStages; --n)
    if (staged_bytes(B, C, W, elig, n) <= (long long)auction_tile::kMaxSmem)
      return n;
  return 0;
}

}  // namespace

extern "C" {

// 1 when the staged state of a (B, C, W) run (with a per-lane eligibility
// when `elig` is 1) fits in shared memory, 0 when the run keeps it in
// device memory (and needs `scratch`).
int vi_staged(int B, int C, int W, int elig) {
  return ring_stages(B, C, W, elig != 0) > 0 ? 1 : 0;
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
  const bool has_elig = elig != nullptr;
  const int stages = ring_stages(B, C, W, has_elig);
  const bool quad = C % 4 == 0 && aligned16(sampled) &&
                    (W == 1 || aligned16(u)) &&
                    (!has_elig || aligned16(elig));
  const Args a{sampled, u, step, denom, btilde, mult, reserves, pi,
               history, scratch, elig, S, C, B, W, n_batches, total,
               sample_size, track_every, sampled_stride, stages,
               quad ? 1 : 0};
  const bool second = second_price != 0;
  if (stages > 0)
    return launch_rule<true>(a, second, has_elig,
                             (size_t)staged_bytes(B, C, W, has_elig, stages),
                             stream);
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  return launch_rule<false>(a, second, has_elig, 0, stream);
}

}  // extern "C"
