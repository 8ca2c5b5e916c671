// Kernel F: the rounds of an IPA opening, over n lanes.
//
// Replaces the device programs XLA compiles from the JAX package's round
// pieces (halo2_tpu/poly/ipa/__init__.py:356 emit and :386 fold, jitted
// once each and shape-stable: the live length m is a value, lanes >= m
// are masked). g is never folded: after r rounds the scalar of base g[i]
// is s_mult[i] times a coefficient of p', so each round's L and R are one
// MSM of n + 2 scalars over the bases g ++ [u, w] (ops/msm_bucket.py).
//
// round_kernel<kFold, kEmit>, a thread a lane, one launch a call:
// - fold (kFold) at m, half = m / 2: p'_lo + u^-1 p'_hi and b_lo + u b_hi
//   on lanes below half (zero above), and s_mult times u on lanes with the
//   half bit set;
// - emit (kEmit) at m_e (m / 2 after a fold, else m), h = m_e / 2: with
//   j = lane mod m_e, row 0 (L) of the lane is s_mult * p'[h + j] where
//   j's h bit is clear, row 1 (R) is s_mult * p'[j - h] where it is set,
//   the other 0; lane i below h also forms p'[i + h] b[i] and lane h + i
//   forms p'[i] b[h + i] (each a product with its partner's p'), which warp
//   shuffles and each block sum into its partials. The block that
//   finishes last (a ticket from a completion counter, scan.cuh
//   last_block) sums the partials, half its threads each inner product
//   with four loads in flight a thread, writes z times each into lane n of
//   its row and the round's blinding scalars into lane n + 1, and sets the
//   counter back to 0: no tail launch and no memset.
// Both together are round r - 1's fold and round r's emit in one launch
// (ops/ipa_round.py round_fold_emit): the fold is lane-local given lanes i
// and i + m / 2, so a thread recomputes the folded p' and b at the lanes
// its emit reads (its partner j +- h, and lane + h) from the unfolded ones
// instead of waiting for them, and no grid-wide sync is needed. An opening
// of k rounds is then k + 1 launches: an emit, k - 1 fused rounds and the
// last fold. A thread's products run one after another (each carry chain
// is a run of volatile PTX), so the work is spread to keep each thread's
// run short, 4 products at most: lane i < m / 2 folds b[i], its partner's
// p' and forms one inner product and its scalar; lane m / 2 + i folds
// p'[i] for it, its s_mult, its partner's p' and its scalar.
// Products fe_mul_cc<kPasta>, sums fe_add_cc, as kernel A; the outputs lie
// in [0, 2p) and equal the plain versions (ops/ipa_round.py
// round_emit_plain, round_fold_plain) as values mod p. The MSM takes its
// scalars through from_mont, so it reads values, not limbs.
//
// What bounds it on an H100: bytes. A fused round reads p' and b on m
// lanes and s_mult on n and writes the three folded on n lanes and two
// rows of n + 2 (at m = n about 512 bytes a lane, 0.15 ns at 3.35 TB/s),
// against up to 4 products a lane (17 ps each on Pasta): 2.5 microseconds
// at n = 2^14. In practice a chain of latencies: a lane's products, five
// shuffle levels, the ticket, the last block's sums and its product by z.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

constexpr int kRoundThreads = 128;
constexpr int kRoundWarps = kRoundThreads / 32;
static_assert(kRoundThreads % 32 == 0 && kRoundWarps >= 2 && kRoundWarps <= 32, "2-32 whole warps");

struct RoundArgs {
  const int32_t* pp;     // (n, 16) p'
  const int32_t* b;      // (n, 16)
  const int32_t* s;      // (n, 16) s_mult
  const int32_t* z;      // (16,) emit: z
  const int32_t* rands;  // (2, 16) emit: the round's blinding scalars
  const int32_t* u;      // (16,) fold: u
  const int32_t* uinv;   // (16,) fold: u^-1
  int32_t* folded;       // fold: (3, n, 16) p', b, s_mult
  int32_t* scal;         // emit: (2, n + 2, 16)
  uint32_t* partial;     // emit: (2, blocks, 8) words
  uint32_t* counter;     // emit: the completion counter, 0 between launches
  long long n;
  long long m;           // the live length of the inputs, a power of two in [2, n]
  int blocks;
};

// v (p' or b) at lane i as the emit reads it: folded at m = 2 half (kFold),
// v_lo + mult v_hi below half and 0 above, or as it is
template <bool kPasta, bool kFold>
__device__ __forceinline__ Fe lane_at(const int32_t* v, long long i, long long half, const Fe& mult,
                                      const FieldConsts& k) {
  if (!kFold) return row_load(v, i);
  if (i >= half) return fe_zero();
  return fe_add_cc(row_load(v, i), fe_mul_cc<kPasta>(row_load(v, i + half), mult, k), k);
}

template <bool kPasta, bool kFold, bool kEmit>
__global__ void __launch_bounds__(kRoundThreads) round_kernel(const __grid_constant__ RoundArgs g, FieldConsts k) {
  const long long lane = (long long)blockIdx.x * kRoundThreads + threadIdx.x;
  const long long half = g.m >> 1;                      // the fold's
  const long long me = kFold ? half : g.m, h = me >> 1;  // the emit's m and half
  const Fe u = kFold ? row_load(g.u, 0) : fe_zero(), uinv = kFold ? row_load(g.uinv, 0) : fe_zero();
  Fe vl = fe_zero(), vr = fe_zero();
  if (lane < g.n) {
    Fe s = row_load(g.s, lane);
    if (kFold && (lane & half)) s = fe_mul_cc<kPasta>(s, u, k);
    Fe own_b = fe_zero();
    if (kFold) {  // lanes >= half fold to 0 with no product
      own_b = lane_at<kPasta, kFold>(g.b, lane, half, u, k);
      row_store(g.folded, g.n + lane, own_b);
      row_store(g.folded, 2 * g.n + lane, s);
      if (lane >= half) {
        row_store(g.folded, lane, fe_zero());
        // p' of lane - half, whose own run of products is the longer one
        if (lane < g.m) row_store(g.folded, lane - half, lane_at<kPasta, kFold>(g.pp, lane - half, half, uinv, k));
      }
    } else if (lane < me) {
      own_b = row_load(g.b, lane);
    }
    if (kEmit) {
      const long long j = lane & (me - 1);
      const bool hi = (j & h) != 0;
      const Fe partner = lane_at<kPasta, kFold>(g.pp, hi ? j - h : j + h, half, uinv, k);
      // the inner products split over the live lanes, a product each: lane
      // i < h forms p'[i + h] b[i] (its partner's p'), lane h + i forms
      // p'[i] b[h + i]; a thread's products run one after another, so no
      // lane takes both
      if (lane < me) (hi ? vr : vl) = fe_mul_cc<kPasta>(partner, own_b, k);
      const Fe w = fe_mul_cc<kPasta>(s, partner, k);
      row_store(g.scal, hi ? g.n + 2 + lane : lane, w);
      row_store(g.scal, hi ? lane : g.n + 2 + lane, fe_zero());
    }
  }
  if (!kEmit) return;
  __shared__ Fe sh[2][kRoundWarps];
  const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
  vl = warp_sum(vl, k);
  vr = warp_sum(vr, k);
  if (wl == 0) {
    sh[0][warp] = vl;
    sh[1][warp] = vr;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    Fe v = sh[threadIdx.x][0];
    for (int w = 1; w < kRoundWarps; ++w) v = fe_add_cc(v, sh[threadIdx.x][w], k);
    fe_store_words(g.partial + ((long long)threadIdx.x * g.blocks + blockIdx.x) * 8, v);
  }
  if (!last_block(g.counter, threadIdx.x < 2)) return;
  // the last block: <p'_hi, b_lo> over its first half of threads, <p'_lo,
  // b_hi> over the second, each then times z by its half's first thread
  constexpr int kHalf = kRoundThreads / 2;
  const int which = threadIdx.x >= kHalf;
  Fe v = sum_words(g.partial + (long long)which * g.blocks * 8, g.blocks, threadIdx.x - which * kHalf, kHalf, k);
  if (wl == 0) sh[0][warp] = v;
  __syncthreads();
  if (threadIdx.x % kHalf == 0) {
    for (int w = 1; w < kRoundWarps / 2; ++w) v = fe_add_cc(v, sh[0][warp + w], k);
    const long long at = which * (g.n + 2) + g.n;
    row_store(g.scal, at, fe_mul_cc<kPasta>(row_load(g.z, 0), v, k));
    row_store(g.scal, at + 1, row_load(g.rands, which));
  }
}

template <bool kFold, bool kEmit>
void launch(const RoundArgs& g, const FieldConsts& k, cudaStream_t st) {
  if (pasta_form(k))
    round_kernel<true, kFold, kEmit><<<g.blocks, kRoundThreads, 0, st>>>(g, k);
  else
    round_kernel<false, kFold, kEmit><<<g.blocks, kRoundThreads, 0, st>>>(g, k);
}

}  // namespace

// One launch. fold 1: folded (3, n, 16) from pp, b, s, u, uinv at m.
// emit 1: scal (2, n + 2, 16) from pp, b, s (folded first, with fold 1),
// z, rands at m (m / 2 with fold 1, which needs m >= 4); partial (2,
// blocks, 8) words of scratch; counter one word, 0 (the last block sets it
// back to 0). blocks must be ceil(n / 128), 128 threads a block.
extern "C" int ipa_round(int fold, int emit, const int32_t* pp, const int32_t* b, const int32_t* s,
                         const int32_t* z, const int32_t* rands, const int32_t* u, const int32_t* uinv,
                         int32_t* folded, int32_t* scal, uint32_t* partial, uint32_t* counter, long long n,
                         long long m, int blocks, const FieldConsts* consts, void* stream) {
  if (n <= 0 || m < (fold && emit ? 4 : 2) || m > n || (m & (m - 1)) || !(fold || emit) ||
      blocks != (n + kRoundThreads - 1) / kRoundThreads)
    return (int)cudaErrorInvalidValue;
  const RoundArgs g{pp, b, s, z, rands, u, uinv, folded, scal, partial, counter, n, m, blocks};
  const FieldConsts& k = *consts;
  cudaStream_t st = (cudaStream_t)stream;
  if (fold && emit)
    launch<true, true>(g, k, st);
  else if (fold)
    launch<true, false>(g, k, st);
  else
    launch<false, true>(g, k, st);
  return (int)cudaGetLastError();
}
