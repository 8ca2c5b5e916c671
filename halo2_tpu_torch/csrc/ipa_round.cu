// Kernel F: the two programs of an IPA opening round, over n lanes.
//
// Replaces the device programs XLA compiles from the JAX package's round
// pieces (halo2_tpu/poly/ipa/__init__.py:356 emit and :386 fold, jitted
// once each and shape-stable: the live length m is a value, lanes >= m
// are masked). g is never folded: after r rounds the scalar of base g[i]
// is s_mult[i] times a coefficient of p', so each round's L and R are one
// MSM of n + 2 scalars over the bases g ++ [u, w] (ops/msm_bucket.py).
// - round_emit_kernel: a thread a lane. With half = m / 2, j = lane mod m and
//   hi = j & half, row 0 (L) of lane is s_mult * p'[half + j] where hi is
//   clear, row 1 (R) is s_mult * p'[j - half] where it is set, the other 0;
//   lanes below half also form p'[lane + half] b[lane] and
//   p'[lane] b[lane + half], and each block sums both into partials;
// - round_tail_kernel: one block sums the partials, <p'_hi, b_lo> and
//   <p'_lo, b_hi>, and writes z times each into lane n of its row and the
//   round's blinding scalars into lane n + 1;
// - round_update_kernel: a thread a lane: p'_lo + u^-1 p'_hi and
//   b_lo + u b_hi on lanes below half (zero above), and s_mult times u on
//   lanes with the half bit set.
// Products fe_mul_cc<kPasta>, sums fe_add_cc, as kernel A; the outputs lie
// in [0, 2p) and equal the plain versions (poly/ipa/__init__.py
// _round_emit_plain, _round_fold_plain) as values mod p. The MSM takes
// its scalars through from_mont, so it reads values, not limbs.
//
// What bounds it on an H100: a round's n + m products (17 ps each on
// Pasta) against the bytes, emit reading p', b and s_mult and writing two
// rows (about 320 bytes a lane, 96 ps at 3.35 TB/s): bytes. At n = 2^14
// that is about 1.6 microseconds a round; three launches, where the plain
// version takes about 39 launches of kernel A, two of them tree sums of
// log2(n) levels.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

constexpr int kLaneThreads = 256;

struct RoundArgs {
  const int32_t* pp;     // (n, 16) p'
  const int32_t* b;      // (n, 16)
  const int32_t* s;      // (n, 16) s_mult
  const int32_t* z;      // (16,) emit: z
  const int32_t* rands;  // (2, 16) emit: the round's blinding scalars
  const int32_t* u;      // (16,) fold: u
  const int32_t* uinv;   // (16,) fold: u^-1
  int32_t* out;          // emit (2, n + 2, 16); fold (3, n, 16): p', b, s_mult
  int32_t* partial;      // emit (2, blocks, 16)
  long long n;
  long long m;           // a power of two, 2 <= m <= n
  int blocks;
};

template <bool kPasta>
__global__ void __launch_bounds__(kLaneThreads) round_emit_kernel(RoundArgs g, FieldConsts k) {
  __shared__ Fe sh[32];
  const long long lane = (long long)blockIdx.x * kLaneThreads + threadIdx.x;
  const long long half = g.m >> 1;
  Fe vl = fe_zero(), vr = fe_zero();
  if (lane < g.n) {
    const long long j = lane & (g.m - 1);
    const bool hi = (j & half) != 0;
    const Fe w = fe_mul_cc<kPasta>(row_load(g.s, lane), row_load(g.pp, hi ? j - half : half + j), k);
    row_store(g.out, hi ? g.n + 2 + lane : lane, w);
    row_store(g.out, hi ? lane : g.n + 2 + lane, fe_zero());
    if (lane < half) {
      vl = fe_mul_cc<kPasta>(row_load(g.pp, lane + half), row_load(g.b, lane), k);
      vr = fe_mul_cc<kPasta>(row_load(g.pp, lane), row_load(g.b, lane + half), k);
    }
  }
  vl = block_sum(vl, sh, k);
  vr = block_sum(vr, sh, k);
  if (threadIdx.x == 0) {
    row_store(g.partial, blockIdx.x, vl);
    row_store(g.partial, g.blocks + blockIdx.x, vr);
  }
}

// one block: lane n of each row z * its inner product, lane n + 1 its
// blinding scalar
template <bool kPasta>
__global__ void __launch_bounds__(kLaneThreads) round_tail_kernel(RoundArgs g, FieldConsts k) {
  __shared__ Fe sh[32];
  Fe vl = fe_zero(), vr = fe_zero();
  for (int b = threadIdx.x; b < g.blocks; b += kLaneThreads) {
    vl = fe_add_cc(vl, row_load(g.partial, b), k);
    vr = fe_add_cc(vr, row_load(g.partial, g.blocks + b), k);
  }
  vl = block_sum(vl, sh, k);
  vr = block_sum(vr, sh, k);
  if (threadIdx.x == 0) {
    const Fe z = row_load(g.z, 0);
    row_store(g.out, g.n, fe_mul_cc<kPasta>(z, vl, k));
    row_store(g.out, g.n + 1, row_load(g.rands, 0));
    row_store(g.out, 2 * g.n + 2, fe_mul_cc<kPasta>(z, vr, k));
    row_store(g.out, 2 * g.n + 3, row_load(g.rands, 1));
  }
}

template <bool kPasta>
__global__ void __launch_bounds__(kLaneThreads) round_update_kernel(RoundArgs g, FieldConsts k) {
  const long long lane = (long long)blockIdx.x * kLaneThreads + threadIdx.x;
  if (lane >= g.n) return;
  const long long half = g.m >> 1;
  Fe pp = fe_zero(), b = fe_zero();
  if (lane < half) {
    pp = fe_add_cc(row_load(g.pp, lane),
                   fe_mul_cc<kPasta>(row_load(g.pp, lane + half), row_load(g.uinv, 0), k), k);
    b = fe_add_cc(row_load(g.b, lane), fe_mul_cc<kPasta>(row_load(g.b, lane + half), row_load(g.u, 0), k),
                  k);
  }
  Fe s = row_load(g.s, lane);
  if (lane & half) s = fe_mul_cc<kPasta>(s, row_load(g.u, 0), k);
  row_store(g.out, lane, pp);
  row_store(g.out, g.n + lane, b);
  row_store(g.out, 2 * g.n + lane, s);
}

}  // namespace

// emit 1: out (2, n + 2, 16) from pp, b, s, z, rands; partial (2, blocks,
// 16) scratch. emit 0 (fold): out (3, n, 16) from pp, b, s, u, uinv.
// blocks must be ceil(n / 256).
extern "C" int ipa_round(int emit, const int32_t* pp, const int32_t* b, const int32_t* s,
                         const int32_t* z, const int32_t* rands, const int32_t* u, const int32_t* uinv,
                         int32_t* out, int32_t* partial, long long n, long long m, int blocks,
                         const FieldConsts* consts, void* stream) {
  if (n <= 0 || m < 2 || m > n || (m & (m - 1)) || blocks != (n + kLaneThreads - 1) / kLaneThreads)
    return (int)cudaErrorInvalidValue;
  RoundArgs g{pp, b, s, z, rands, u, uinv, out, partial, n, m, blocks};
  const FieldConsts& k = *consts;
  cudaStream_t st = (cudaStream_t)stream;
  const bool pasta = pasta_form(k);
  if (emit) {
    (pasta ? round_emit_kernel<true> : round_emit_kernel<false>)<<<blocks, kLaneThreads, 0, st>>>(g, k);
    (pasta ? round_tail_kernel<true> : round_tail_kernel<false>)<<<1, kLaneThreads, 0, st>>>(g, k);
  } else {
    (pasta ? round_update_kernel<true> : round_update_kernel<false>)<<<blocks, kLaneThreads, 0, st>>>(g, k);
  }
  return (int)cudaGetLastError();
}
