// Kernels D and E: batched polynomial evaluation (and the powers of a
// point), and Kate division, over (n, 16) limb tensors.
//
// Kernel D replaces the device program XLA compiles from the JAX package's
// batch evaluation (halo2_tpu/ops/polyeval.py:71-80 _batch_eval_kernel: a
// log-doubling power ladder, device_powers :36, a take, a product and a
// log-depth tree sum, _tree_sum :53). In the port it evaluates every
// query of a proof (plonk/prover.py's evaluation stack, the lookups' and
// the permutations' evaluations, the multiopen's q evaluations at x3, the
// KZG openings) and, in its powers mode, writes [1, x, ..., x^(n-1)], the
// IPA opening's b.
// - power_table_kernel: x^(2^j) for j < L of each point, one thread a
//   point (device_powers; batch_eval_mont builds the same table on the
//   host from its host points);
// - eval_kernel: a block per (row block, polynomial); a thread takes a run
//   of kRunRows rows, starts from x^r0 (the table entries of r0's bits),
//   steps one product a row and sums c_i x^i; the block sums its threads'
//   sums into one partial (powers mode: it writes x^i instead);
// - eval_sum_kernel: one warp a polynomial sums its blocks' partials.
//
// Kernel E replaces the JAX package's Kate division
// (halo2_tpu/ops/polyeval.py:137-156 _kate_kernel, a reverse associative
// scan of the affine maps v -> b v + a_i): q_i = s_{i+1} with the suffix
// recurrence s_i = a_i + b s_{i+1}, s_n = 0, and q_{n-1} = 0. A
// reduce-then-scan over runs of kRunRows rows (csrc/scan.cuh):
// - kate_run_kernel: each run's suffix Horner sum h_t from zero;
// - kate_carry_kernel: one block scans the maps v -> b^kRunRows v + h_t in
//   reverse (later runs first) into each run's carry in, s at the row after
//   the run;
// - kate_apply_kernel: each run's Horner steps again from its carry in,
//   writing q.
//
// Products fe_mul_cc<kPasta> and sums fe_add_cc (kernel A's forms), so the
// outputs lie in [0, 2p) and equal the plain versions (ops/polyeval.py,
// rounds of kernel A) as values mod p; the order of the sums and products
// differs, so not always their limbs.
//
// What bounds them on an H100: kernel D's M n products (17 ps each in the
// Pasta form) against 64 M n bytes of coefficients (19 ps a row at
// 3.35 TB/s): bytes, barely, and at the paths' shapes (n = 2^11 .. 2^17)
// a few microseconds of either. Kernel E's n products and 128 bytes a row
// are under a microsecond at n = 2^14. Both are bound by the latency of
// their chains of products in practice: a thread's run of kRunRows steps
// and the start power of eval_kernel (one product a set bit of r0), the
// carry scan's 2 log2(kCarryThreads) combines. The design keeps the runs short and
// needs no round trip to the host.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

constexpr int kEvalThreads = 128;

struct EvalArgs {
  const int32_t* coeffs;  // (M, n, 16); unused in powers mode
  const int32_t* xtab;    // (Q, L, 16): x_q^(2^j)
  const int32_t* sel;     // (M,) the point of each polynomial; unused in powers mode
  int32_t* partial;       // (M, blocks, 16)
  int32_t* out;           // (M, 16) evaluations, or (Q, n, 16) powers
  long long n;
  int L;
  int blocks;             // row blocks a polynomial
};

template <bool kPasta>
__global__ void power_table_kernel(const int32_t* x, int32_t* xtab, int Q, int L, FieldConsts k) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  Fe w = row_load(x, q);
  for (int j = 0; j < L; ++j) {
    row_store(xtab, (long long)q * L + j, w);
    if (j + 1 < L) w = fe_mul_cc<kPasta>(w, w, k);
  }
}

template <bool kPasta, bool kPowers>
__global__ void __launch_bounds__(kEvalThreads) eval_kernel(EvalArgs g, FieldConsts k) {
  __shared__ Fe sh[32];
  const int m = blockIdx.y;
  const int q = kPowers ? m : g.sel[m];
  const int32_t* tab = g.xtab + (long long)q * g.L * 16;
  const long long r0 = ((long long)blockIdx.x * kEvalThreads + threadIdx.x) * kRunRows;
  Fe acc = fe_zero();
  if (r0 < g.n) {
    Fe pw = fe_from(k.one);
    bool any = false;
    for (int j = 0; j < g.L; ++j) {
      if ((r0 >> j) & 1) {
        const Fe e = row_load(tab, j);
        pw = any ? fe_mul_cc<kPasta>(pw, e, k) : e;
        any = true;
      }
    }
    const Fe x = row_load(tab, 0);
    const int32_t* c = g.coeffs + (long long)m * g.n * 16;
#pragma unroll
    for (int i = 0; i < kRunRows; ++i) {
      const long long r = r0 + i;
      if (r < g.n) {
        if (kPowers)
          row_store(g.out, (long long)q * g.n + r, pw);
        else
          acc = fe_add_cc(acc, fe_mul_cc<kPasta>(row_load(c, r), pw, k), k);
        if (i + 1 < kRunRows && r + 1 < g.n) pw = fe_mul_cc<kPasta>(pw, x, k);
      }
    }
  }
  if (kPowers) return;
  acc = block_sum(acc, sh, k);
  if (threadIdx.x == 0) row_store(g.partial, (long long)m * g.blocks + blockIdx.x, acc);
}

// one warp a polynomial: out[m] = the sum of its blocks' partials
__global__ void eval_sum_kernel(EvalArgs g, FieldConsts k) {
  __shared__ Fe sh[32];
  const int m = blockIdx.x;
  Fe acc = fe_zero();
  for (int b = threadIdx.x; b < g.blocks; b += blockDim.x)
    acc = fe_add_cc(acc, row_load(g.partial, (long long)m * g.blocks + b), k);
  acc = block_sum(acc, sh, k);
  if (threadIdx.x == 0) row_store(g.out, m, acc);
}

struct KateArgs {
  const int32_t* a;  // (n, 16) coefficients
  int32_t* q;        // (n, 16) quotient
  int32_t* tot;      // (T, 16) run sums
  int32_t* carry;    // (T, 16) carries in
  long long n;
  long long runs;
  Fe b;              // b in Montgomery form
  Fe bR;             // b^kRunRows
};

template <bool kPasta>
__global__ void __launch_bounds__(kRunThreads) kate_run_kernel(KateArgs g, FieldConsts k) {
  const long long t = (long long)blockIdx.x * kRunThreads + threadIdx.x;
  if (t >= g.runs) return;
  const long long r0 = t * kRunRows;
  Fe s = fe_zero();
  bool any = false;
#pragma unroll
  for (int j = kRunRows - 1; j >= 0; --j) {
    if (r0 + j < g.n) {
      const Fe a = row_load(g.a, r0 + j);
      s = any ? fe_add_cc(a, fe_mul_cc<kPasta>(g.b, s, k), k) : a;
      any = true;
    }
  }
  row_store(g.tot, t, s);
}

// one block: each run's carry in, the composition of the later runs' maps
// v -> b^kRunRows v + h at 0
template <bool kPasta>
__global__ void __launch_bounds__(kCarryThreads) kate_carry_kernel(KateArgs g, FieldConsts k) {
  using Op = AffineOp<kPasta>;
  using S = typename Op::S;
  __shared__ S sh[32];
  const Op op{k};
  const long long chunk = (g.runs + kCarryThreads - 1) / kCarryThreads;
  const long long c0 = threadIdx.x * chunk, c1 = min(c0 + chunk, g.runs);
  S agg = op.identity();
  for (long long t = c1 - 1; t >= c0; --t) {
    const S e{g.bR, row_load(g.tot, t)};
    agg = t == c1 - 1 ? e : op.combine(agg, e);
  }
  S total;  // unused: every run needs only the runs after it
  S carry = block_exclusive_scan<true>(agg, op, sh, total);
  for (long long t = c1 - 1; t >= c0; --t) {
    row_store(g.carry, t, carry.c);
    carry = op.combine(carry, S{g.bR, row_load(g.tot, t)});
  }
}

template <bool kPasta>
__global__ void __launch_bounds__(kRunThreads) kate_apply_kernel(KateArgs g, FieldConsts k) {
  const long long t = (long long)blockIdx.x * kRunThreads + threadIdx.x;
  if (t >= g.runs) return;
  const long long r0 = t * kRunRows;
  Fe s = row_load(g.carry, t);  // s at the row after the run
#pragma unroll
  for (int j = kRunRows - 1; j >= 0; --j) {
    if (r0 + j < g.n) {  // rows past n: s stays 0 (the last run's carry)
      row_store(g.q, r0 + j, s);
      if (j > 0) s = fe_add_cc(row_load(g.a, r0 + j), fe_mul_cc<kPasta>(g.b, s, k), k);
    }
  }
}

Fe words(const uint32_t* w) {
  Fe r;
  for (int i = 0; i < 8; ++i) r.v[i] = w[i];
  return r;
}

}  // namespace

extern "C" int polyeval_run_rows() { return kRunRows; }

// Q points' tables x^(2^j), j < L, from x (Q, 16).
extern "C" int power_table(const int32_t* x, int32_t* xtab, int Q, int L, const FieldConsts* consts,
                           void* stream) {
  if (Q <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  (pasta_form(*consts) ? power_table_kernel<true> : power_table_kernel<false>)
      <<<(Q + 31) / 32, 32, 0, (cudaStream_t)stream>>>(x, xtab, Q, L, *consts);
  return (int)cudaGetLastError();
}

// powers 0: M evaluations into out (M, 16), partial (M, blocks, 16)
// scratch; powers 1: out (M, n, 16) = x_m^i, coeffs and sel unused.
// blocks must be ceil(n / (kRunRows * 128)).
extern "C" int batch_eval(int powers, const int32_t* coeffs, const int32_t* xtab, const int32_t* sel,
                          int32_t* partial, int32_t* out, long long n, int M, int L, int blocks,
                          const FieldConsts* consts, void* stream) {
  const long long need = (n + (long long)kRunRows * kEvalThreads - 1) / ((long long)kRunRows * kEvalThreads);
  if (n <= 0 || M <= 0 || M > 65535 || L <= 0 || (1LL << L) < n || blocks != need)
    return (int)cudaErrorInvalidValue;
  EvalArgs g{coeffs, xtab, sel, partial, out, n, L, blocks};
  const FieldConsts& k = *consts;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)blocks, (unsigned)M);
  const bool pasta = pasta_form(k);
  if (powers) {
    (pasta ? eval_kernel<true, true> : eval_kernel<false, true>)<<<grid, kEvalThreads, 0, s>>>(g, k);
  } else {
    (pasta ? eval_kernel<true, false> : eval_kernel<false, false>)<<<grid, kEvalThreads, 0, s>>>(g, k);
    eval_sum_kernel<<<M, 32, 0, s>>>(g, k);
  }
  return (int)cudaGetLastError();
}

// q (n, 16) = (a(X) - a(b)) / (X - b); b and bR = b^kRunRows as 8 words,
// Montgomery form; tot and carry (ceil(n / kRunRows), 16) scratch.
extern "C" int kate_div(const int32_t* a, int32_t* q, int32_t* tot, int32_t* carry, long long n,
                        const uint32_t* b, const uint32_t* bR, const FieldConsts* consts, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  KateArgs g{a, q, tot, carry, n, (n + kRunRows - 1) / kRunRows, words(b), words(bR)};
  const long long blocks = (g.runs + kRunThreads - 1) / kRunThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const FieldConsts& k = *consts;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned nb = (unsigned)blocks;
  if (pasta_form(k)) {
    kate_run_kernel<true><<<nb, kRunThreads, 0, s>>>(g, k);
    kate_carry_kernel<true><<<1, kCarryThreads, 0, s>>>(g, k);
    kate_apply_kernel<true><<<nb, kRunThreads, 0, s>>>(g, k);
  } else {
    kate_run_kernel<false><<<nb, kRunThreads, 0, s>>>(g, k);
    kate_carry_kernel<false><<<1, kCarryThreads, 0, s>>>(g, k);
    kate_apply_kernel<false><<<nb, kRunThreads, 0, s>>>(g, k);
  }
  return (int)cudaGetLastError();
}
