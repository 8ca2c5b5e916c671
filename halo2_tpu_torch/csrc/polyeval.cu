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
// recurrence s_i = a_i + b s_{i+1}, s_n = 0, and q_{n-1} = 0. It is one
// launch of the single-pass look-back scan of csrc/scan.cuh
// (kate_kernel), from the last row back, over the maps v -> b v + a_i:
// the maps of L rows compose to v -> b^L v + c, and the scan keeps c
// alone, each combine one product by a power of b from a table that the
// launch takes by value (KateOp); descriptor 0 is the identity (s_n = 0),
// and q_i is the c of the composition of the maps after row i.
//
// Products fe_mul_cc<kPasta> and sums fe_add_cc (kernel A's forms), so the
// outputs lie in [0, 2p) and equal the plain versions (ops/polyeval.py,
// rounds of kernel A) as values mod p; the order of the sums and products
// differs, so not always their limbs.
//
// What bounds them on an H100: kernel D's M n products (17 ps each in the
// Pasta form) against 64 M n bytes of coefficients (19 ps a row at
// 3.35 TB/s): bytes, barely, and at the paths' shapes (n = 2^11 .. 2^17)
// a few microseconds of either. Kernel E's products (about 3 a row here)
// and 128 bytes a row are about a microsecond at n = 2^14. Both are bound
// by the latency of their chains of products in practice: kernel D's run
// of kRunRows steps and the start power of eval_kernel (one product a set
// bit of r0); kernel E's run of kScanRows combines, the block scan's
// levels, the look-back's (5 a window of 32 tiles, and a level a doubling
// of the windows of a round) and one more, each a product and a sum.
// Neither needs a round trip to the host.
#include <cstdint>
#include <cstring>
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

// b's powers that kernel E's scan multiplies by (scan.cuh's operator hooks)
struct KateTable {
  Fe pow2[kPow2];          // b^(2^e)
  Fe lane[32];             // b^(kScanRows l)
  Fe warp[kScanWarps];     // b^(32 kScanRows w)
  Fe row[kScanRows + 1];   // b^j
};

// Kate division's maps v -> b v + a_i: the maps of L rows compose to
// v -> b^L v + c, kept as c, and combine(earlier, later, b^(later's rows))
// is b^L c_earlier + c_later
template <bool kPasta>
struct KateOp {
  struct S {
    static constexpr int kWords = 8;
    Fe c;
  };
  using Pw = Fe;
  FieldConsts k;
  const KateTable& t;
  __device__ S identity() const { return S{fe_zero()}; }
  __device__ S combine(const S& x, const S& y, const Pw& pw) const {
    return S{fe_add_cc(fe_mul_cc<kPasta>(pw, x.c, k), y.c, k)};
  }
  __device__ Pw pow2(int e) const { return t.pow2[e]; }
  __device__ Pw lane_pow(int l) const { return t.lane[l]; }
  __device__ Pw warp_pow(int w) const { return t.warp[w]; }
  __device__ Pw row_pow(int j) const { return t.row[j]; }
  __device__ Pw pw_mul(const Pw& a, const Pw& b) const { return fe_mul_cc<kPasta>(a, b, k); }
};

struct KateArgs {
  const int32_t* a;  // (n, 16) coefficients
  int32_t* q;        // (n, 16) quotient
  Lookback lb;
  long long n;
  long long tiles;   // T = ceil(n / kTileRows)
  KateTable table;
};

// a row's map (b, a_r), as c = a_r; the output q_r is the c of the maps
// after row r applied to 0
template <bool kPasta>
struct KateRows {
  using S = typename KateOp<kPasta>::S;
  const int32_t* a;
  int32_t* q;
  __device__ S element(int, long long r) const { return S{row_load(a, r)}; }
  __device__ S prepare(int, const S& x) const { return x; }
  __device__ void emit(int, long long r, const S& s) const { row_store(q, r, s.c); }
};

template <bool kPasta>
__global__ void __launch_bounds__(kScanThreads) kate_kernel(const __grid_constant__ KateArgs g, FieldConsts k) {
  const KateOp<kPasta> op{k, g.table};
  const long long d = draw_ticket(g.lb);
  if (d == 0) {
    if (threadIdx.x == 0) publish(g.lb, 0, kPrefix, op.identity());
    return;
  }
  KateRows<kPasta> rows{g.a, g.q};
  scan_tile<true, true>(op, rows, g.lb, d, g.n, g.tiles);
}

}  // namespace

extern "C" int polyeval_run_rows() { return kRunRows; }
extern "C" int polyeval_tile_rows() { return kTileRows; }
// Fe entries of kernel E's table of b's powers.
extern "C" int kate_table_entries() { return (int)(sizeof(KateTable) / sizeof(Fe)); }

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

// q (n, 16) = (a(X) - a(b)) / (X - b); table: kate_table_entries() times
// 8 words, b's powers in Montgomery form (ops/polyeval.py kate_words);
// scratch: the words of one scan (ops/scan.py scratch_words), 16-byte
// aligned; its flags are zeroed here, on the
// stream, before the launch (a memset, not a kernel).
extern "C" int kate_div(const int32_t* a, int32_t* q, int32_t* scratch, long long scratch_words, long long n,
                        const uint32_t* table, const FieldConsts* consts, void* stream) {
  const long long tiles = scan_tiles(n);
  if (n <= 0 || tiles + 1 > 0x7FFFFFFFLL || scratch_words < lookback_words(tiles))
    return (int)cudaErrorInvalidValue;
  KateArgs g{a, q, lookback_at(scratch, tiles), n, tiles, {}};
  memcpy(&g.table, table, sizeof(KateTable));
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(scratch, 0, 4 * lookback_flag_words(tiles), s);
  if (err != cudaSuccess) return (int)err;
  const FieldConsts& k = *consts;
  const unsigned blocks = (unsigned)(tiles + 1);
  if (pasta_form(k))
    kate_kernel<true><<<blocks, kScanThreads, 0, s>>>(g, k);
  else
    kate_kernel<false><<<blocks, kScanThreads, 0, s>>>(g, k);
  return (int)cudaGetLastError();
}
