// Kernel G: the grand products' z columns, the lookup's and each
// permutation chunk's, over (n, 16) limb tensors.
//
// Replaces the device programs that XLA compiles from the JAX package's
// jitted z columns (halo2_tpu/plonk/lookup_prover.py:139 _lookup_z_fn and
// halo2_tpu/plonk/permutation_prover.py:44 _perm_z_fn): each row's
// fraction num_i / den_i, with
// - lookup: num_i = (a_i + beta)(s_i + gamma), den_i = (a'_i + beta)(s'_i + gamma);
// - permutation: num_i = prod_j (v_j + beta delta^(base + j) omega^i + gamma),
//   den_i = prod_j (v_j + beta sigma_j + gamma);
// the denominators batch-inverted (a zero, the limbs 0 or p, inverts to 0),
// the exclusive prefix products of the fractions from `init` (one, or the
// previous chunk's last z), rows [n - blinding, n) replaced by the host's
// random rows, and last_z = z[n - blinding - 1] left on the card for the
// next chunk. In the port they ran as kernel A's products and sums around
// kernel C's batch inversion and scan, with the columns stacked and the
// column concatenated by torch copies.
//
// A z column is three launches of the single-pass look-back scan of
// csrc/scan.cuh and one memset of their flags:
// - grand_den_kernel: each row's denominator formed from the columns (kept in a
//   scratch column for the second launch), the exclusive prefix products
//   of the denominators with a zero counted as one, written to out;
// - grand_fraction_kernel: the same scan from the last row back, whose
//   descriptor 0 is the inverse of the first launch's total (its ticket-0
//   block takes it by the binary GCD of csrc/batch_invert.cuh while the
//   others scan), so that a row's prefix times out[i] is 1 / den_i; the
//   row's numerator is formed after the carry, and out[i] becomes
//   num_i / den_i (0 where den_i is 0);
// - grand_z_kernel: the exclusive prefix products of the fractions from init,
//   written in place as the z rows, the random rows past n - blinding, and
//   last_z.
// The columns, the sigma columns, the powers of omega, the random rows and
// the outputs reach the kernels as pointers in their __grid_constant__
// parameters, and beta, gamma and the chunk's beta delta^(base + j) as
// values there, so a call stacks, concatenates and copies nothing.
//
// The products are fe_mul_cc<kPasta> (the Pasta form chosen on the host as
// kernel A does, the generic form for BN254's scalar field on the KZG
// path), so every output lies in the lazy domain [0, 2p) and equals the
// plain versions (ops/grand_product.py: the JAX programs' order of
// operations on kernels A and C) as a value mod p, not always in its limbs.
//
// What bounds it on an H100: its bytes (the columns read once and z
// written once: (2 ncols + 2) x 64 bytes a row for a permutation chunk
// with its powers of omega, 5 x 64 for a lookup) and its products (about
// 4 ncols + 5 a row) are a few microseconds at n = 2^14 at most, so a call
// is bound by latency: three scans' chains (kernel C's, a run of two rows,
// the block's levels and the look-back), the rows' products before the
// first and after the second, and the inverse on one thread between them.
#include <cstdint>
#include <cuda_runtime.h>

#include "batch_invert.cuh"
#include "scan.cuh"

namespace {

constexpr int kMaxCols = 32;  // columns of a permutation chunk (a lookup takes 4)
enum Kind { kLookup = 0, kPermutation = 1 };

}  // namespace

// The launch's parameters (mirrored by ops/grand_product.py's GrandParams;
// the entry point fills in lb and tiles).
struct GrandParams {
  const int32_t* cols[kMaxCols];    // (n, 16) each; a lookup: a, s, a', s'
  const int32_t* sigmas[kMaxCols];  // (n, 16) each, a permutation chunk's
  const int32_t* omega;             // (n, 16): omega^i (a permutation)
  const int32_t* rand;              // (blinding, 16)
  const int32_t* init;              // (16,), or null for one
  int32_t* out;                     // (n, 16): z
  int32_t* last_z;                  // (16,), or null
  int32_t* den;                     // (n, 16) scratch: each row's denominator
  int32_t* scratch;                 // the three scans' look-back words
  long long n;
  long long tiles;
  int kind;
  int ncols;
  int blinding;
  uint32_t beta[8], gamma[8];       // Montgomery words
  uint32_t dpows[kMaxCols][8];      // beta delta^(base + j)
  uint32_t r3[8];                   // R^3 mod p
  FieldConsts k;
  Lookback lb[3];
};
static_assert(sizeof(GrandParams) <= 4096, "a kernel's parameters fit 4 KB");

namespace {

// row r's denominator
template <bool kPasta>
__device__ __forceinline__ Fe den_row(const GrandParams& p, long long r) {
  const FieldConsts& k = p.k;
  const Fe beta = fe_from(p.beta), gamma = fe_from(p.gamma);
  if (p.kind == kLookup)
    return fe_mul_cc<kPasta>(fe_add_cc(row_load(p.cols[2], r), beta, k),
                             fe_add_cc(row_load(p.cols[3], r), gamma, k), k);
  Fe acc;
#pragma unroll 1
  for (int j = 0; j < p.ncols; ++j) {
    const Fe bs = fe_mul_cc<kPasta>(row_load(p.sigmas[j], r), beta, k);
    const Fe t = fe_add_cc(fe_add_cc(row_load(p.cols[j], r), bs, k), gamma, k);
    acc = j == 0 ? t : fe_mul_cc<kPasta>(acc, t, k);
  }
  return acc;
}

// row r's numerator
template <bool kPasta>
__device__ __forceinline__ Fe num_row(const GrandParams& p, long long r) {
  const FieldConsts& k = p.k;
  const Fe beta = fe_from(p.beta), gamma = fe_from(p.gamma);
  if (p.kind == kLookup)
    return fe_mul_cc<kPasta>(fe_add_cc(row_load(p.cols[0], r), beta, k),
                             fe_add_cc(row_load(p.cols[1], r), gamma, k), k);
  const Fe w = row_load(p.omega, r);
  Fe acc;
#pragma unroll 1
  for (int j = 0; j < p.ncols; ++j) {
    const Fe wd = fe_mul_cc<kPasta>(w, fe_from(p.dpows[j]), k);
    const Fe t = fe_add_cc(fe_add_cc(row_load(p.cols[j], r), wd, k), gamma, k);
    acc = j == 0 ? t : fe_mul_cc<kPasta>(acc, t, k);
  }
  return acc;
}

// the first launch: each row's denominator, kept in p.den, with a zero
// counted as one; out[r] the product of the rows before r
template <bool kPasta>
struct DenRows {
  using S = typename MulOp<kPasta>::S;
  const GrandParams& p;
  __device__ S element(int, long long r) const {
    const Fe d = den_row<kPasta>(p, r);
    row_store(p.den, r, d);
    return S{fe_is_zero(d, p.k) ? fe_from(p.k.one) : d};
  }
  __device__ S prepare(int, const S& x) const { return x; }
  __device__ void emit(int, long long r, const S& s) const { row_store(p.out, r, s.a); }
};

// the second launch, from the last row back: x, the rows after r times the
// total's inverse (through the carry), meets out[r], the rows before r, in
// 1 / den_r; the row's numerator follows
template <bool kPasta>
struct FractionRows {
  using S = typename MulOp<kPasta>::S;
  const GrandParams& p;
  bool zero[kScanRows] = {};
  Fe pre[kScanRows] = {};
  __device__ S element(int j, long long r) {
    const Fe d = row_load(p.den, r);
    zero[j] = fe_is_zero(d, p.k);
    pre[j] = row_load(p.out, r);
    return S{zero[j] ? fe_from(p.k.one) : d};
  }
  __device__ S prepare(int j, const S& x) const { return S{fe_mul_cc<kPasta>(pre[j], x.a, p.k)}; }
  __device__ void emit(int j, long long r, const S& s) const {
    row_store(p.out, r, zero[j] ? fe_zero() : fe_mul_cc<kPasta>(s.a, num_row<kPasta>(p, r), p.k));
  }
};

// the third launch: the exclusive prefix products of the fractions from
// init, in place; rows from n - blinding on take the random rows, and
// last_z is row n - blinding - 1
template <bool kPasta>
struct ZRows {
  using S = typename MulOp<kPasta>::S;
  const GrandParams& p;
  __device__ S element(int, long long r) const { return S{row_load(p.out, r)}; }
  __device__ S prepare(int, const S& x) const { return x; }
  __device__ void emit(int, long long r, const S& s) const {
    const long long usable = p.n - p.blinding;
    if (r < usable) {
      row_store(p.out, r, s.a);
      if (r == usable - 1 && p.last_z != nullptr) row_store(p.last_z, 0, s.a);
    } else {
      row_store(p.out, r, row_load(p.rand, r - usable));
    }
  }
};

// ---- the kernels: ticket 0 writes descriptor 0, the others a tile ----

template <bool kPasta>
__global__ void __launch_bounds__(kScanThreads) grand_den_kernel(const __grid_constant__ GrandParams p) {
  const MulOp<kPasta> op{p.k};
  const long long d = draw_ticket(p.lb[0]);
  if (d == 0) {
    if (threadIdx.x == 0) publish(p.lb[0], 0, kPrefix, op.identity());
    return;
  }
  DenRows<kPasta> rows{p};
  scan_tile<false, true>(op, rows, p.lb[0], d, p.n, p.tiles);
}

template <bool kPasta>
__global__ void __launch_bounds__(kScanThreads) grand_fraction_kernel(const __grid_constant__ GrandParams p) {
  using S = typename MulOp<kPasta>::S;
  const MulOp<kPasta> op{p.k};
  const long long d = draw_ticket(p.lb[1]);
  if (d == 0) {
    if (threadIdx.x == 0) {
      // the first launch's total: its last tile's inclusive prefix
      const S total = state_load<S>(p.lb[0].values + (2 * p.tiles + 1) * S::kWords);
      publish(p.lb[1], 0, kPrefix, S{fe_inverse_gcd<kPasta>(total.a, fe_from(p.r3), p.k)});
    }
    return;
  }
  FractionRows<kPasta> rows{p};
  scan_tile<true, true>(op, rows, p.lb[1], d, p.n, p.tiles);
}

template <bool kPasta>
__global__ void __launch_bounds__(kScanThreads) grand_z_kernel(const __grid_constant__ GrandParams p) {
  using S = typename MulOp<kPasta>::S;
  const MulOp<kPasta> op{p.k};
  const long long d = draw_ticket(p.lb[2]);
  if (d == 0) {
    if (threadIdx.x == 0) publish(p.lb[2], 0, kPrefix, p.init != nullptr ? S{row_load(p.init, 0)} : op.identity());
    return;
  }
  ZRows<kPasta> rows{p};
  scan_tile<false, true>(op, rows, p.lb[2], d, p.n, p.tiles);
}

template <bool kPasta>
void launch(const GrandParams& p, cudaStream_t s) {
  const unsigned blocks = (unsigned)(p.tiles + 1);
  grand_den_kernel<kPasta><<<blocks, kScanThreads, 0, s>>>(p);
  grand_fraction_kernel<kPasta><<<blocks, kScanThreads, 0, s>>>(p);
  grand_z_kernel<kPasta><<<blocks, kScanThreads, 0, s>>>(p);
}

}  // namespace

extern "C" int grand_tile_rows() { return kTileRows; }
extern "C" int grand_params_size() { return (int)sizeof(GrandParams); }

// One z column (kind 0: a lookup, 1: a permutation chunk of ncols
// columns). scratch: the words of three scans over n rows (ops/scan.py
// scratch_words(n, 3)), 16-byte aligned; their flags are zeroed here, on
// the stream, before the launches (one memset, not a kernel).
extern "C" int grand_product(const GrandParams* params, long long scratch_words, void* stream) {
  GrandParams p = *params;
  const long long tiles = scan_tiles(p.n);
  const bool ok_cols = p.kind == kLookup ? p.ncols == 4 : (p.kind == kPermutation && p.ncols >= 1 &&
                                                           p.ncols <= kMaxCols && p.omega != nullptr);
  if (!ok_cols || p.n <= 0 || p.blinding < 0 || p.blinding >= p.n || tiles + 1 > 0x7FFFFFFFLL ||
      scratch_words < 3 * lookback_words(tiles) || p.scratch == nullptr || p.out == nullptr ||
      p.den == nullptr || (p.blinding > 0 && p.rand == nullptr))
    return (int)cudaErrorInvalidValue;
  p.tiles = tiles;
  for (int i = 0; i < 3; ++i) p.lb[i] = lookback_at(p.scratch + i * lookback_words(tiles), tiles);
  cudaStream_t s = (cudaStream_t)stream;
  // the flags of all three scans in one memset (the states of the first
  // two between them are zeroed too)
  const cudaError_t err = cudaMemsetAsync(p.scratch, 0, 4 * (2 * lookback_words(tiles) + lookback_flag_words(tiles)), s);
  if (err != cudaSuccess) return (int)err;
  (pasta_form(p.k) ? launch<true> : launch<false>)(p, s);
  return (int)cudaGetLastError();
}
