// Kernel G: every z column of a proof's grand products, the lookups' and
// each permutation chunk's, over (n, 16) limb tensors, in one call.
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
// random rows, and last_z = z[u], u = n - blinding - 1, the next chunk's
// init. Only the rows before u reach the z rows, so the scans run over
// those U = u rows.
//
// A call is two launches of the single-pass look-back scan of csrc/scan.cuh
// over every column's tiles (one ticket counter a launch, the tiles drawn
// column by column, so a block waits only on tickets drawn before it; each
// column has its own descriptors) and one memset of both launches' flags:
// - grand_forward_kernel: a row's numerator and denominator formed from the
//   columns, num'_i = num_i and den'_i = den_i, or 0 and 1 where den_i is a
//   zero; the exclusive prefix products of the pairs (num', den'), P and Q,
//   a pair state of 16 words whose two products are independent. It writes
//   P_{<i} to z's row i and den'_i to a scratch column; its ticket-0 block
//   publishes every column's descriptor 0 and copies the random rows.
// - grand_backward_kernel: its ticket-0 block (start_columns) reads each
//   column's totals P_{<u} and Q_{<u} (the forward scan's last inclusive
//   prefix), inverts Q_{<u} by the binary GCD of csrc/batch_invert.cuh, one
//   column a lane of warp 0, chains each circuit's chunks (init_{c+1} =
//   init_c P_{<u} Q_{<u}^-1, chunk c's last z), writes row u and last_z,
//   and publishes each column's descriptor 0 as init_c Q_{<u}^-1. The other
//   blocks scan den' from row u - 1 back, inclusive, so that a row's prefix
//   times the carry is init_c Q_{<i}^-1, and write z_i = that P_{<i}.
//
// The columns, sigma columns, powers of omega, random rows, inits and
// outputs reach the kernels as pointers in their __grid_constant__
// parameters, beta, gamma and each chunk's beta delta^(base + j) as values
// there (GrandParams, under 4 KB: up to kMaxZ z columns of kMaxSlots
// columns in all; ops/grand_product.py splits a larger call), so a call
// stacks, concatenates and copies nothing and reads nothing back.
//
// The products are fe_mul_cc<kPasta> (the Pasta form chosen on the host as
// kernel A does, the generic form for BN254's scalar field on the KZG
// path), so every output lies in the lazy domain [0, 2p) and equals the
// plain versions (ops/grand_product.py: the JAX programs' order of
// operations on kernels A and C) as a value mod p, not always in its limbs.
//
// What bounds it on an H100: its bytes (the columns read once and z
// written once: (2 ncols + 2) x 64 bytes a row for a permutation chunk
// with its powers of omega, 5 x 64 for a lookup) and its products (a row's
// terms, 4 ncols - 2 for a chunk and 2 for a lookup, and four of the scans:
// P, Q, the backward suffix and z) are a few microseconds at n = 2^14 at
// most, so a call is bound by latency: two scans' chains (a run of two
// rows, the block's levels and the look-back, the forward one on pairs),
// the rows' products before the first, and the inverses on one warp
// between them. Where the z columns were a call each, three launches and a
// memset a column, a proof's columns now share both chains.
#include <cstdint>
#include <cuda_runtime.h>

#include "batch_invert.cuh"
#include "scan.cuh"

namespace {

constexpr int kMaxZ = 16;      // z columns a launch (at most a warp's lanes)
constexpr int kMaxSlots = 48;  // their columns: a lookup's four, a chunk's ncols
enum Kind { kLookup = 0, kPermutation = 1 };

}  // namespace

// One z column (mirrored by ops/grand_product.py's ZColumn).
struct ZColumn {
  const int32_t* rand;  // (blinding, 16)
  const int32_t* init;  // (16,), or null for one; read where chain is 0
  int32_t* out;         // (n, 16): z
  int32_t* last_z;      // (16,), or null
  int kind;
  int ncols;
  int first;  // its columns are cols[first .. first + ncols), and sigmas, dpows alike
  int chain;  // 1: its init is the column before's last z (a chunk after a chunk)
};

// The launches' parameters (mirrored by ops/grand_product.py's GrandParams;
// the entry point fills in tiles).
struct GrandParams {
  const int32_t* cols[kMaxSlots];    // (n, 16) each; a lookup's a, s, a', s'
  const int32_t* sigmas[kMaxSlots];  // (n, 16) each, a chunk's
  const int32_t* omega;              // (n, 16): omega^i (where a chunk is)
  int32_t* scratch;                  // grand_scratch_words(n, blinding, nz) words
  ZColumn z[kMaxZ];
  long long n;
  long long tiles;  // row tiles of a column's U = n - blinding - 1 rows
  int nz;
  int blinding;
  uint32_t beta[8], gamma[8];       // Montgomery words
  uint32_t dpows[kMaxSlots][8];     // beta delta^(base + j)
  uint32_t r3[8];                   // R^3 mod p
  FieldConsts k;
};
static_assert(sizeof(GrandParams) <= 4096, "a kernel's parameters fit 4 KB");

namespace {

constexpr int kPairWords = 16;  // the forward scan's state, (P, Q); the backward
                                // scan's and a den' row are kStateWords

// The scratch of a call over nz columns, each scanning U rows in T tiles:
// the forward launch's flags (the ticket counter, then T + 1 flags a
// column), the backward launch's alike (both zeroed by the call's memset),
// the forward descriptors' pair states, the backward ones' states, and a
// column of U den' rows (8 words each) a column.
__host__ __device__ inline long long flag_words(long long tiles, int nz) { return (1 + nz * (tiles + 1) + 3) / 4 * 4; }
inline long long scratch_words(long long rows, long long tiles, int nz) {
  return 2 * flag_words(tiles, nz) + nz * (tiles + 1) * 2 * (kPairWords + kStateWords) + nz * rows * kStateWords;
}

__device__ __forceinline__ long long rows_scanned(const GrandParams& p) { return p.n - p.blinding - 1; }

// column c's descriptors in each launch (words[0] of column 0's is the
// launch's ticket counter), and its den' rows
__device__ __forceinline__ Lookback forward_lb(const GrandParams& p, int c) {
  uint32_t* w = reinterpret_cast<uint32_t*>(p.scratch);
  const long long t1 = p.tiles + 1, f = flag_words(p.tiles, p.nz);
  return Lookback{w + c * t1, w + 2 * f + c * t1 * 2 * kPairWords};
}

__device__ __forceinline__ Lookback backward_lb(const GrandParams& p, int c) {
  uint32_t* w = reinterpret_cast<uint32_t*>(p.scratch);
  const long long t1 = p.tiles + 1, f = flag_words(p.tiles, p.nz);
  return Lookback{w + f + c * t1, w + 2 * f + p.nz * t1 * 2 * kPairWords + c * t1 * 2 * kStateWords};
}

__device__ __forceinline__ uint32_t* den_rows(const GrandParams& p, int c) {
  uint32_t* w = reinterpret_cast<uint32_t*>(p.scratch);
  const long long t1 = p.tiles + 1;
  return w + 2 * flag_words(p.tiles, p.nz) + p.nz * t1 * 2 * (kPairWords + kStateWords) + c * rows_scanned(p) * kStateWords;
}

// the products of (num', den') pairs
template <bool kPasta>
struct PairOp {
  struct S {
    static constexpr int kWords = kPairWords;
    Fe p, q;
  };
  using Pw = NoPow;
  FieldConsts k;
  __device__ S identity() const { return S{fe_from(k.one), fe_from(k.one)}; }
  __device__ S combine(const S& x, const S& y, const Pw&) const {
    return S{fe_mul_cc<kPasta>(x.p, y.p, k), fe_mul_cc<kPasta>(x.q, y.q, k)};
  }
  __device__ Pw pow2(int) const { return {}; }
  __device__ Pw lane_pow(int) const { return {}; }
  __device__ Pw warp_pow(int) const { return {}; }
  __device__ Pw row_pow(int) const { return {}; }
  __device__ Pw pw_mul(const Pw&, const Pw&) const { return {}; }
};

// row r's denominator of column z
template <bool kPasta>
__device__ __forceinline__ Fe den_row(const GrandParams& p, const ZColumn& z, long long r) {
  const FieldConsts& k = p.k;
  const Fe beta = fe_from(p.beta), gamma = fe_from(p.gamma);
  const int f = z.first;
  if (z.kind == kLookup)
    return fe_mul_cc<kPasta>(fe_add_cc(row_load(p.cols[f + 2], r), beta, k),
                             fe_add_cc(row_load(p.cols[f + 3], r), gamma, k), k);
  Fe acc;
#pragma unroll 1
  for (int j = 0; j < z.ncols; ++j) {
    const Fe bs = fe_mul_cc<kPasta>(row_load(p.sigmas[f + j], r), beta, k);
    const Fe t = fe_add_cc(fe_add_cc(row_load(p.cols[f + j], r), bs, k), gamma, k);
    acc = j == 0 ? t : fe_mul_cc<kPasta>(acc, t, k);
  }
  return acc;
}

// row r's numerator of column z
template <bool kPasta>
__device__ __forceinline__ Fe num_row(const GrandParams& p, const ZColumn& z, long long r) {
  const FieldConsts& k = p.k;
  const Fe beta = fe_from(p.beta), gamma = fe_from(p.gamma);
  const int f = z.first;
  if (z.kind == kLookup)
    return fe_mul_cc<kPasta>(fe_add_cc(row_load(p.cols[f], r), beta, k),
                             fe_add_cc(row_load(p.cols[f + 1], r), gamma, k), k);
  const Fe w = row_load(p.omega, r);
  Fe acc;
#pragma unroll 1
  for (int j = 0; j < z.ncols; ++j) {
    const Fe wd = fe_mul_cc<kPasta>(w, fe_from(p.dpows[f + j]), k);
    const Fe t = fe_add_cc(fe_add_cc(row_load(p.cols[f + j], r), wd, k), gamma, k);
    acc = j == 0 ? t : fe_mul_cc<kPasta>(acc, t, k);
  }
  return acc;
}

// the forward launch's rows of a column: (num', den'), den' kept in the
// scratch column; z's row r takes P_{<r}
template <bool kPasta>
struct ForwardRows {
  using S = typename PairOp<kPasta>::S;
  const GrandParams& p;
  const ZColumn& z;
  uint32_t* den;
  __device__ S element(int, long long r) const {
    const Fe d = den_row<kPasta>(p, z, r), num = num_row<kPasta>(p, z, r);
    const bool zero = fe_is_zero(d, p.k);
    const Fe dd = zero ? fe_from(p.k.one) : d;
    fe_store_words(den + kStateWords * r, dd);
    return S{zero ? fe_zero() : num, dd};
  }
  __device__ S prepare(int, const S& x) const { return x; }
  __device__ void emit(int, long long r, const S& s) const { row_store(z.out, r, s.p); }
};

// the backward launch's rows, from row U - 1 back: x, den' of the rows
// from r on (within the tile), meets P_{<r} before the carry, init
// Q_{<u}^-1 times den' of the later tiles
template <bool kPasta>
struct BackwardRows {
  using S = typename MulOp<kPasta>::S;
  const FieldConsts& k;
  int32_t* out;
  const uint32_t* den;
  Fe pre[kScanRows] = {};
  __device__ S element(int j, long long r) {
    pre[j] = row_load(out, r);
    return S{fe_load_words_cg(den + kStateWords * r)};
  }
  __device__ S prepare(int j, const S& x) const { return S{fe_mul_cc<kPasta>(pre[j], x.a, k)}; }
  __device__ void emit(int, long long r, const S& s) const { row_store(out, r, s.a); }
};

// The backward launch's ticket-0 block: each column's inverse of Q_{<u},
// the chunks' inits along each chain, row u, last_z and descriptor 0.
template <bool kPasta>
__device__ __forceinline__ void start_columns(const GrandParams& p) {
  using P = typename PairOp<kPasta>::S;
  using S = typename MulOp<kPasta>::S;
  __shared__ Fe inv[kMaxZ], step[kMaxZ], init[kMaxZ];
  const FieldConsts& k = p.k;
  const int c = threadIdx.x;
  const Fe one = fe_from(k.one), r3 = fe_from(p.r3);
  // the forward scan's last inclusive prefix (descriptor 0's where it
  // scanned no tile): (P_{<u}, Q_{<u})
  P total{};
  if (c < p.nz) total = state_load<P>(forward_lb(p, c).values + (2 * p.tiles + 1) * P::kWords);
  if (c < p.nz) {  // one inverse a lane, the lanes of warp 0 side by side
    inv[c] = fe_inverse_gcd<kPasta>(total.q, r3, k);
    step[c] = fe_mul_cc<kPasta>(total.p, inv[c], k);  // z[u] / init
  }
  __syncthreads();
  // each chain of chunks in one thread, from its first column's init
  if (c < p.nz && !p.z[c].chain) {
    Fe cur = p.z[c].init != nullptr ? row_load(p.z[c].init, 0) : one;
    for (int e = c;;) {
      init[e] = cur;
      if (++e == p.nz || !p.z[e].chain) break;
      cur = fe_mul_cc<kPasta>(cur, step[e - 1], k);
    }
  }
  __syncthreads();
  if (c < p.nz) {
    const ZColumn& z = p.z[c];
    publish(backward_lb(p, c), 0, kPrefix, S{fe_mul_cc<kPasta>(init[c], inv[c], k)});
    const Fe zu = fe_mul_cc<kPasta>(init[c], step[c], k);
    row_store(z.out, rows_scanned(p), zu);
    if (z.last_z != nullptr) row_store(z.last_z, 0, zu);
  }
}

// ---- the kernels: ticket 0 starts every column, the others a tile ----

template <bool kPasta>
__global__ void __launch_bounds__(kScanThreads) grand_forward_kernel(const __grid_constant__ GrandParams p) {
  const PairOp<kPasta> op{p.k};
  const long long d = draw_ticket(forward_lb(p, 0));
  if (d == 0) {
    if (threadIdx.x < p.nz) publish(forward_lb(p, threadIdx.x), 0, kPrefix, op.identity());
    const long long usable = p.n - p.blinding;
    for (long long i = threadIdx.x; i < (long long)p.nz * p.blinding; i += blockDim.x) {
      const ZColumn& z = p.z[i / p.blinding];
      row_store(z.out, usable + i % p.blinding, row_load(z.rand, i % p.blinding));
    }
    return;
  }
  const int c = (int)((d - 1) / p.tiles);
  ForwardRows<kPasta> rows{p, p.z[c], den_rows(p, c)};
  scan_tile<false, true>(op, rows, forward_lb(p, c), (d - 1) % p.tiles + 1, rows_scanned(p), p.tiles);
}

template <bool kPasta>
__global__ void __launch_bounds__(kScanThreads) grand_backward_kernel(const __grid_constant__ GrandParams p) {
  const MulOp<kPasta> op{p.k};
  const long long d = draw_ticket(backward_lb(p, 0));
  if (d == 0) {
    start_columns<kPasta>(p);
    return;
  }
  const int c = (int)((d - 1) / p.tiles);
  BackwardRows<kPasta> rows{p.k, p.z[c].out, den_rows(p, c)};
  scan_tile<true, false>(op, rows, backward_lb(p, c), (d - 1) % p.tiles + 1, rows_scanned(p), p.tiles);
}

template <bool kPasta>
void launch(const GrandParams& p, unsigned blocks, cudaStream_t s) {
  grand_forward_kernel<kPasta><<<blocks, kScanThreads, 0, s>>>(p);
  grand_backward_kernel<kPasta><<<blocks, kScanThreads, 0, s>>>(p);
}

bool column_ok(const GrandParams& p, int c) {
  const ZColumn& z = p.z[c];
  if (z.out == nullptr || (p.blinding > 0 && z.rand == nullptr) || z.first < 0 || z.ncols < 1 ||
      z.first + z.ncols > kMaxSlots)
    return false;
  if (z.kind == kLookup) return z.ncols == 4 && !z.chain && z.last_z == nullptr;
  if (z.kind != kPermutation || p.omega == nullptr) return false;
  return !z.chain || (c > 0 && p.z[c - 1].kind == kPermutation);
}

}  // namespace

extern "C" int grand_tile_rows() { return kTileRows; }
extern "C" int grand_params_size() { return (int)sizeof(GrandParams); }
extern "C" long long grand_scratch_words(long long n, int blinding, int nz) {
  const long long rows = n - blinding - 1;
  return scratch_words(rows, scan_tiles(rows), nz);
}

// Every z column of params (nz of them: each circuit's chunks in order,
// then the lookups). scratch: grand_scratch_words(n, blinding, nz) words,
// 16-byte aligned; both launches' flags are zeroed here, on the stream,
// before the launches (one memset, not a kernel).
extern "C" int grand_product(const GrandParams* params, long long scratch_words_given, void* stream) {
  GrandParams p = *params;
  if (p.nz < 1 || p.nz > kMaxZ || p.n <= 0 || p.blinding < 0 || p.blinding >= p.n || p.scratch == nullptr ||
      scratch_words_given < grand_scratch_words(p.n, p.blinding, p.nz))
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < p.nz; ++c)
    if (!column_ok(p, c)) return (int)cudaErrorInvalidValue;
  p.tiles = scan_tiles(p.n - p.blinding - 1);
  const long long blocks = 1 + p.nz * p.tiles;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(p.scratch, 0, 4 * 2 * flag_words(p.tiles, p.nz), s);
  if (err != cudaSuccess) return (int)err;
  (pasta_form(p.k) ? launch<true> : launch<false>)(p, (unsigned)blocks, s);
  return (int)cudaGetLastError();
}
