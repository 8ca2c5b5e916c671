// Kernel C: prefix products and batch inversion over (n, 16) limb tensors.
//
// Replaces the device programs that XLA compiles from the JAX package's
// scans (halo2_tpu/ops/scan.py:27 prefix_product, a lax.associative_scan
// of Montgomery products; :35 exclusive_prefix_product with its `init`;
// :52 batch_invert, two scans and one Fermat inversion on the device). In
// the port they carry the grand products' z columns
// (plonk/lookup_prover.py _lookup_z, plonk/permutation_prover.py _perm_z,
// one chunk at a time with the previous chunk's last z as init) and
// FVec.invert.
//
// Each scan is one launch of the single-pass look-back scan of
// csrc/scan.cuh:
// - scan_kernel: the inclusive or exclusive prefix products, descriptor 0
//   the init row (or one);
// - batch inversion, two launches: invert_prefix_kernel, the exclusive
//   prefix products of the rows with each zero (the limbs 0 or p, as
//   ops/field.py is_zero) counted as one, written to out; then
//   invert_suffix_kernel, the same scan from the last row back, whose
//   descriptor 0 is the inverse of the first launch's total, so that a
//   row's prefix there is total^-1 times the rows after it; each row is
//   written as out[i] (the rows before it) times that, a zero as zero.
//   The block that draws ticket 0 of the second launch inverts the total
//   while the others scan their tiles; they wait for it only in their
//   look-back.
// The inverse is a binary GCD (fe_inverse_gcd, csrc/batch_invert.cuh): Bernstein and Yang's
// divsteps ("Fast constant-time gcd computation and modular inversion",
// 2019) in the form of libsecp256k1's modinv32: batches of 30 divsteps on
// the low 32 bits of f and g, each batch's 2x2 matrix applied to f, g and
// to d, e mod p on signed 30-bit limbs, at most 20 batches (600 divsteps;
// 590 suffice for inputs below 2^256), ending when g is 0. It inverts the
// total's canonical value x = a R, and one product by R^3 mod p turns
// (a R)^-1 into a^-1 R. ops/scan.py inverse_model is the same algorithm
// in Python integers.
//
// The products are fe_mul_cc<kPasta> (the Pasta form chosen on the host as
// kernel A does), so every output lies in the lazy domain [0, 2p) and
// equals the plain version (ops/scan.py, Hillis-Steele rounds of kernel A)
// as a value mod p, not always in its limbs: the association order differs.
//
// What bounds it on an H100: its products (about 3 a row here, 17 ps each
// in the Pasta form) and 128 bytes a row (one read, one write; 192 for the
// second launch of an inversion, which reads out back) are both about a
// microsecond or less at n = 2^14, so a call is bound by latency: the
// chain of products from the first row to the last. One launch keeps it to
// a run of kScanRows rows, the block scan's levels (log2 of its threads),
// the look-back's (5 a window of 32 tiles, and 2 to join a round's 4
// windows) and one product, where the three launches it replaces chained
// two launch gaps and a one-block walk over the run totals. Tiles of 256
// rows (2 rows a thread of 128) give the shortest chain at 2^14 rows, the
// main path's (`msm_ab.py --jit 8 --sweep`); at 2^17 the last of their 512
// tiles look back over up to 4 rounds of 128 descriptors. The inverse is about 200 passes of its divstep loop and 36 limb
// updates on one thread, where the Fermat ladder took 254 squarings and
// 127 products in series.
#include <cstdint>
#include <cuda_runtime.h>

#include "batch_invert.cuh"
#include "scan.cuh"

namespace {

struct ScanArgs {
  const int32_t* in;    // (n, 16)
  int32_t* out;         // (n, 16)
  const int32_t* init;  // (16,) or null
  Lookback lb;          // this launch's descriptors
  Lookback fwd;         // batch inversion's second launch: the first launch's descriptors
  long long n;
  long long tiles;      // T = ceil(n / kTileRows)
  Fe r3;                // R^3 mod p
};

// ---- the rows of each scan ----

// the rows as they are, each output the combination of the carry and the
// row's prefix within the tile
template <bool kPasta>
struct ProductRows {
  using S = typename MulOp<kPasta>::S;
  const int32_t* in;
  int32_t* out;
  const FieldConsts& k;
  __device__ S element(int, long long r) const { return S{row_load(in, r)}; }
  __device__ S prepare(int, const S& x) const { return x; }
  __device__ void emit(int, long long r, const S& s) const { row_store(out, r, s.a); }
};

// batch inversion's first launch: a zero counts as one
template <bool kPasta>
struct MaskedRows : ProductRows<kPasta> {
  using S = typename MulOp<kPasta>::S;
  __device__ S element(int, long long r) const {
    const Fe v = row_load(this->in, r);
    return S{fe_is_zero(v, this->k) ? fe_from(this->k.one) : v};
  }
};

// batch inversion's second launch: x, the rows after r (times the total's
// inverse, through the carry), meets out[r], the rows before r
template <bool kPasta>
struct InverseRows {
  using S = typename MulOp<kPasta>::S;
  const int32_t* in;
  int32_t* out;
  const FieldConsts& k;
  bool zero[kScanRows] = {};
  Fe pre[kScanRows] = {};
  __device__ S element(int j, long long r) {
    const Fe v = row_load(in, r);
    zero[j] = fe_is_zero(v, k);
    pre[j] = row_load(out, r);
    return S{zero[j] ? fe_from(k.one) : v};
  }
  __device__ S prepare(int j, const S& x) const { return S{fe_mul_cc<kPasta>(pre[j], x.a, k)}; }
  __device__ void emit(int j, long long r, const S& s) const { row_store(out, r, zero[j] ? fe_zero() : s.a); }
};

// ---- the kernels: ticket 0 writes descriptor 0, the others a tile ----

template <bool kPasta, bool kExclusive>
__global__ void __launch_bounds__(kScanThreads) scan_kernel(ScanArgs g, FieldConsts k) {
  const MulOp<kPasta> op{k};
  using S = typename MulOp<kPasta>::S;
  const long long d = draw_ticket(g.lb);
  if (d == 0) {
    if (threadIdx.x == 0) publish(g.lb, 0, kPrefix, g.init != nullptr ? S{row_load(g.init, 0)} : op.identity());
    return;
  }
  ProductRows<kPasta> rows{g.in, g.out, k};
  scan_tile<false, kExclusive>(op, rows, g.lb, d, g.n, g.tiles);
}

template <bool kPasta>
__global__ void __launch_bounds__(kScanThreads) invert_prefix_kernel(ScanArgs g, FieldConsts k) {
  const MulOp<kPasta> op{k};
  const long long d = draw_ticket(g.lb);
  if (d == 0) {
    if (threadIdx.x == 0) publish(g.lb, 0, kPrefix, op.identity());
    return;
  }
  MaskedRows<kPasta> rows{{g.in, g.out, k}};
  scan_tile<false, true>(op, rows, g.lb, d, g.n, g.tiles);
}

template <bool kPasta>
__global__ void __launch_bounds__(kScanThreads) invert_suffix_kernel(ScanArgs g, FieldConsts k) {
  using S = typename MulOp<kPasta>::S;
  const MulOp<kPasta> op{k};
  const long long d = draw_ticket(g.lb);
  if (d == 0) {
    if (threadIdx.x == 0) {
      // the first launch's total: the last tile's inclusive prefix
      const S total = state_load<S>(g.fwd.values + (2 * g.tiles + 1) * S::kWords);
      publish(g.lb, 0, kPrefix, S{fe_inverse_gcd<kPasta>(total.a, g.r3, k)});
    }
    return;
  }
  InverseRows<kPasta> rows{g.in, g.out, k};
  scan_tile<true, true>(op, rows, g.lb, d, g.n, g.tiles);
}

template <bool kPasta>
void launch(int mode, ScanArgs g, const FieldConsts& k, cudaStream_t s) {
  const unsigned blocks = (unsigned)(g.tiles + 1);
  if (mode == 0) {
    scan_kernel<kPasta, false><<<blocks, kScanThreads, 0, s>>>(g, k);
  } else if (mode == 1) {
    scan_kernel<kPasta, true><<<blocks, kScanThreads, 0, s>>>(g, k);
  } else {
    invert_prefix_kernel<kPasta><<<blocks, kScanThreads, 0, s>>>(g, k);
    g.fwd = g.lb;
    g.lb = lookback_at(reinterpret_cast<int32_t*>(g.lb.words) + lookback_words(g.tiles), g.tiles);
    invert_suffix_kernel<kPasta><<<blocks, kScanThreads, 0, s>>>(g, k);
  }
}

}  // namespace

extern "C" int scan_tile_rows() { return kTileRows; }

// mode 0: inclusive prefix products, 1: exclusive (times init, when init is
// not null), 2: batch inversion. scratch: the words of one scan, two for
// mode 2 (ops/scan.py scratch_words), 16-byte aligned; its
// flags are zeroed here, on the stream, before the launch (a memset, not a
// kernel). r3: R^3 mod p as 8 words (batch inversion).
extern "C" int scan_rows(int mode, const int32_t* in, int32_t* out, int32_t* scratch, long long scratch_words,
                         const int32_t* init, long long n, const uint32_t* r3, const FieldConsts* consts,
                         void* stream) {
  const long long tiles = scan_tiles(n);
  if (mode < 0 || mode > 2 || n <= 0 || tiles + 1 > 0x7FFFFFFFLL ||
      scratch_words < (mode == 2 ? 2 : 1) * lookback_words(tiles))
    return (int)cudaErrorInvalidValue;
  ScanArgs g{in, out, init, lookback_at(scratch, tiles), {}, n, tiles, {}};
  for (int i = 0; i < 8; ++i) g.r3.v[i] = r3[i];
  cudaStream_t s = (cudaStream_t)stream;
  // the flags of both scans of an inversion in one memset (the first
  // scan's states between them are zeroed too)
  const long long zeroed = (mode == 2 ? lookback_words(tiles) : 0) + lookback_flag_words(tiles);
  const cudaError_t err = cudaMemsetAsync(scratch, 0, 4 * zeroed, s);
  if (err != cudaSuccess) return (int)err;
  const FieldConsts& k = *consts;
  (pasta_form(k) ? launch<true> : launch<false>)(mode, g, k, s);
  return (int)cudaGetLastError();
}
