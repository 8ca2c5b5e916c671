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
// IPA opening's b. A launch takes by value, in its parameters, each point's
// L squares x^(2^e) (L the bits of n - 1; ops/polyeval.py squares_words
// builds them on the host) and the polynomials grouped by point, so a call
// copies nothing to the card; a point on the card (device_powers) gets its
// squares from one thread's chain of squarings instead. From the squares a
// block forms x^d and x^(16 d) for d < 16 and d < 8, and the powers of
// its row blocks' first rows, in shared memory at once (4 products deep,
// row_powers), and x^r is two products more.
// - eval_kernel: one launch. A block per (row block, point) of kEvalThreads
//   threads in G groups (G = 1, 2 or 4): a thread takes kRows rows (1, 2
//   or 4) at a stride of kEvalThreads / G, so that a warp's loads cover
//   consecutive rows; each group forms the rows' powers and applies them
//   to its share of the polynomials at the block's point, kChunk at a
//   time. A thread's products run one after another (each carry chain is
//   a run of volatile PTX), so the wrapper picks G and kRows from the
//   shape to keep that run, kRows (1 + M_q / G) products, short. The block
//   sums each polynomial's warp sums (shuffles) into a partial; the block
//   that finishes last (a ticket from a completion counter, scan.cuh
//   last_block) sums the partials of every polynomial with four loads in
//   flight a thread, writes the M evaluations and sets the counter back to
//   0: no second launch and no memset.
// - powers_kernel: the same rows' powers, written out (Q, n, 16), of host
//   points (point_powers) or of points on the card (device_powers).
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
// Pasta form) and its G Q n products of powers against 64 M n bytes of
// coefficients (19 ps a row at 3.35 TB/s): bytes, barely, and at the
// paths' shapes (n = 2^11 .. 2^17, M = 1 .. 8) a few microseconds of
// either. In practice a chain of latencies: the block's powers (4
// products, then 2), a thread's run of products with the coefficients,
// the warp's five shuffle levels, the ticket and the last block's sums;
// one launch. Kernel E's products (about 3 a row
// here) and 128 bytes a row are about a microsecond at n = 2^14; it is
// bound by the latency of its chain of combines: a run of kScanRows, the
// block scan's levels, the look-back's (5 a window of 32 tiles, and a level
// a doubling of the windows of a round) and one more, each a product and a
// sum. Neither needs a round trip to the host.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

constexpr int kEvalThreads = 128;
constexpr int kEvalWarps = kEvalThreads / 32;
constexpr int kChunk = 4;        // polynomials a warp sums at once
constexpr int kMaxBits = 29;     // L, the bits of a row index, at most
constexpr int kBaseWindows = 8;  // 3-bit windows of a row block's first row above the span's bits
constexpr int kTableFe = 96;     // the launch's squares x_q^(2^e), by value, over its points
constexpr int kMaxSlots = 256;   // the launch's polynomials grouped by point, then Q + 1 starts
static_assert(kEvalWarps >= 3, "a warp each for x^d, x^(16 d) and the row blocks' first powers");

struct EvalArgs {
  const int32_t* coeffs;  // (*, n, 16) the call's stack; unused in powers mode
  const int32_t* x;       // (Q, 16) points on the card, or null: the squares below
  uint32_t* partial;      // (M, blocks, 8) words, a row a slot
  uint32_t* counter;      // the completion counter, 0 between launches
  int32_t* out;           // (*, 16) evaluations, a row a polynomial, or (Q, n, 16) powers
  long long n;
  int M;                  // the launch's polynomials (0: powers mode)
  int L;                  // bits of a row index
  int blocks;             // row blocks a point
  int poly_groups;        // G: the block's threads in G groups, each on its share of the polynomials
  uint16_t slot[kMaxSlots];  // the polynomials grouped by point, then point q's first slot (M last)
  Fe sq[kTableFe];           // x_q^(2^e) at q L + e, Montgomery form
};

// a launch's parameters, with the field's constants, within 4 KB
static_assert(sizeof(EvalArgs) + sizeof(FieldConsts) <= 4096, "kernel D's parameters");

struct PowScratch {
  Fe sq[32];    // x^(2^e), e < L; one above
  Fe lo[16];    // x^d
  Fe mid[8];    // x^(16 d)
  Fe base[4];   // x^(b_i), b_i the first row of the block's i-th span
};

// The product of sq[at + j] over the set bits j < nb of `bits` (one where
// none is set): nb - 1 products at most.
template <bool kPasta>
__device__ __forceinline__ Fe bits_product(const Fe* sq, int at, int bits, int nb, const FieldConsts& k) {
  Fe acc = fe_from(k.one);
  bool any = false;
  for (int j = 0; j < nb; ++j)
    if ((bits >> j) & 1) {
      acc = any ? fe_mul_cc<kPasta>(acc, sq[at + j], k) : sq[at + j];
      any = true;
    }
  return acc;
}

// x_q^r of rows r[i] = b_i + t, b_i = (blockIdx.x kRows + i) 2^lg, for t <
// 2^lg (the span): every thread of the block calls it, and pw is right in
// those with t < 2^lg. The squares come from the launch's parameters or, for
// a point on the card, from one thread's chain of squarings; then, at once,
// warp 0 forms x^d and warp 1 x^(16 d) from the squares' bits, and warp 2
// each b_i's power from its 3-bit windows (a lane a window, then a tree of
// shuffles); then x^t = x^(t mod 16) x^(16 floor(t / 16)) and x^r = x^t x^(b_i).
// A thread's chain: 4 products, then 1 + kRows.
template <bool kPasta, int kRows>
__device__ __forceinline__ void row_powers(const EvalArgs& g, int q, int lg, int t, long long (&r)[kRows],
                                           Fe (&pw)[kRows], PowScratch& s, const FieldConsts& k) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (g.x == nullptr) {  // a word a thread: the parameters' distinct addresses are read one after another
    for (int f = threadIdx.x; f < 32 * 8; f += blockDim.x) {
      const int e = f >> 3, j = f & 7;
      s.sq[e].v[j] = e < g.L ? g.sq[q * g.L + e].v[j] : k.one[j];
    }
  } else if (threadIdx.x == 0) {
    Fe w = row_load(g.x, q);
    for (int e = 0; e < 32; ++e) {
      s.sq[e] = e < g.L ? w : fe_from(k.one);
      if (e + 1 < g.L) w = fe_mul_cc<kPasta>(w, w, k);
    }
  }
  __syncthreads();
  if (warp == 0 && lane < 16) {
    s.lo[lane] = bits_product<kPasta>(s.sq, 0, lane, 4, k);
  } else if (warp == 1 && lane < 8) {
    s.mid[lane] = bits_product<kPasta>(s.sq, 4, lane, 3, k);
  } else if (warp == 2 && lane < kBaseWindows * kRows) {
    const int i = lane / kBaseWindows, w = lane % kBaseWindows, at = lg + 3 * w;
    const long long b = ((long long)blockIdx.x * kRows + i) << lg;
    Fe v = bits_product<kPasta>(s.sq, at, (int)((b >> at) & 7), 3, k);  // at + 2 <= 30
    const unsigned mask = kBaseWindows * kRows == 32 ? 0xffffffffu : (1u << (kBaseWindows * kRows)) - 1;
    const int windows = g.L > lg ? (g.L - lg + 2) / 3 : 1;  // the same for the whole warp
    for (int d = 1; d < windows; d <<= 1) {
      Fe o;
#pragma unroll
      for (int j = 0; j < 8; ++j) o.v[j] = __shfl_xor_sync(mask, v.v[j], d);
      v = fe_mul_cc<kPasta>(v, o, k);
    }
    if (w == 0) s.base[i] = v;
  }
  __syncthreads();
  const Fe xt = fe_mul_cc<kPasta>(s.lo[t & 15], s.mid[(t >> 4) & 7], k);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    r[i] = (((long long)blockIdx.x * kRows + i) << lg) + t;
    pw[i] = fe_mul_cc<kPasta>(xt, s.base[i], k);
  }
}

// A block covers kRows * span rows of point blockIdx.y, span =
// kEvalThreads / G: each group of span threads forms the rows' powers (the
// groups at once), and group j takes the point's polynomials j, j + G, ...,
// kChunk at a time, so that a thread's run of products (one after another)
// is 1 + kRows (1 + ceil(M_q / G)) long after the block's 4. The block sums
// each polynomial's warp sums into one partial; the last block adds the
// partials up.
template <bool kPasta, int kRows>
__global__ void __launch_bounds__(kEvalThreads) eval_kernel(const __grid_constant__ EvalArgs g, FieldConsts k) {
  __shared__ PowScratch ps;
  __shared__ Fe sh[kChunk][kEvalWarps];
  const int q = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = g.poly_groups, span = kEvalThreads / G, wpg = span / 32, lg = 31 - __clz(span);
  const int grp = threadIdx.x / span, t = threadIdx.x % span;  // grp is the same for a whole warp
  const int begin = g.slot[g.M + q], count = g.slot[g.M + q + 1] - begin;
  const int per_group = (count + G - 1) / G;  // the same for the whole block
  long long r[kRows];
  Fe pw[kRows];
  row_powers<kPasta, kRows>(g, q, lg, t, r, pw, ps, k);
  for (int c0 = 0; c0 < per_group; c0 += kChunk) {
    Fe acc[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      acc[c] = fe_zero();
      const int pos = grp + G * (c0 + c);  // the polynomial's place at the point
      if (c0 + c < per_group && pos < count) {
        const int32_t* cm = g.coeffs + (long long)g.slot[begin + pos] * g.n * 16;
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          if (r[i] < g.n) acc[c] = fe_add_cc(acc[c], fe_mul_cc<kPasta>(row_load(cm, r[i]), pw[i], k), k);
      }
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (c0 + c < per_group) {  // the same for the whole block
        acc[c] = warp_sum(acc[c], k);
        if (lane == 0) sh[c][warp] = acc[c];
      }
    }
    __syncthreads();
    if (threadIdx.x < G * kChunk) {  // thread (group j, chunk place c) sums group j's warps
      const int j = threadIdx.x / kChunk, c = threadIdx.x % kChunk, pos = j + G * (c0 + c);
      if (c0 + c < per_group && pos < count) {
        Fe v = sh[c][j * wpg];
        for (int w = 1; w < wpg; ++w) v = fe_add_cc(v, sh[c][j * wpg + w], k);
        fe_store_words(g.partial + ((long long)(begin + pos) * g.blocks + blockIdx.x) * 8, v);
      }
    }
    __syncthreads();  // sh is written again
  }
  if (!last_block(g.counter, threadIdx.x < G * kChunk)) return;
  // the last block: each slot's partials, over the whole block while there
  // are fewer slots than warps, else a warp a slot
  if (g.M < kEvalWarps) {
    __shared__ Fe red[32];
    for (int m = 0; m < g.M; ++m) {
      const Fe v = block_sum_words(g.partial + (long long)m * g.blocks * 8, g.blocks, red, k);
      if (threadIdx.x == 0) row_store(g.out, g.slot[m], v);
    }
  } else {
    for (int m = warp; m < g.M; m += kEvalWarps) {
      const Fe v = sum_words(g.partial + (long long)m * g.blocks * 8, g.blocks, lane, 32, k);
      if (lane == 0) row_store(g.out, g.slot[m], v);
    }
  }
}

// The powers x_q^r, a row r of point blockIdx.y for each of a thread's kRows.
template <bool kPasta, int kRows>
__global__ void __launch_bounds__(kEvalThreads) powers_kernel(const __grid_constant__ EvalArgs g, FieldConsts k) {
  __shared__ PowScratch ps;
  const int q = blockIdx.y;
  long long r[kRows];
  Fe pw[kRows];
  row_powers<kPasta, kRows>(g, q, 31 - __clz(kEvalThreads), threadIdx.x, r, pw, ps, k);
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (r[i] < g.n) row_store(g.out, (long long)q * g.n + r[i], pw[i]);
}

template <bool kPasta, int kRows>
int eval_launch_rows(const EvalArgs& g, int Q, const FieldConsts& k, cudaStream_t s) {
  const dim3 grid((unsigned)g.blocks, (unsigned)Q);
  if (g.M == 0)
    powers_kernel<kPasta, kRows><<<grid, kEvalThreads, 0, s>>>(g, k);
  else
    eval_kernel<kPasta, kRows><<<grid, kEvalThreads, 0, s>>>(g, k);
  return (int)cudaGetLastError();
}

template <bool kPasta>
int eval_launch_form(int rows, const EvalArgs& g, int Q, const FieldConsts& k, cudaStream_t s) {
  switch (rows) {
    case 1: return eval_launch_rows<kPasta, 1>(g, Q, k, s);
    case 2: return eval_launch_rows<kPasta, 2>(g, Q, k, s);
    case 4: return eval_launch_rows<kPasta, 4>(g, Q, k, s);
  }
  return (int)cudaErrorInvalidValue;
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

extern "C" int polyeval_tile_rows() { return kTileRows; }
// Fe entries of kernel E's table of b's powers.
extern "C" int kate_table_entries() { return (int)(sizeof(KateTable) / sizeof(Fe)); }

// One launch of kernel D over Q points, L bits covering every row index
// below n, rows a thread 1, 2 or 4, blocks = ceil(n / (rows * kEvalThreads
// / G)) row blocks a point.
// M > 0: the evaluations of M polynomials of coeffs (*, n, 16) into their
// rows of out (*, 16); slots (M + Q + 1 < kMaxSlots) the polynomials'
// indices grouped by point, then each point's first slot (M last);
// poly_groups G (a power of two, kEvalThreads / G >= 32) groups of threads a
// block; partial (M, blocks, 8) words of scratch; counter one word, 0 (the
// last block sets it back to 0); squares (Q L <= kTableFe values of 8 words,
// x_q^(2^e) in Montgomery form, on the host), copied into the launch's
// parameters with the slots.
// M = 0: out (Q, n, 16) = x_q^i, of the host squares or (x not null) of the
// points x (Q, 16) on the card; G taken as 1, coeffs, slots, partial and
// counter unused.
extern "C" int batch_eval(int rows, int poly_groups, const int32_t* coeffs, const int32_t* x, const uint16_t* slots,
                          const uint32_t* squares, uint32_t* partial, uint32_t* counter, int32_t* out, long long n,
                          int M, int Q, int L, int blocks, const FieldConsts* consts, void* stream) {
  const int G = M == 0 ? 1 : poly_groups;
  const long long per_block = (long long)rows * (kEvalThreads / (G > 0 ? G : 1));
  if (n <= 0 || Q <= 0 || Q > 65535 || M < 0 || M + Q + 1 > kMaxSlots || L <= 0 || L > kMaxBits ||
      (1LL << L) < n || (x == nullptr && (long long)Q * L > kTableFe) || G <= 0 || (G & (G - 1)) ||
      kEvalThreads / G < 32 || blocks != (n + per_block - 1) / per_block)
    return (int)cudaErrorInvalidValue;
  EvalArgs g{coeffs, x, partial, counter, out, n, M, L, blocks, G, {}, {}};
  if (M > 0) memcpy(g.slot, slots, sizeof(uint16_t) * (M + Q + 1));
  if (x == nullptr) memcpy(g.sq, squares, sizeof(Fe) * Q * L);
  const FieldConsts& k = *consts;
  cudaStream_t s = (cudaStream_t)stream;
  return pasta_form(k) ? eval_launch_form<true>(rows, g, Q, k, s) : eval_launch_form<false>(rows, g, Q, k, s);
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
