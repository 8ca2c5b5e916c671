// Kernels 5-7: the sorted-bucket MSM (signed 16-bit windows).
//
// Replace halo2_tpu/ops/msm_sorted.py _accum_fn (pallas_call at :275),
// _fold_fn (:433) and _horner_fn (:497). Layouts (int32, 16-bit limbs):
//   entries (nw, n)             per window, the n points sorted by bucket
//                               |e| and then by point index:
//                               src << 6 | (digit < 0) << 5 | |digit| mod KB
//   gstart  (nw, W + 2)         first sorted position of lane l (the KB
//                               buckets [KB l, KB l + KB)); [W, W + 1) is
//                               the side list (|digit| = 2^15), beyond it
//                               the discarded zero digits
//   px, py  (rows >= n, 16)     affine Montgomery bases, row-major (64 B a row)
//   buckets (nw, W, KB, 3, 16)  bucket b = KB * lane + sub, projective, 192
//                               contiguous bytes each
//   part    (nw, NBK, 2, 3, 16) the fold's block results
//   wins    (nw, 3, 16)         sum_b b * S_b per window
//   out     (3, 16)             sum_w 2^(16 w) * wins_w
//
// Every addition goes through one skip rule, which the plain versions in
// ops/msm_sorted.py apply in the same order: an operand that is the identity
// (Z = 0 mod p) is not added, the other operand is returned as it is; a
// point added into an empty bucket is copied with Z = 1. So the kernels and
// the plain versions give the same projective coordinates.
//
// What bounds them on an H100: integer multiplies. A mixed addition is 11
// general Montgomery products (176 32-bit multiply instructions each on
// Pasta), a full one 12, a doubling 8, against at most 192 B moved per
// addition. The first port ran kernel 5 as one thread per (window, lane),
// 16 384 threads in 128 blocks (below one block per SM), each bucket loaded
// and stored in device memory around every addition and the longest lane
// (about 2.6 times the mean) setting the time; kernel 6 as three levels of
// 32-way Hillis-Steele scans (about 8 times the additions the running-sum
// method needs, 255 registers with spills) and a serial tail on 16 warps.
//
// msm_sorted_accum (replaces msm_sorted.py:275 _accum_fn): a block per
// (window, G lanes), whose entries are one run of the window's list sorted
// by bucket. The run is cut into blockDim nearly equal pieces, each snapped
// forward to a bucket start, so a thread owns whole buckets and about the
// same number of points as its neighbours; the lane starts of the block sit
// in shared memory and give each sorted position its bucket. A thread sums
// each of its buckets in registers from the identity in ascending point
// index (the order of the sort), the first point copied with Z = 1, exactly
// as the first port did, and writes every bucket of its range once, empty
// ones as the identity, in 12 stores of 16 bytes: no pre-fill, no
// read-modify-write. Bases are read as 16-byte vectors of the row-major
// tables (8 MB at 2^16 rows, so they stay in the L2), one point ahead of the
// addition. Bound by the multiplies of its mixed additions, then by the
// spread of run lengths within a warp (a run ends at a bucket end) and by
// the top window, whose digits (at most 2^14 + 1 on Pasta) fill only lanes
// 0-512 at twice the density: its blocks are launched first, so that they do
// not end the launch. At G = 32 lanes and 128 threads a block (the sweep's
// fastest on an H100; about a bucket a thread, G = 1 and 32 threads, took
// 1.8 times as long) a thread's serial chain is about n * G / (1024 * 128)
// = 16 points at n = 2^16, twice that in the top window. Registers are
// capped at 128 (4 blocks of 128 threads an SM): more warps beat the few
// spills that cost.
// msm_sorted_fold (replaces msm_sorted.py:433 _fold_fn): sum_b b * S_b over
// the 2^15 buckets of a window, plus 2^15 times the side list, by the
// running-sum method in two passes.
// - fold_kernel: a thread per segment j of L = 2^l buckets, blockDim
//   segments of one window a block. From the segment's top down it keeps
//   the running sum (Sum_j) and the total of the running sums (W_j =
//   sum_r r * S_{jL + r}), two full additions a bucket under the skip rule.
//   The side list (at most SIDE_CAP points, y negated, summed in slot order
//   by mixed additions) is bucket 2^15 = r = L of the window's top segment,
//   so its 2^15 weight needs no doublings of its own.
//   A suffix scan by warp shuffles, then across the block's warps through
//   shared memory, gives U_i = sum_{u >= i} Sum_u over the block; U_0 is the
//   block's sum and is dropped from the weights, each other U_i is doubled l
//   times and added to W_i, and a shuffle tree and a pass over the warps
//   give T = sum_i W_i + L sum_{i >= 1} U_i.
// - window_kernel: a warp per window takes the NBK <= 32 block results
//   (T_k, Sum_k) and applies the same formula at weight blockDim * L:
//   sum_b b * S_b = sum_k T_k + blockDim L sum_{k >= 1} V_k.
// Bound by the multiplies of its full additions (about 2 per occupied
// bucket), and in practice by latency: with 242 registers 8 warps fit an SM
// and each waits on its own chain of dependent point operations (about 8 us
// each on one thread alone, kernel 7's rate). The chain: 2L + 1 additions in
// the segment (plus the side list's few), log2(32) + (warps - 1) + 1 for the
// scan, l doublings, 1, and log2(32) + (warps - 1) for the tree in the first
// pass; log2(32) + log2(blockDim L) doublings + 1 + log2(32) in the second.
// At L = 16 and 64 threads a block (the sweep's fastest): 33 + 7 + 4 + 1 + 6
// = 51, then 5 + 10 + 1 + 5 = 21: 72 operations. Shorter segments give more
// threads than fit at once, longer ones a longer chain. The additions are
// calls (fold_add / fold_dbl in field.cuh), as in kernel 3.
// msm_sorted_horner (replaces msm_sorted.py:497 _horner_fn): sum_w 2^(16 w)
// wins_w from the top window down, 16 doublings and one addition a window:
// 240 doublings and 15 additions in one chain, which parallel windows cannot
// shorten (2^240 W_15 needs its 240 doublings in sequence). The first port
// ran it on one thread: 255 point operations of 8-14 dependent products,
// about 2 100 products at about 0.96 us each on an H100, the additions
// included. Bound by the latency of that chain, so this kernel shortens each
// link: one warp, the products of a doubling (8) or a full addition (14)
// that do not depend on each other run at once on lanes 0-5 (three rounds
// each: 4, 2, 3 and 6, 2, 6 products), each product is fe_mul_cc's
// carry-chain product (the Pasta form on Pasta), each addition fe_add_cc /
// fe_sub_cc, and the identity test runs once a window. The operations,
// their operands and their order are msm_sorted_horner_plain's, so the
// projective result is the same.
//
// ptxas (-Xptxas -v, sm_90a): accum_kernel 128 registers, 124 bytes of spill
// stores and 88 of loads (80-byte stack); fold_kernel 242 registers, no
// spills, a 1000-byte stack for the calls; window_kernel 194 registers, no
// spills, 616-byte stack; horner_kernel 80 registers in either form, no
// stack (the one-thread kernel of the first port took 186). The first port's
// combine_kernel took 255 registers with 128 bytes of spills.
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int W = 1024;        // lanes per window
constexpr int KB = 32;         // buckets per lane; W * KB = 2^15
constexpr int NB = W * KB;     // buckets per window
constexpr int SIDE_CAP = 128;  // side-list slots per window
constexpr int PT = 48;         // int32 limbs per projective point
constexpr int MAX_THREADS = 256;
constexpr int ACCUM_THREADS = 128;  // at most, a block of accum_kernel
constexpr int ACCUM_BLOCKS = 4;     // blocks an SM: 128 registers a thread
constexpr int MAX_LANES = 32;       // lanes per accumulation block

__device__ __forceinline__ Pt pt_load(const int32_t* src) {
  Pt r;
  r.x = fe_load16(src, 1);
  r.y = fe_load16(src + 16, 1);
  r.z = fe_load16(src + 32, 1);
  return r;
}

__device__ __forceinline__ void pt_store(int32_t* dst, const Pt& p) {
  fe_store16(dst, 1, p.x);
  fe_store16(dst + 16, 1, p.y);
  fe_store16(dst + 32, 1, p.z);
}

// Affine (x, y) into a: copied with Z = 1 if a is the identity.
__device__ __forceinline__ Pt add_affine_skip(const Pt& a, const Fe& x, const Fe& y,
                                              const FieldConsts& k) {
  if (is_identity(a, k)) {
    Pt r;
    r.x = x;
    r.y = y;
    r.z = fe_from(k.one);
    return r;
  }
  return pt_add_mixed(a, x, y, k);
}

// Base row src (16-byte vectors of the row-major tables), y negated when neg.
__device__ __forceinline__ void load_base(const int32_t* px, const int32_t* py, long long src,
                                          bool neg, Fe& x, Fe& y, const FieldConsts& k) {
  x = fe_load16_v(reinterpret_cast<const int4*>(px + src * 16));
  y = fe_load16_v(reinterpret_cast<const int4*>(py + src * 16));
  if (neg) y = fe_sub(fe_zero(), y, k);
}

// The block's bucket (g * KB + sub) of sorted position pos in [gs[0], gs[G]):
// g is the lane whose run [gs[g], gs[g + 1]) holds pos; G * KB at gs[G].
__device__ __forceinline__ int bucket_at(const int32_t* row, const int* gs, int G, int pos) {
  if (pos >= gs[G]) return G * KB;
  int lo = 0, hi = G;  // gs[lo] <= pos < gs[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (gs[mid] <= pos) lo = mid;
    else hi = mid;
  }
  return lo * KB + (row[pos] & (KB - 1));
}

__global__ void __launch_bounds__(ACCUM_THREADS, ACCUM_BLOCKS)
accum_kernel(const int32_t* __restrict__ entries, const int32_t* __restrict__ gstart,
             const int32_t* __restrict__ px, const int32_t* __restrict__ py,
             int32_t* __restrict__ buckets, long long n, int G, FieldConsts k) {
  __shared__ int gs[MAX_LANES + 1];
  // the top window first: its lanes 0-512 hold twice the mean, and its
  // blocks would otherwise end the launch
  const int w = gridDim.x / (W / G) - 1 - blockIdx.x / (W / G);
  const int l0 = (blockIdx.x % (W / G)) * G;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i <= G; i += nt) gs[i] = gstart[w * (W + 2) + l0 + i];
  __syncthreads();
  const int32_t* row = entries + (long long)w * n;
  const int beg = gs[0], N = gs[G] - beg;
  // this thread's run [lo, hi): an equal share, both ends snapped forward to
  // a bucket start, so that neighbouring runs meet and a bucket is one run's
  int lo = beg + (int)((long long)tid * N / nt);
  int hi = beg + (int)((long long)(tid + 1) * N / nt);
  int blo = bucket_at(row, gs, G, lo);
  while (lo > beg && lo < beg + N && blo == bucket_at(row, gs, G, lo - 1))
    blo = bucket_at(row, gs, G, ++lo);
  int bhi = bucket_at(row, gs, G, hi);
  while (hi > beg && hi < beg + N && bhi == bucket_at(row, gs, G, hi - 1))
    bhi = bucket_at(row, gs, G, ++hi);
  // the block's buckets [next, bhi) are this thread's, the first thread's
  // from 0: each bucket of the tensor is written once
  int32_t* out = buckets + ((long long)w * W + l0) * KB * PT;
  int next = tid == 0 ? 0 : blo;
  const Pt id = pt_identity(k);
  Pt acc = id;
  int b = blo;
  Fe x, y;  // the base of `pos`, loaded one point ahead of its addition
  if (lo < hi) load_base(px, py, row[lo] >> 6, (row[lo] >> 5) & 1, x, y, k);
#pragma unroll 1
  for (int pos = lo; pos < hi; ++pos) {
    Fe xn, yn;
    if (pos + 1 < hi) load_base(px, py, row[pos + 1] >> 6, (row[pos + 1] >> 5) & 1, xn, yn, k);
    acc = add_affine_skip(acc, x, y, k);
    x = xn;
    y = yn;
    const int nb = bucket_at(row, gs, G, pos + 1);
    if (pos + 1 == hi || nb != b) {
      for (; next < b; ++next) bucket_store(out + (long long)next * PT, id);
      bucket_store(out + (long long)b * PT, acc);
      next = b + 1;
      acc = id;
      b = nb;
    }
  }
  for (; next < bhi; ++next) bucket_store(out + (long long)next * PT, id);
}

// First pass of the fold: blockDim segments of L = 2^l buckets of one window a
// block -> part[w][k] = (T, Sum) of block k (see the note at the top).
__global__ void __launch_bounds__(MAX_THREADS)
fold_kernel(const int32_t* __restrict__ buckets, const int32_t* __restrict__ entries,
            const int32_t* __restrict__ gstart, const int32_t* __restrict__ px,
            const int32_t* __restrict__ py, int32_t* __restrict__ part, long long n, int l,
            FieldConsts k) {
  __shared__ Pt wsum[MAX_THREADS / 32];
  const int L = 1 << l, J = NB >> l;  // segments per window
  const int nt = blockDim.x, nwarp = nt >> 5;
  const int nbk = J / nt;  // blocks per window
  const int w = blockIdx.x / nbk, blk = blockIdx.x % nbk;
  const int i = threadIdx.x, lane = i & 31, wp = i >> 5;
  const int j = blk * nt + i;
  const int32_t* seg = buckets + ((long long)w * NB + (long long)j * L) * PT;
  const Pt id = pt_identity(k);
  Pt run = id, tot = id;
  if (j == J - 1) {  // the side list is bucket 2^15: r = L of the top segment
    const int beg = gstart[w * (W + 2) + W];
    const int cnt = min(gstart[w * (W + 2) + W + 1] - beg, SIDE_CAP);
    Pt side = id;
#pragma unroll 1
    for (int t = 0; t < cnt; ++t) {
      Fe x, y;
      load_base(px, py, (uint32_t)entries[(long long)w * n + beg + t] >> 6, true, x, y, k);
      side = add_affine_skip(side, x, y, k);
    }
    run = fold_add(run, side, k);
    tot = fold_add(tot, run, k);
  }
#pragma unroll 1
  for (int r = L - 1; r >= 1; --r) {
    run = fold_add(run, bucket_load(seg + r * PT), k);
    tot = fold_add(tot, run, k);
  }
  run = fold_add(run, bucket_load(seg), k);  // Sum_j
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {  // suffix scan within the warp
    const Pt o = shfl_down_pt(run, d);
    if (lane + d < 32) run = fold_add(run, o, k);
  }
  if (lane == 0) wsum[wp] = run;
  __syncthreads();
  Pt above = id;  // the sums of the warps above, from the top warp down
#pragma unroll 1
  for (int m = nwarp - 1; m > wp; --m) above = fold_add(above, wsum[m], k);
  run = fold_add(run, above, k);  // U_i over the block
  const Pt bsum = run;            // U_0 on thread 0: the block's sum
  if (i == 0) run = id;
#pragma unroll 1
  for (int t = 0; t < l; ++t) run = fold_dbl(run, k);
  Pt x = fold_add(tot, run, k);
#pragma unroll 1
  for (int d = 16; d >= 1; d >>= 1) {  // tree within the warp
    const Pt o = shfl_down_pt(x, d);
    if (lane < d) x = fold_add(x, o, k);
  }
  __syncthreads();  // every thread has read wsum
  if (lane == 0) wsum[wp] = x;
  __syncthreads();
  if (i == 0) {
#pragma unroll 1
    for (int m = 1; m < nwarp; ++m) x = fold_add(x, wsum[m], k);
    int32_t* o = part + ((long long)w * nbk + blk) * 2 * PT;
    bucket_store(o, x);
    bucket_store(o + PT, bsum);
  }
}

// Second pass: a warp per window joins its nbk <= 32 block results at weight
// 2^lw = blockDim * L.
__global__ void window_kernel(const int32_t* __restrict__ part, int32_t* __restrict__ wins,
                              int nbk, int lw, FieldConsts k) {
  const int w = blockIdx.x;
  const int lane = threadIdx.x;
  const Pt id = pt_identity(k);
  const int32_t* p = part + ((long long)w * nbk + lane) * 2 * PT;
  const Pt tot = lane < nbk ? bucket_load(p) : id;
  Pt run = lane < nbk ? bucket_load(p + PT) : id;
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
    const Pt o = shfl_down_pt(run, d);
    if (lane + d < 32) run = fold_add(run, o, k);
  }
  if (lane == 0) run = id;
#pragma unroll 1
  for (int t = 0; t < lw; ++t) run = fold_dbl(run, k);
  Pt x = fold_add(tot, run, k);
#pragma unroll 1
  for (int d = 16; d >= 1; d >>= 1) {
    const Pt o = shfl_down_pt(x, d);
    if (lane < d) x = fold_add(x, o, k);
  }
  if (lane == 0) bucket_store(wins + (long long)w * PT, x);
}

// ---- kernel 7: a warp runs the Horner chain ----
// Each round of independent products of an RCB15 doubling or addition runs
// on lanes 0-5 at once, a product a lane (fe_mul_cc); lane j's product
// reaches every lane by shuffles, and every lane makes the additions, the
// subtractions and the skip tests itself, so the warp never diverges
// (warp_add, shared with kernel 4, and its helpers are in field.cuh).

// pt_double's operations, its 8 general products in three rounds:
// (Y Y, Y Z, Z Z, X Y), (3b ZZ, YZ Z3), (t2 Z3, t0 Y3, t0 XY)
template <bool kPasta>
__device__ __forceinline__ Pt warp_double(const Pt& a, const FieldConsts& k, int lane) {
  const Fe b3 = fe_from(k.b3);
  Fe r = fe_mul_cc<kPasta>(fe_sel(lane == 2, a.z, fe_sel(lane == 3, a.x, a.y)),
                           fe_sel(lane == 0 || lane == 3, a.y, a.z), k);
  const Fe yy = shfl_fe(r, 0), yz = shfl_fe(r, 1), zz = shfl_fe(r, 2), xy = shfl_fe(r, 3);
  Fe z3 = fe_add_cc(yy, yy, k);
  z3 = fe_add_cc(z3, z3, k);
  z3 = fe_add_cc(z3, z3, k);
  r = fe_mul_cc<kPasta>(fe_sel(lane == 0, b3, yz), fe_sel(lane == 0, zz, z3), k);
  const Fe t2 = shfl_fe(r, 0);
  Pt out;
  out.z = shfl_fe(r, 1);
  const Fe y3 = fe_add_cc(yy, t2, k);
  const Fe t1 = fe_add_cc(t2, t2, k);
  const Fe t0 = fe_sub_cc(yy, fe_add_cc(t1, t2, k), k);
  r = fe_mul_cc<kPasta>(fe_sel(lane == 0, t2, t0),
                        fe_sel(lane == 0, z3, fe_sel(lane == 1, y3, xy)), k);
  const Fe x3 = shfl_fe(r, 0), y3b = shfl_fe(r, 1), x3b = shfl_fe(r, 2);
  out.y = fe_add_cc(x3, y3b, k);
  out.x = fe_add_cc(x3b, x3b, k);
  return out;
}

// msm_sorted_horner_plain's chain: from the top window down, 16 doublings
// and one addition a window under the skip rule (one warp, blockDim 32).
template <bool kPasta>
__global__ void horner_kernel(const int32_t* __restrict__ wins, int32_t* __restrict__ out, int nw,
                              FieldConsts k) {
  const int lane = threadIdx.x;
  Pt acc = pt_load(wins + (long long)(nw - 1) * PT);
#pragma unroll 1
  for (int w = nw - 2; w >= 0; --w) {
    // dbl_skip 16 times; the curves have prime order, so the double of a
    // point other than the identity is not the identity (Z3 = 8 Y^3 Z), and
    // one test a window gives every test's answer
    if (!is_identity(acc, k)) {
#pragma unroll 1
      for (int i = 0; i < 16; ++i) acc = warp_double<kPasta>(acc, k, lane);
    }
    const Pt b = pt_load(wins + (long long)w * PT);
    if (is_identity(b, k)) continue;
    if (is_identity(acc, k))
      acc = b;
    else
      acc = warp_add<kPasta>(acc, b, k, lane);
  }
  if (lane == 0) pt_store(out, acc);
}

}  // namespace

// G lanes a block (a power of two, at most MAX_LANES), threads a block at
// most ACCUM_THREADS; the wrapper checks both.
extern "C" int msm_sorted_accum(const int32_t* entries, const int32_t* gstart, const int32_t* px,
                                const int32_t* py, int32_t* buckets, int nw, long long n, int G,
                                int threads, const FieldConsts* consts, void* stream) {
  accum_kernel<<<nw * (W / G), threads, 0, (cudaStream_t)stream>>>(entries, gstart, px, py,
                                                                    buckets, n, G, *consts);
  return (int)cudaGetLastError();
}

// part: nw * (2^15 / (threads * 2^l)) * 2 points; that count must be 1-32.
extern "C" int msm_sorted_fold(const int32_t* buckets, const int32_t* entries,
                               const int32_t* gstart, const int32_t* px, const int32_t* py,
                               int32_t* part,
                               int32_t* wins, int nw, long long n, int l, int threads,
                               const FieldConsts* consts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nbk = (NB >> l) / threads;
  int lw = 0;
  while ((1 << lw) < threads << l) ++lw;
  fold_kernel<<<nw * nbk, threads, 0, s>>>(buckets, entries, gstart, px, py, part, n, l, *consts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  window_kernel<<<nw, 32, 0, s>>>(part, wins, nbk, lw, *consts);
  return (int)cudaGetLastError();
}

extern "C" int msm_sorted_horner(const int32_t* wins, int32_t* out, int nw,
                                 const FieldConsts* consts, void* stream) {
  auto kernel = pasta_form(*consts) ? horner_kernel<true> : horner_kernel<false>;
  kernel<<<1, 32, 0, (cudaStream_t)stream>>>(wins, out, nw, *consts);
  return (int)cudaGetLastError();
}
