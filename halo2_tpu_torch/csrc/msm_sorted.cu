// Kernels 5-7: the sorted-bucket MSM (signed 16-bit windows).
//
// Replace halo2_tpu/ops/msm_sorted.py _accum_fn (pallas_call at :275),
// _fold_fn (:433) and _horner_fn (:497). Layouts (int32, 16-bit limbs):
//   entries (nw, n)             per window, the n points sorted by lane:
//                               src << 6 | (digit < 0) << 5 | |digit| mod KB
//   gstart  (nw, W + 2)         first sorted position of lane l; [W, W + 1)
//                               is the side list (|digit| = 2^15), beyond
//                               it the discarded zero digits
//   px, py  (rows >= n, 16)     affine Montgomery bases, row-major
//   buckets (nw, W, KB, 3, 16)  bucket b = KB * lane + sub, projective
//   wins    (nw, 3, 16)         sum_b b * S_b per window
//   out     (3, 16)             sum_w 2^(16 w) * wins_w
//
// Every addition goes through one skip rule, which the plain versions in
// ops/msm_sorted.py apply in the same order: an operand that is the identity
// (Z = 0 mod p) is not added, the other operand is returned as it is; a
// point added into an empty bucket is copied with Z = 1. So the kernels and
// the plain versions give the same projective coordinates, and the plain
// versions can skip the empty buckets that dominate a small MSM.
//
// msm_sorted_accum: one thread per (window, lane), the TPU grid's lane. It
// walks the lane's run of the sorted entries, gathers each base by its index
// (the TPU gathered the points into a padded grid beforehand and picked the
// bucket by a one-hot select; a thread here addresses both directly) and adds
// it, y negated for a negative digit, into its bucket with the complete mixed
// addition. The KB = 32 buckets of a lane (3 KB) live in a device scratch:
// they do not fit in registers or, for a useful block, in shared memory.
// msm_sorted_fold: sum_b b * S_b over the 2^15 buckets of a window as three
// levels of 32-way lane-suffix scans, one warp per group of 32 children:
// thread j holds child j, a Hillis-Steele suffix scan by warp shuffles gives
// suf_j = sum_{u >= j} P_u, and sum_{j >= 1} suf_j = sum_j j * P_j by a shuffle
// tree. Level 1 takes the 32 buckets of a lane (weight 1), level 2 the 32
// lanes of a group (weight KB = 32), level 3 the 32 groups of a window
// (weight 1024); each carries (sum of points, weighted sum). A last pass adds
// 2^15 times the side list (at most SIDE_CAP = 128 points: four per thread,
// then a shuffle tree).
// msm_sorted_horner: one thread, 16 doublings and one addition per window.
//
// What bounds them on an H100: integer multiplies. A mixed addition is 11
// general Montgomery products (176 32-bit multiply instructions each on
// Pasta), a full one 12, a doubling 8, against at most 128 B read per
// addition. The accumulation has the most work (one mixed addition per
// nonzero digit) and 16 * W threads, about one block per SM; the fold has
// 32 threads per group and the Horner step is serial by nature.
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int W = 1024;        // lanes per window
constexpr int KB = 32;         // buckets per lane; W * KB = 2^15
constexpr int SIDE_CAP = 128;  // side-list slots per window
constexpr int PT = 48;         // int32 limbs per projective point

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

// Base row src, y negated when neg.
__device__ __forceinline__ void load_base(const int32_t* px, const int32_t* py, long long src,
                                          bool neg, Fe& x, Fe& y, const FieldConsts& k) {
  x = fe_load16(px + src * 16, 1);
  y = fe_load16(py + src * 16, 1);
  if (neg) y = fe_sub(fe_zero(), y, k);
}

// Sum over the warp into lane 0: pairs (j, j + d) for d = 16, 8, 4, 2, 1.
__device__ __forceinline__ Pt warp_tree(Pt v, int j, const FieldConsts& k) {
#pragma unroll 1
  for (int d = 16; d >= 1; d >>= 1) {
    Pt o = shfl_down_pt(v, d);
    if (j < d) v = add_skip(v, o, k);
  }
  return v;
}

__global__ void accum_kernel(const int32_t* __restrict__ entries, const int32_t* __restrict__ gstart,
                             const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                             int32_t* __restrict__ buckets, int nw, long long n, FieldConsts k) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nw * W) return;
  const int w = t / W;
  const int l = t % W;
  int32_t* mine = buckets + (long long)t * KB * PT;
  const Pt id = pt_identity(k);
  for (int s = 0; s < KB; ++s) pt_store(mine + s * PT, id);
  const int beg = gstart[w * (W + 2) + l];
  const int end = gstart[w * (W + 2) + l + 1];
  const int32_t* row = entries + (long long)w * n;
  for (int pos = beg; pos < end; ++pos) {
    const uint32_t e = (uint32_t)row[pos];
    Fe x, y;
    load_base(px, py, e >> 6, (e >> 5) & 1, x, y, k);
    int32_t* bk = mine + (e & (KB - 1)) * PT;
    pt_store(bk, add_affine_skip(pt_load(bk), x, y, k));
  }
}

// One warp per group of 32 children (point i of group g at
// child + (g * 32 + i) * stride * PT; the weighted sums at +PT when has_t):
// out[g] = (sum_j P_j, 2^log_s * sum_j j * P_j + sum_j T_j).
__global__ void combine_kernel(const int32_t* __restrict__ child, int stride, int has_t,
                               int32_t* __restrict__ out, int groups, int log_s, FieldConsts k) {
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int j = threadIdx.x & 31;
  if (g >= groups) return;  // whole warps: blockDim is a multiple of 32
  const int32_t* c = child + ((long long)g * 32 + j) * stride * PT;
  const Pt id = pt_identity(k);
  Pt x = pt_load(c);
  Pt tc = has_t ? pt_load(c + PT) : id;
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {  // suffix scan: x_j = sum_{u >= j} P_u
    Pt o = shfl_down_pt(x, d);
    if (j + d < 32) x = add_skip(x, o, k);
  }
  Pt v = j >= 1 ? x : id;
#pragma unroll 1
  for (int d = 16; d >= 1; d >>= 1) {  // both trees in one pass
    Pt ov = shfl_down_pt(v, d);
    Pt ot = shfl_down_pt(tc, d);
    if (j < d) {
      v = add_skip(v, ov, k);
      tc = add_skip(tc, ot, k);
    }
  }
  if (j == 0) {
    for (int i = 0; i < log_s; ++i) v = dbl_skip(v, k);
    int32_t* o = out + (long long)g * 2 * PT;
    pt_store(o, x);
    pt_store(o + PT, add_skip(v, tc, k));
  }
}

// One warp per window: wins[w] = weighted[w] + 2^15 * (side-list sum, y negated).
__global__ void side_kernel(const int32_t* __restrict__ level3, const int32_t* __restrict__ entries,
                            const int32_t* __restrict__ gstart, const int32_t* __restrict__ px,
                            const int32_t* __restrict__ py, int32_t* __restrict__ wins, int nw,
                            long long n, FieldConsts k) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int j = threadIdx.x & 31;
  if (w >= nw) return;
  const int beg = gstart[w * (W + 2) + W];
  const int cnt = min(gstart[w * (W + 2) + W + 1] - beg, SIDE_CAP);
  Pt acc = pt_identity(k);
  for (int i = j; i < SIDE_CAP; i += 32) {
    if (i < cnt) {
      Fe x, y;
      load_base(px, py, (uint32_t)entries[(long long)w * n + beg + i] >> 6, true, x, y, k);
      acc = add_affine_skip(acc, x, y, k);
    }
  }
  acc = warp_tree(acc, j, k);
  if (j == 0) {
    for (int i = 0; i < 15; ++i) acc = dbl_skip(acc, k);
    pt_store(wins + (long long)w * PT, add_skip(pt_load(level3 + (long long)w * 2 * PT + PT), acc, k));
  }
}

__global__ void horner_kernel(const int32_t* __restrict__ wins, int32_t* __restrict__ out, int nw,
                              FieldConsts k) {
  Pt acc = pt_load(wins + (long long)(nw - 1) * PT);
  for (int w = nw - 2; w >= 0; --w) {
    for (int i = 0; i < 16; ++i) acc = dbl_skip(acc, k);
    acc = add_skip(acc, pt_load(wins + (long long)w * PT), k);
  }
  pt_store(out, acc);
}

}  // namespace

extern "C" int msm_sorted_accum(const int32_t* entries, const int32_t* gstart, const int32_t* px,
                                const int32_t* py, int32_t* buckets, int nw, long long n,
                                const FieldConsts* consts, void* stream) {
  const int threads = nw * W;
  accum_kernel<<<(threads + 127) / 128, 128, 0, (cudaStream_t)stream>>>(entries, gstart, px, py,
                                                                        buckets, nw, n, *consts);
  return (int)cudaGetLastError();
}

// scratch: nw * W * 2 + nw * 32 * 2 + nw * 2 points.
extern "C" int msm_sorted_fold(const int32_t* buckets, const int32_t* entries, const int32_t* gstart,
                               const int32_t* px, const int32_t* py, int32_t* scratch,
                               int32_t* wins, int nw, long long n, const FieldConsts* consts,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* lv1 = scratch;
  int32_t* lv2 = lv1 + (long long)nw * W * 2 * PT;
  int32_t* lv3 = lv2 + (long long)nw * 32 * 2 * PT;
  const int g1 = nw * W, g2 = nw * 32, g3 = nw;
  combine_kernel<<<(g1 * 32 + 127) / 128, 128, 0, s>>>(buckets, 1, 0, lv1, g1, 0, *consts);
  combine_kernel<<<(g2 * 32 + 127) / 128, 128, 0, s>>>(lv1, 2, 1, lv2, g2, 5, *consts);
  combine_kernel<<<(g3 * 32 + 127) / 128, 128, 0, s>>>(lv2, 2, 1, lv3, g3, 10, *consts);
  side_kernel<<<(nw * 32 + 127) / 128, 128, 0, s>>>(lv3, entries, gstart, px, py, wins, nw, n,
                                                    *consts);
  return (int)cudaGetLastError();
}

extern "C" int msm_sorted_horner(const int32_t* wins, int32_t* out, int nw,
                                 const FieldConsts* consts, void* stream) {
  horner_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(wins, out, nw, *consts);
  return (int)cudaGetLastError();
}
