// Kernels 2-4: the bucket (Pippenger) MSM over shared affine bases.
//
// Replace halo2_tpu/ops/msm_pallas.py _accum_fn (pallas_call at :232),
// _fold_fn (:302) and _lane_reduce_fn (:357). Layouts (int32, 16-bit limbs):
//   scal    (M, 16, n_pad)        canonical scalars, limb-major
//   px, py  (16, n_pad)           affine Montgomery bases
//   buckets (rows, B, 3, 16, T)   rows = M * nwin, lanes innermost
//   parts   (rows, 3, 16, T)
//   out     (rows, 3, 16)
//
// msm_accum: one thread per (row, lane). Lane t owns the B = 2^c buckets of
// its row, so no two threads write one bucket and there are no atomics; it
// walks the points t, t + T, ... , takes the c-bit window digit straight
// from the scalar limb, skips digit 0 and adds the base into its bucket with
// the complete mixed addition (no special cases for identity or doubling).
// msm_fold: one thread per (row, lane) takes the running and total suffix
// sums over buckets B-1 .. 1, giving sum_b b * S_b for the lane.
// msm_lane_reduce: one block of T threads per row sums the T lane partials
// as a tree in shared memory.
//
// What bounds them on an H100: every bucket update is a 13-product mixed
// addition (14 for the full additions of the fold and the reduction), about
// 1,700 32-bit multiplies, against 192 B of bucket state read and written,
// so all three are bound by integer multiply throughput. The design spreads
// rows * T independent threads over the card and keeps each thread's
// bucket traffic coalesced across the lanes of a warp (lanes innermost).
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

__device__ __forceinline__ Pt pt_load(const int32_t* base, long long stride_coord,
                                      long long stride_limb) {
  Pt r;
  r.x = fe_load16(base, stride_limb);
  r.y = fe_load16(base + stride_coord, stride_limb);
  r.z = fe_load16(base + 2 * stride_coord, stride_limb);
  return r;
}

__device__ __forceinline__ void pt_store(int32_t* base, long long stride_coord,
                                         long long stride_limb, const Pt& p) {
  fe_store16(base, stride_limb, p.x);
  fe_store16(base + stride_coord, stride_limb, p.y);
  fe_store16(base + 2 * stride_coord, stride_limb, p.z);
}

__global__ void accum_kernel(const int32_t* __restrict__ scal, const int32_t* __restrict__ px,
                             const int32_t* __restrict__ py, int32_t* __restrict__ buckets,
                             int nwin, long long n_pad, int T, int c, FieldConsts k) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  const int m = row / nwin;
  const int w = row % nwin;
  const int B = 1 << c;
  const long long sc = 16LL * T;  // coordinate stride in the bucket layout
  int32_t* mine = buckets + (long long)row * B * 3 * sc + lane;
  const Pt id = pt_identity(k);
  for (int b = 0; b < B; ++b) pt_store(mine + (long long)b * 3 * sc, sc, T, id);

  const int bit = w * c;
  const int32_t* limb = scal + ((long long)m * 16 + (bit >> 4)) * n_pad;
  const int shift = bit & 15;
  for (long long i = lane; i < n_pad; i += T) {
    const int d = (limb[i] >> shift) & (B - 1);
    if (d == 0) continue;
    int32_t* bk = mine + (long long)d * 3 * sc;
    Pt acc = pt_load(bk, sc, T);
    Fe X2 = fe_load16(px + i, n_pad);
    Fe Y2 = fe_load16(py + i, n_pad);
    pt_store(bk, sc, T, pt_add_mixed(acc, X2, Y2, k));
  }
}

__global__ void fold_kernel(const int32_t* __restrict__ buckets, int32_t* __restrict__ parts,
                            int B, int T, FieldConsts k) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  const long long sc = 16LL * T;
  const int32_t* mine = buckets + (long long)row * B * 3 * sc + lane;
  Pt run = pt_identity(k);
  Pt total = run;
  for (int b = B - 1; b >= 1; --b) {
    run = pt_add(run, pt_load(mine + (long long)b * 3 * sc, sc, T), k);
    total = pt_add(total, run, k);
  }
  pt_store(parts + (long long)row * 3 * sc + lane, sc, T, total);
}

__global__ void lane_reduce_kernel(const int32_t* __restrict__ parts, int32_t* __restrict__ out,
                                   int T, FieldConsts k) {
  extern __shared__ Pt pts[];
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  const long long sc = 16LL * T;
  pts[lane] = pt_load(parts + (long long)row * 3 * sc + lane, sc, T);
  __syncthreads();
  for (int s = T >> 1; s >= 1; s >>= 1) {
    if (lane < s) pts[lane] = pt_add(pts[lane], pts[lane + s], k);
    __syncthreads();
  }
  if (lane == 0) pt_store(out + (long long)row * 48, 16, 1, pts[0]);
}

}  // namespace

extern "C" int msm_accum(const int32_t* scal, const int32_t* px, const int32_t* py,
                         int32_t* buckets, int rows, int nwin, long long n_pad, int T, int c,
                         const FieldConsts* consts, void* stream) {
  accum_kernel<<<rows, T, 0, (cudaStream_t)stream>>>(scal, px, py, buckets, nwin, n_pad, T, c,
                                                      *consts);
  return (int)cudaGetLastError();
}

extern "C" int msm_fold(const int32_t* buckets, int32_t* parts, int rows, int B, int T,
                        const FieldConsts* consts, void* stream) {
  fold_kernel<<<rows, T, 0, (cudaStream_t)stream>>>(buckets, parts, B, T, *consts);
  return (int)cudaGetLastError();
}

extern "C" int msm_lane_reduce(const int32_t* parts, int32_t* out, int rows, int T,
                               const FieldConsts* consts, void* stream) {
  lane_reduce_kernel<<<rows, T, T * sizeof(Pt), (cudaStream_t)stream>>>(parts, out, T,
                                                                          *consts);
  return (int)cudaGetLastError();
}
