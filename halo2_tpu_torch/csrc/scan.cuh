// Scans of run totals, shared by kernel C (csrc/scan.cu) and kernel E
// (csrc/polyeval.cu).
//
// Both kernels are a reduce-then-scan over rows: a first launch gives each
// thread a run of kRunRows rows and writes the run's total (a product, or
// a suffix Horner sum); a second launch, one block of kCarryThreads
// threads, scans those totals; a third applies each run's carry to its
// rows. This header holds the second launch's block scan: each thread
// combines a chunk of consecutive totals in registers, the block scans the
// chunk aggregates (warp shuffles, then the warp aggregates in one warp),
// and each thread walks its chunk again with the carry in. It also holds
// the block sum of kernels D and F and the row loads and stores.
//
// An operator `Op` defines a state `S` (a struct of kWords 32-bit words),
// its identity and combine(earlier, later), which is associative. The scan
// is exclusive, in thread order (kRev false) or in reverse thread order
// (kRev true, a suffix scan).
#pragma once
#include "field.cuh"

constexpr int kRunRows = 8;          // rows a thread of the first and third launch
constexpr int kRunThreads = 128;     // threads a block of those launches
constexpr int kCarryThreads = 512;   // the one block of the second launch (128 registers a
                                     // thread: its scans and products do not spill)

// the product of 256-bit values mod p
template <bool kPasta>
struct MulOp {
  struct S {
    static constexpr int kWords = 8;
    Fe a;
  };
  FieldConsts k;
  __device__ S identity() const { return S{fe_from(k.one)}; }
  __device__ S combine(const S& x, const S& y) const { return S{fe_mul_cc<kPasta>(x.a, y.a, k)}; }
};

// affine maps v -> m v + c under composition: combine(earlier, later) is
// later o earlier, the map that applies the earlier one first
template <bool kPasta>
struct AffineOp {
  struct S {
    static constexpr int kWords = 16;
    Fe m, c;
  };
  FieldConsts k;
  __device__ S identity() const { return S{fe_from(k.one), fe_zero()}; }
  __device__ S combine(const S& x, const S& y) const {
    return S{fe_mul_cc<kPasta>(y.m, x.m, k), fe_add_cc(fe_mul_cc<kPasta>(y.m, x.c, k), y.c, k)};
  }
};

template <class S>
__device__ __forceinline__ S shfl_s(const S& a, int d, bool up) {
  S r;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&a);
  uint32_t* o = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < S::kWords; ++i)
    o[i] = up ? __shfl_up_sync(0xffffffffu, w[i], d) : __shfl_down_sync(0xffffffffu, w[i], d);
  return r;
}

// The exclusive scan of x over the block's threads in thread order (kRev:
// in reverse thread order), and in `total` the combination of every
// thread's x. `sh` holds 32 states in shared memory. Every thread of the
// block must call it; blockDim.x is a multiple of 32.
template <bool kRev, class Op>
__device__ __forceinline__ typename Op::S block_exclusive_scan(const typename Op::S& x, const Op& op,
                                                               typename Op::S* sh, typename Op::S& total) {
  using S = typename Op::S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  S inc = x;  // inclusive within the warp, in scan order
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const S y = shfl_s(inc, d, !kRev);
    if (kRev ? lane + d < 32 : lane >= d) inc = op.combine(y, inc);
  }
  if (lane == (kRev ? 0 : 31)) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {  // scan the warp aggregates, position j in scan order
    const int w = kRev ? nwarps - 1 - lane : lane;
    S a = lane < nwarps ? sh[w] : op.identity();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const S y = shfl_s(a, d, true);
      if (lane >= d) a = op.combine(y, a);
    }
    if (lane < nwarps) sh[w] = a;
  }
  __syncthreads();
  const bool first_warp = kRev ? warp == nwarps - 1 : warp == 0;
  const S before = first_warp ? op.identity() : sh[kRev ? warp + 1 : warp - 1];
  S ex = shfl_s(inc, 1, !kRev);
  if (lane == (kRev ? 31 : 0)) ex = op.identity();
  total = sh[kRev ? 0 : nwarps - 1];
  __syncthreads();  // sh may be used again
  return op.combine(before, ex);
}

// The sum of every thread's v (fe_add_cc) in thread 0; `sh` holds 32
// values in shared memory. Every thread of the block must call it.
__device__ __forceinline__ Fe block_sum(Fe v, Fe* sh, const FieldConsts& k) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    Fe o;
#pragma unroll
    for (int i = 0; i < 8; ++i) o.v[i] = __shfl_down_sync(0xffffffffu, v.v[i], d);
    v = fe_add_cc(v, o, k);  // lanes >= 32 - d add what no one reads
  }
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < nwarps; ++w) v = fe_add_cc(v, sh[w], k);
  __syncthreads();  // sh may be used again
  return v;
}

// 16 int32 limbs of row r of an (n, 16) tensor, and back.
__device__ __forceinline__ Fe row_load(const int32_t* base, long long r) {
  return fe_load16_v(reinterpret_cast<const int4*>(base + 16 * r));
}

__device__ __forceinline__ void row_store(int32_t* base, long long r, const Fe& a) {
  fe_store16_v(reinterpret_cast<int4*>(base + 16 * r), a);
}
