// Kernels 9 and 10: the per-element field and curve arithmetic that the
// kernel-profiling tool times (halo2_tpu_torch/tools/profile_kernels.py).
//
// tile_mul replaces tools/profile_kernels.py::mul_kernel (defined at :48,
// pallas_call at :61): o <- o * b, eight chained Montgomery products per
// element. tile_padd replaces padd_kernel (defined at :77, pallas_call at
// :92): one complete mixed addition per element (RCB15 algorithm 8, a = 0,
// Z2 = 1, the curve's 3b from FieldConsts), the function of
// halo2_tpu/ops/msm_pallas.py::_mixed_padd. The TPU tiles were (16 limbs,
// 128 lanes) over a sequential grid of 2048 steps; here one thread owns one
// element and the grid covers all n at once.
//
// What bounds them on an H100: tile_mul reads two elements and writes one
// (192 B) and makes 8 products of 176 multiply instructions (Pasta): 7.3
// instructions per byte against the card's 5, so it is bound by multiplies,
// narrowly. tile_padd moves 8 elements (512 B) for 11 general products
// (1936 instructions, the two by 3b not counted): 3.8 per byte, so it is
// bound by bytes, with multiplies close behind. The
// design keeps each element in registers from load to store, loads and
// stores it as four 16-byte vectors, and runs 256 threads a block.
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;

// 16 int32 limbs (64 B, 16-byte aligned) -> 8 words, as four int4 loads.
__device__ __forceinline__ Fe load_fe(const int32_t* src) {
  const int4* s = reinterpret_cast<const int4*>(src);
  Fe r;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int4 v = s[q];
    r.v[2 * q] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    r.v[2 * q + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
  return r;
}

__device__ __forceinline__ void store_fe(int32_t* dst, const Fe& a) {
  int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    d[q] = make_int4((int)(a.v[2 * q] & 0xFFFFu), (int)(a.v[2 * q] >> 16),
                     (int)(a.v[2 * q + 1] & 0xFFFFu), (int)(a.v[2 * q + 1] >> 16));
  }
}

__global__ void tile_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                                int32_t* __restrict__ out, long long n, FieldConsts k) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  Fe o = load_fe(a + e * 16);
  const Fe m = load_fe(b + e * 16);
#pragma unroll 1
  for (int r = 0; r < 8; ++r) o = fe_mul(o, m, k);
  store_fe(out + e * 16, o);
}

__global__ void tile_padd_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                                 const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
                                 const int32_t* __restrict__ y2, int32_t* __restrict__ x3,
                                 int32_t* __restrict__ y3, int32_t* __restrict__ z3, long long n,
                                 FieldConsts k) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  Pt p;
  p.x = load_fe(x1 + e * 16);
  p.y = load_fe(y1 + e * 16);
  p.z = load_fe(z1 + e * 16);
  const Pt r = pt_add_mixed(p, load_fe(x2 + e * 16), load_fe(y2 + e * 16), k);
  store_fe(x3 + e * 16, r.x);
  store_fe(y3 + e * 16, r.y);
  store_fe(z3 + e * 16, r.z);
}

// The profiling tool's latency probe (no TPU kernel's port): one thread runs
// x <- op(x, b) n times in a dependent chain and reads the SM's clock around
// it. op 0 fe_mul, 1 fe_mul_cc (any modulus), 2 fe_mul_cc (Pasta form), 3
// fe_add, 4 fe_add_cc, 5 fe_sub, 6 fe_sub_cc; one kernel an op, so that the
// loop holds nothing but the chain.
template <int kOp>
__device__ __forceinline__ Fe apply_op(const Fe& x, const Fe& y, const FieldConsts& k) {
  if (kOp == 0) return fe_mul(x, y, k);
  if (kOp == 1) return fe_mul_cc<false>(x, y, k);
  if (kOp == 2) return fe_mul_cc<true>(x, y, k);
  if (kOp == 3) return fe_add(x, y, k);
  if (kOp == 4) return fe_add_cc(x, y, k);
  if (kOp == 5) return fe_sub(x, y, k);
  return fe_sub_cc(x, y, k);
}

template <int kOp>
__global__ void op_chain_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                                int32_t* __restrict__ out, long long* __restrict__ cycles, int n,
                                FieldConsts k) {
  Fe x = load_fe(a);
  const Fe y = load_fe(b);
  const long long t0 = clock64();
#pragma unroll 1
  for (int r = 0; r < n; ++r) x = apply_op<kOp>(x, y, k);
  const long long t1 = clock64();
  store_fe(out, x);
  *cycles = t1 - t0;
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// a, b, out: (n, 16) int32 device tensors; consts: host FieldConsts.
extern "C" int tile_mul(const int32_t* a, const int32_t* b, int32_t* out, long long n,
                        const FieldConsts* consts, void* stream) {
  tile_mul_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(a, b, out, n, *consts);
  return (int)cudaGetLastError();
}

// x1, y1, z1 (projective), x2, y2 (affine) in; x3, y3, z3 out: (n, 16) int32.
extern "C" int tile_padd(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                         const int32_t* x2, const int32_t* y2, int32_t* x3, int32_t* y3,
                         int32_t* z3, long long n, const FieldConsts* consts, void* stream) {
  tile_padd_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      x1, y1, z1, x2, y2, x3, y3, z3, n, *consts);
  return (int)cudaGetLastError();
}

// a, b, out: (16,) int32 limbs; cycles: one int64. One thread. Op 2 needs
// a modulus of pasta_form.
extern "C" int op_chain(const int32_t* a, const int32_t* b, int32_t* out, long long* cycles,
                        int n, int op, const FieldConsts* consts, void* stream) {
  void (*kernels[])(const int32_t*, const int32_t*, int32_t*, long long*, int, FieldConsts) = {
      op_chain_kernel<0>, op_chain_kernel<1>, op_chain_kernel<2>, op_chain_kernel<3>,
      op_chain_kernel<4>, op_chain_kernel<5>, op_chain_kernel<6>};
  if (op < 0 || op > 6 || (op == 2 && !pasta_form(*consts))) return (int)cudaErrorInvalidValue;
  kernels[op]<<<1, 1, 0, (cudaStream_t)stream>>>(a, b, out, cycles, n, *consts);
  return (int)cudaGetLastError();
}
