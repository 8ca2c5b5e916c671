// Kernels 9 and 10: the per-element field and curve arithmetic that the
// kernel-profiling tool times (halo2_tpu_torch/tools/profile_kernels.py).
//
// tile_mul replaces tools/profile_kernels.py::mul_kernel (defined at :48,
// pallas_call at :61): o <- o * b, eight chained Montgomery products per
// element. tile_padd replaces padd_kernel (defined at :77, pallas_call at
// :92): one complete mixed addition per element (RCB15 algorithm 8, a = 0,
// Z2 = 1, the curve's 3b from FieldConsts), the function of
// halo2_tpu/ops/msm_pallas.py::_mixed_padd. The TPU tiles were (16 limbs,
// 128 lanes) over a sequential grid of 2048 steps; here a thread owns an
// element, loaded and stored as four 16-byte vectors.
//
// What bounds them on an H100: the arithmetic, not the bytes. tile_mul
// reads and writes 192 B an element for 8 products; tile_padd 512 B a point
// for 11 general products and 13 additions. Each product is 88 low and 88
// high 32-bit multiplies (Pasta form) and about 180 carry adds; the card
// runs mad.hi at about half and mul.wide at about a third of the rate of
// mad.lo (`profile_kernels oplat`), and ptxas splits every carry-chained
// multiply-add into a multiply on the multiply pipe and an add with carry
// on the integer pipe. The multiply pipe sets the time, and the design is
// about the instructions that land on it and about keeping enough warps
// resident:
// - products are fe_mul_cc<kPasta>: rows of mul.wide.u32 products and two
//   add chains (field.cuh), the same integers as fe_mul, so tile_mul's
//   output is its plain version's bit for bit. kPasta for a modulus of
//   pasta_form (for tile_padd, and a curve with 3b = 15), dispatched on the
//   host as kernels 1 and 8 do; any other modulus or curve takes the
//   generic form, fe_mul_cc<false> with the Montgomery products by 3b;
// - tile_padd's addition is field.cuh's pt_add_mixed_cc (pt_add_mixed, which
//   kernels 2 and 5 share, is left as it is); for a Pasta modulus and
//   3b = 15 (Pallas, Vesta) its two products by 3b are fe_mul15_pasta, a
//   shift, a subtraction and a short reduction. Its coordinates are then the
//   plain version's up to their representatives and are held to it on
//   canonical values; the generic form is held to it bit for bit;
// - each chain of products holds one carry flag, so a thread has no
//   parallelism of its own: the SM hides a product's latency (about 900
//   cycles on one thread) with other warps. tile_mul needs 48 registers, 40
//   warps an SM at 256 threads a block; tile_padd about 124, under
//   __launch_bounds__(256, 2), 16 warps an SM with no spill.
// A persistent, staged layout for tile_padd (warp tiles of 32 points whose
// five inputs a warp copies into shared memory with cp.async while it adds
// the previous tile) measured slower than this one: the kernel is bound by
// its arithmetic, not by memory in flight. The (threads a block, min blocks
// an SM) of each kernel are the macros below; `tools/msm_ab.py --tile
// --sweep` builds the file again with other values (-D) to time them.
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

#ifndef TILE_MUL_THREADS
#define TILE_MUL_THREADS 256
#endif
#ifndef TILE_MUL_MIN_BLOCKS
#define TILE_MUL_MIN_BLOCKS 1
#endif
#ifndef TILE_PADD_THREADS
#define TILE_PADD_THREADS 256
#endif
#ifndef TILE_PADD_MIN_BLOCKS
#define TILE_PADD_MIN_BLOCKS 2
#endif

// ---- kernel 9 ----

template <bool kPasta>
__global__ void __launch_bounds__(TILE_MUL_THREADS, TILE_MUL_MIN_BLOCKS)
mul_kernel(const int4* __restrict__ a, const int4* __restrict__ b, int4* __restrict__ out,
           long long n, FieldConsts k) {
  const long long e = (long long)blockIdx.x * TILE_MUL_THREADS + threadIdx.x;
  if (e >= n) return;
  Fe o = fe_load16_v(a + 4 * e);
  const Fe m = fe_load16_v(b + 4 * e);
#pragma unroll 1
  for (int r = 0; r < 8; ++r) o = fe_mul_cc<kPasta>(o, m, k);
  fe_store16_v(out + 4 * e, o);
}

// ---- kernel 10 ----

struct PaddArgs {
  const int4 *x1, *y1, *z1, *x2, *y2;
  int4 *x3, *y3, *z3;
  long long n;
};

template <bool kPasta, bool kB15>
__global__ void __launch_bounds__(TILE_PADD_THREADS, TILE_PADD_MIN_BLOCKS)
padd_kernel(PaddArgs g, FieldConsts k) {
  const long long e = (long long)blockIdx.x * TILE_PADD_THREADS + threadIdx.x;
  if (e >= g.n) return;
  Pt p;
  p.x = fe_load16_v(g.x1 + 4 * e);
  p.y = fe_load16_v(g.y1 + 4 * e);
  p.z = fe_load16_v(g.z1 + 4 * e);
  const Pt r = pt_add_mixed_cc<kPasta, kB15>(p, fe_load16_v(g.x2 + 4 * e),
                                             fe_load16_v(g.y2 + 4 * e), k);
  fe_store16_v(g.x3 + 4 * e, r.x);
  fe_store16_v(g.y3 + 4 * e, r.y);
  fe_store16_v(g.z3 + 4 * e, r.z);
}

// ---- the profiling tool's probes (no TPU kernel's port) ----

// Latency: one thread runs x <- op(x, b) n times in a dependent chain and
// reads the SM's clock around it. op 0 fe_mul, 1 fe_mul_cc (any modulus), 2
// fe_mul_cc (Pasta form), 3 fe_add, 4 fe_add_cc, 5 fe_sub, 6 fe_sub_cc; one
// kernel an op, so that the loop holds nothing but the chain.
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
  Fe x = fe_load16_v(reinterpret_cast<const int4*>(a));
  const Fe y = fe_load16_v(reinterpret_cast<const int4*>(b));
  const long long t0 = clock64();
#pragma unroll 1
  for (int r = 0; r < n; ++r) x = apply_op<kOp>(x, y, k);
  const long long t1 = clock64();
  fe_store16_v(reinterpret_cast<int4*>(out), x);
  *cycles = t1 - t0;
}

// Throughput of the 32-bit multiply: every thread of a full-card grid runs
// kPeakChains chains of one form, `iters` steps each, so the SM always has
// multiplies ready to issue. The caller times the launch; the rate is
// threads x (instructions a step) x iters over that time. Forms (PEAK_FORMS
// in ops/tile_bench.py): 0 mad.lo and 1 mad.hi, x <- x m + c (low or high
// word of x m), on 8 independent chains; 2 mad.lo.cc and 3 mad.hi.cc, the
// same 8 words as one carry chain a step (madc after the first), as the
// Montgomery product's rows use them; 4 mad.wide.u32, x <- lo(x) m + x on 4
// independent 64-bit chains (words 2i, 2i + 1).
constexpr int kPeakThreads = 256;
constexpr int kPeakChains = 8;

template <int kForm>
__global__ void __launch_bounds__(kPeakThreads)
mul_peak_kernel(uint32_t* __restrict__ acc, int iters, uint32_t m, uint32_t c) {
  uint32_t* p = acc + ((long long)blockIdx.x * kPeakThreads + threadIdx.x) * kPeakChains;
  uint32_t x[kPeakChains];
#pragma unroll
  for (int i = 0; i < kPeakChains; ++i) x[i] = p[i];
  uint64_t w[kPeakChains / 2];
#pragma unroll
  for (int i = 0; i < kPeakChains / 2; ++i) w[i] = ((uint64_t)x[2 * i + 1] << 32) | x[2 * i];
#pragma unroll 1
  for (int r = 0; r < iters; ++r) {
    if (kForm == 0) {
#pragma unroll
      for (int i = 0; i < kPeakChains; ++i)
        asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x[i]) : "r"(m), "r"(c));
    } else if (kForm == 1) {
#pragma unroll
      for (int i = 0; i < kPeakChains; ++i)
        asm volatile("mad.hi.u32 %0, %0, %1, %2;" : "+r"(x[i]) : "r"(m), "r"(c));
    } else if (kForm == 2) {
      asm volatile("mad.lo.cc.u32 %0, %0, %1, %2;" : "+r"(x[0]) : "r"(m), "r"(c));
#pragma unroll
      for (int i = 1; i < kPeakChains; ++i)
        asm volatile("madc.lo.cc.u32 %0, %0, %1, %2;" : "+r"(x[i]) : "r"(m), "r"(c));
    } else if (kForm == 3) {
      asm volatile("mad.hi.cc.u32 %0, %0, %1, %2;" : "+r"(x[0]) : "r"(m), "r"(c));
#pragma unroll
      for (int i = 1; i < kPeakChains; ++i)
        asm volatile("madc.hi.cc.u32 %0, %0, %1, %2;" : "+r"(x[i]) : "r"(m), "r"(c));
    } else {
#pragma unroll
      for (int i = 0; i < kPeakChains / 2; ++i)
        asm volatile("mad.wide.u32 %0, %1, %2, %0;" : "+l"(w[i]) : "r"((uint32_t)w[i]), "r"(m));
    }
  }
  if (kForm == 4) {
#pragma unroll
    for (int i = 0; i < kPeakChains / 2; ++i) {
      x[2 * i] = (uint32_t)w[i];
      x[2 * i + 1] = (uint32_t)(w[i] >> 32);
    }
  }
#pragma unroll
  for (int i = 0; i < kPeakChains; ++i) p[i] = x[i];
}

}  // namespace

// a, b, out: (n, 16) int32 device tensors, 16-byte aligned; consts: host
// FieldConsts.
extern "C" int tile_mul(const int32_t* a, const int32_t* b, int32_t* out, long long n,
                        const FieldConsts* consts, void* stream) {
  const unsigned blocks = (unsigned)((n + TILE_MUL_THREADS - 1) / TILE_MUL_THREADS);
  auto kernel = pasta_form(*consts) ? mul_kernel<true> : mul_kernel<false>;
  kernel<<<blocks, TILE_MUL_THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(a), reinterpret_cast<const int4*>(b),
      reinterpret_cast<int4*>(out), n, *consts);
  return (int)cudaGetLastError();
}

// x1, y1, z1 (projective), x2, y2 (affine) in; x3, y3, z3 out: (n, 16) int32,
// 16-byte aligned. b15: the curve's 3b is 15.
extern "C" int tile_padd(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                         const int32_t* x2, const int32_t* y2, int32_t* x3, int32_t* y3,
                         int32_t* z3, long long n, int b15, const FieldConsts* consts,
                         void* stream) {
  const PaddArgs g{reinterpret_cast<const int4*>(x1), reinterpret_cast<const int4*>(y1),
                   reinterpret_cast<const int4*>(z1), reinterpret_cast<const int4*>(x2),
                   reinterpret_cast<const int4*>(y2), reinterpret_cast<int4*>(x3),
                   reinterpret_cast<int4*>(y3),       reinterpret_cast<int4*>(z3),
                   n};
  const unsigned blocks = (unsigned)((n + TILE_PADD_THREADS - 1) / TILE_PADD_THREADS);
  auto kernel = pasta_form(*consts) && b15 != 0 ? padd_kernel<true, true>
                                                : padd_kernel<false, false>;
  kernel<<<blocks, TILE_PADD_THREADS, 0, (cudaStream_t)stream>>>(g, *consts);
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

// acc: (blocks * 256, 8) uint32 chain values, updated in place; form 0-4.
extern "C" int mul_peak(uint32_t* acc, int blocks, int iters, int form, uint32_t m, uint32_t c,
                        void* stream) {
  void (*kernels[])(uint32_t*, int, uint32_t, uint32_t) = {
      mul_peak_kernel<0>, mul_peak_kernel<1>, mul_peak_kernel<2>, mul_peak_kernel<3>,
      mul_peak_kernel<4>};
  if (form < 0 || form > 4) return (int)cudaErrorInvalidValue;
  kernels[form]<<<blocks, kPeakThreads, 0, (cudaStream_t)stream>>>(acc, iters, m, c);
  return (int)cudaGetLastError();
}
