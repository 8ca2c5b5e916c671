// Kernel 8: one level of the mixed-radix (four-step) NTT.
//
// Replaces halo2_tpu/ops/ntt_pallas.py::_col_ntt_kernel (defined at :233,
// pallas_call at :392). x is a (B, f, g) array of elements (16 int32 limbs
// each): for every column (b, j2) it reads the f rows j1 in bit-reversed
// order (slot r holds row rev(r)) and runs log2(f) radix-2
// decimation-in-time stages: at stage s, m = 2^s, butterfly i < f/2 pairs
// slots
//     lo = (i / m) * 2m + (i mod m),   hi = lo + m
//     x[lo], x[hi] = x[lo] + t, x[lo] - t,   t = stw[s][i] * x[hi]
// (stage 0's twiddles are all 1: t = x[hi], no product), which leaves slot r
// holding DFT row k1 = r; when an inter-level table is given, row k1 of
// column (b, j2) is then multiplied by inter[j2][k1]. The store writes row k1:
// - without perm, to (b, k1, j2) of a (B, f, g) output, the layout the next
//   level reads as (B f, f', g') columns;
// - with perm (the last level, g = 1), to k1 * B + perm[b] of an (f, B)
//   output, which puts the whole transform in natural order.
// So a transform is its levels' launches (ops/ntt_mr.py). It is its own
// kernel, not kernel 1's: the constant-geometry kernel pairs slots i and
// i + f/2 at every stage and emits bit-reversed slots; this one keeps the
// TPU kernel's radix-2 schedule and tables, so its integers are
// mr_col_ntt_plain's.
//
// What bounds it on an H100: each element is read once and written once per
// level (64 B in 16-bit limbs each way), and its inter-level twiddle is read
// once (64 B more). Counting only twiddles other than 1, the stages take 3.0
// Montgomery products per element at f = 256 and the inter-level twiddle
// 1.0, at 176 32-bit multiply instructions each on the Pasta moduli: 704
// instructions per 192 B, below the card's 5 multiply instructions per byte
// of device memory, so a level is bound by bytes (3.8 us at the first level
// of 2^16). What the first port lost was latency: one dependent fe_mul
// (about 1 650 cycles on one thread) a stage, 8- to 16-way bank conflicts
// (element-major shared memory), a twiddle read from device memory inside
// the chain, an extra barrier pass for the inter-level twiddle and a store
// pass through shared memory, and five torch copies a transform around it.
// This design, on kernel 1's (ntt_cg.cu):
// - a thread owns one butterfly (f/2 threads a column) and loads slots 2t,
//   2t + 1 (rows rev(2t) and rev(2t) + f/2, at stride g) and stage 1's
//   twiddle as 12 16-byte loads in flight at once; stage 0 pairs exactly
//   those two slots, so it runs in registers with no product and no
//   barrier;
// - stages 1 .. log2(f) - 1 run in place in shared memory, one barrier a
//   stage, none after the last. A column is word-major (word l of slot r at
//   l * f + r), its stride 8 f + 1 words, so that the columns of one warp
//   (f < 64) start in other banks. Stages 1-4 pair slots 2-16 apart, so a
//   warp's 32 loads of one word fall two to a bank; an XOR swizzle that
//   spreads them over 32 banks was no faster on an H100 at f = 64 or 256,
//   so the layout stays plain;
// - f is a template parameter (one kernel for each f = 2 .. 1024): the
//   stage loop is unrolled and its addresses are constants, which on an
//   H100 was clearly faster than one loop over a runtime f;
// - reads the next stage's twiddle while a stage multiplies, and the last
//   stage's inter-level twiddles while the last stage multiplies;
// - the last stage's two slots, t and t + f/2, are rows k1 = t and t + f/2:
//   they are multiplied by their inter-level twiddle in registers and stored
//   straight to device memory, with no further barrier or pass;
// - multiplies with fe_mul_cc (the Pasta form for Fp and Fq; FrBn keeps the
//   general form) and adds with fe_add_cc / fe_sub_cc (field.cuh), the same
//   integers as fe_mul / fe_add / fe_sub.
// A thread's chain at f = 256 is 7 stage products and 2 inter-level ones.
// Geometry: max(1, threads / (f/2)) columns a block; the wrapper picks
// threads (ops/ntt_mr.py LEVEL_THREADS, from a sweep). ptxas (sm_90a): 56-96
// registers by f and field (80 at f = 256 in the Pasta form, 90 for FrBn),
// no spills, no stack.
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kMaxLogF = 10;  // f <= 1024

__device__ __forceinline__ Fe sm_load(const uint32_t* colm, int f, int r) {
  Fe a;
#pragma unroll
  for (int l = 0; l < 8; ++l) a.v[l] = colm[l * f + r];
  return a;
}

__device__ __forceinline__ void sm_store(uint32_t* colm, int f, int r, const Fe& a) {
#pragma unroll
  for (int l = 0; l < 8; ++l) colm[l * f + r] = a.v[l];
}

template <bool kPasta, int log_f>
__global__ void mr_level_kernel(const int4* __restrict__ x, int4* __restrict__ y,
                                const int4* __restrict__ stw, const int4* __restrict__ inter,
                                const int32_t* __restrict__ perm, long long cols, int log_g,
                                int cpb, FieldConsts k) {
  extern __shared__ uint32_t sm[];  // cpb columns of 8 f + 1 words
  constexpr int f = 1 << log_f;
  constexpr int half = f >> 1;
  const int c = threadIdx.x >> (log_f - 1);  // the block's column of this thread
  const int t = threadIdx.x & (half - 1);    // its butterfly
  const long long col = (long long)blockIdx.x * cpb + c;  // cpb divides cols: no block is short
  const long long gm = (1LL << log_g) - 1;
  // column (b, j2): element j1 at b f g + j1 g + j2
  const long long base = ((col >> log_g) << (log_f + log_g)) + (col & gm);
  const int4* itw = inter != nullptr ? inter + ((col & gm) << log_f) * 4 : nullptr;  // row j2
  uint32_t* colm = sm + c * (8 * f + 1);

  // slots 2t and 2t + 1: rows rev(2t) and rev(2t) + f/2; stage 1's twiddle
  const long long r0 = __brev((unsigned)(2 * t)) >> (32 - log_f);
  int4 v[8], tw[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    v[u] = x[(base + (r0 << log_g)) * 4 + u];
    v[4 + u] = x[(base + ((r0 + half) << log_g)) * 4 + u];
  }
  if (log_f > 1) {
#pragma unroll
    for (int u = 0; u < 4; ++u) tw[u] = stw[((long long)half + t) * 4 + u];
  }
  Fe lo, hi;
  {
    const Fe a = fe_load16_v(v), b = fe_load16_v(v + 4);
    lo = fe_add_cc(a, b, k);  // stage 0: t = x[hi]
    hi = fe_sub_cc(a, b, k);
  }
  int slo = 2 * t, shi = 2 * t + 1;
  if (log_f == 1 && inter != nullptr) {
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = itw[u];  // rows 0 and 1
  }
  if (log_f > 1) {
    sm_store(colm, f, slo, lo);
    sm_store(colm, f, shi, hi);
    __syncthreads();
#pragma unroll
    for (int s = 1; s < log_f; ++s) {
      const Fe w = fe_load16_v(tw);
      if (s + 1 < log_f) {  // the next stage's twiddle, read while this stage multiplies
#pragma unroll
        for (int u = 0; u < 4; ++u) tw[u] = stw[((long long)(s + 1) * half + t) * 4 + u];
      } else if (inter != nullptr) {  // the last stage's slots t, t + f/2 are rows t, t + f/2
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          v[u] = itw[(long long)t * 4 + u];
          v[4 + u] = itw[(long long)(t + half) * 4 + u];
        }
      }
      const int m = 1 << s;
      slo = ((t >> s) << (s + 1)) | (t & (m - 1));
      shi = slo + m;
      const Fe a = sm_load(colm, f, slo);
      const Fe tt = fe_mul_cc<kPasta>(sm_load(colm, f, shi), w, k);
      lo = fe_add_cc(a, tt, k);
      hi = fe_sub_cc(a, tt, k);
      if (s + 1 < log_f) {
        sm_store(colm, f, slo, lo);
        sm_store(colm, f, shi, hi);
        __syncthreads();
      }
    }
  }
  // slots slo, shi are rows k1 = slo, shi: the inter-level twiddle, then
  // straight to device memory
  if (inter != nullptr) {
    lo = fe_mul_cc<kPasta>(lo, fe_load16_v(v), k);
    hi = fe_mul_cc<kPasta>(hi, fe_load16_v(v + 4), k);
  }
  const long long e0 = perm != nullptr ? perm[col] + (long long)slo * cols : base + ((long long)slo << log_g);
  const long long e1 = perm != nullptr ? perm[col] + (long long)shi * cols : base + ((long long)shi << log_g);
  fe_store16_v(y + e0 * 4, lo);
  fe_store16_v(y + e1 * 4, hi);
}

using Kernel = void (*)(const int4*, int4*, const int4*, const int4*, const int32_t*, long long,
                       int, int, FieldConsts);

template <bool kPasta>
Kernel kernel_for(int log_f) {
  switch (log_f) {
    case 1: return mr_level_kernel<kPasta, 1>;
    case 2: return mr_level_kernel<kPasta, 2>;
    case 3: return mr_level_kernel<kPasta, 3>;
    case 4: return mr_level_kernel<kPasta, 4>;
    case 5: return mr_level_kernel<kPasta, 5>;
    case 6: return mr_level_kernel<kPasta, 6>;
    case 7: return mr_level_kernel<kPasta, 7>;
    case 8: return mr_level_kernel<kPasta, 8>;
    case 9: return mr_level_kernel<kPasta, 9>;
    default: return mr_level_kernel<kPasta, 10>;
  }
}

}  // namespace

// x, y: (B, f, g, 16) int32 device tensors (y (f, B, 16) with perm), B g =
// cols, g = 2^log_g; stw: (log_f, f/2, 16); inter: (g, f, 16) or null; perm:
// (B,) int32 or null (with perm, g = 1); threads: threads a block at most
// (f/2 a column); consts: host FieldConsts. Returns cudaGetLastError().
extern "C" int mr_col_ntt(const int32_t* x, int32_t* y, const int32_t* stw, const int32_t* inter,
                          const int32_t* perm, long long cols, int log_f, int log_g, int threads,
                          const FieldConsts* consts, void* stream) {
  if (log_f < 1 || log_f > kMaxLogF) return (int)cudaErrorInvalidValue;
  const int f = 1 << log_f;
  const int half = f >> 1;
  // cols, threads and f/2 are powers of two, so cpb divides cols
  long long cpb = threads / half;
  if (cpb < 1) cpb = 1;
  if (cpb > cols) cpb = cols;
  const size_t smem = (size_t)cpb * (8 * f + 1) * sizeof(uint32_t);
  const bool pasta = pasta_form(*consts);
  const Kernel kernel = pasta ? kernel_for<true>(log_f) : kernel_for<false>(log_f);
  static size_t smem_set[2][kMaxLogF] = {};
  size_t& set = smem_set[pasta][log_f - 1];
  if (smem > 48 * 1024 && smem > set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    set = smem;
  }
  const long long blocks = cols / cpb;
  kernel<<<(unsigned)blocks, (unsigned)(cpb * half), smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(x), reinterpret_cast<int4*>(y),
      reinterpret_cast<const int4*>(stw), reinterpret_cast<const int4*>(inter), perm, cols,
      log_g, (int)cpb, *consts);
  return (int)cudaGetLastError();
}
