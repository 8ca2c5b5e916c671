// Kernel 1: one level of the constant-geometry (Pease) NTT.
//
// Replaces halo2_tpu/ops/ntt_pallas2.py::_cg_kernel (pallas_call at :219).
// x is a (B, f, g) array of elements (16 int32 limbs each): for every column
// (b, j2) it runs the size-f transform over j1 in log2(f) stages of
//     y[2i]   = x[i] + tw_s[i] * x[i + f/2]
//     y[2i+1] = x[i] - tw_s[i] * x[i + f/2]        i < f/2,
// after which slot i holds DFT index rev(i); the last stage also multiplies
// slot i of column j2 by the inter-level twiddle inter[j2][i] when one is
// given. The store writes slot i to row k1 = rev(i) of the column:
// - without perm, at (b, k1, j2) of a (B, f, g) output, the layout the next
//   level reads as (B f, g', f') columns;
// - with perm (the last level, g = 1), at k1 * B + perm[b] of an (f, B)
//   output, which puts the whole transform in natural order.
// So a transform is its levels' launches: no transpose, gather or copy runs
// between them (the first port ran five torch copies a transform).
//
// What bounds it on an H100: a level reads and writes each element once
// (64 B in 16-bit limbs each way) and reads the inter-level twiddles (as
// many bytes again), against log2(f) + 1 Montgomery products per element
// pair; at these sizes both bounds are a few microseconds. What the first
// port lost was latency: one dependent product a thread a stage (fe_mul,
// about 1 650 cycles on one thread), 8- and 16-way bank conflicts
// (element-major shared memory), a twiddle read from device memory inside
// the chain, and a store pass through shared memory. This design:
// - a thread owns one butterfly (f/2 threads a column) and loads its two
//   elements and the first stage's twiddle as 12 16-byte loads in flight at
//   once, reads the next stage's twiddle while a stage multiplies, and
//   writes its last stage's two slots straight to rows rev(2i), rev(2i+1);
// - keeps a column word-major in shared memory (word l of slot r at
//   l * f + r), so a warp's loads touch 32 banks and its paired stores
//   (slots 2i, 2i+1 as one 8-byte store) 64 consecutive words, and
//   double-buffers it: one barrier a stage, none after the last;
// - multiplies with fe_mul_cc (the Pasta form for Fp and Fq) and adds with
//   fe_add_cc / fe_sub_cc (field.cuh), the carry-chain forms (about 910 and
//   96 cycles on one thread, against fe_mul's 1 650 and fe_add's 160).
// Geometry: max(1, threads / (f/2)) columns a block; the wrapper picks
// threads (ops/ntt_cg.py LEVEL_THREADS, from a sweep). ptxas (sm_90a): 72
// registers (80 in the Pasta form), no spills.
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kMaxLogF = 9;  // f <= 512

__device__ __forceinline__ uint32_t join16(int lo, int hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ Fe fe_join(const int4* v) {
  Fe r;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    r.v[2 * u] = join16(v[u].x, v[u].y);
    r.v[2 * u + 1] = join16(v[u].z, v[u].w);
  }
  return r;
}

__device__ __forceinline__ void fe_store4(int4* d, const Fe& a) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const uint32_t lo = a.v[2 * u], hi = a.v[2 * u + 1];
    d[u] = make_int4((int)(lo & 0xFFFFu), (int)(lo >> 16), (int)(hi & 0xFFFFu), (int)(hi >> 16));
  }
}

template <bool kPasta>
__global__ void cg_level_kernel(const int4* __restrict__ x, int4* __restrict__ y,
                                const int4* __restrict__ stw, const int4* __restrict__ inter,
                                const int32_t* __restrict__ perm, long long cols, int log_f,
                                int log_g, int cpb, FieldConsts k) {
  extern __shared__ uint32_t sm[];  // two buffers of cpb columns
  const int f = 1 << log_f;
  const int half = f >> 1;
  const int colw = 8 * f;  // words of one column buffer: word l of slot r at l * f + r
  const int c = threadIdx.x >> (log_f - 1);  // the block's column of this thread
  const int i = threadIdx.x & (half - 1);    // its butterfly
  const long long col = (long long)blockIdx.x * cpb + c;  // cpb divides cols: no block is short
  const long long gm = (1LL << log_g) - 1;
  // column (b, j2): element j1 at b f g + j1 g + j2
  const long long base = ((col >> log_g) << (log_f + log_g)) + (col & gm);
  uint32_t* src = sm + c * colw;
  uint32_t* dst = src + cpb * colw;

  // elements i and i + f/2, and the first stage's twiddle, all loads in flight at once
  int4 v[8], tw[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    v[u] = x[(base + ((long long)i << log_g)) * 4 + u];
    v[4 + u] = x[(base + ((long long)(i + half) << log_g)) * 4 + u];
    tw[u] = stw[(long long)i * 4 + u];
  }
  {
    const Fe lo = fe_join(v), hi = fe_join(v + 4);
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      src[l * f + i] = lo.v[l];
      src[l * f + i + half] = hi.v[l];
    }
  }
  __syncthreads();

  for (int s = 0; s < log_f; ++s) {
    const Fe w = fe_join(tw);
    if (s + 1 < log_f) {  // the next stage's twiddle, read while this stage multiplies
#pragma unroll
      for (int u = 0; u < 4; ++u) tw[u] = stw[((long long)(s + 1) * half + i) * 4 + u];
    }
    Fe lo, hi;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      lo.v[l] = src[l * f + i];
      hi.v[l] = src[l * f + i + half];
    }
    const Fe t = fe_mul_cc<kPasta>(hi, w, k);
    Fe a = fe_add_cc(lo, t, k);
    Fe b = fe_sub_cc(lo, t, k);
    if (s + 1 < log_f) {
#pragma unroll
      for (int l = 0; l < 8; ++l)
        *reinterpret_cast<uint2*>(dst + l * f + 2 * i) = make_uint2(a.v[l], b.v[l]);
      __syncthreads();
      uint32_t* t2 = src;
      src = dst;
      dst = t2;
      continue;
    }
    // the last stage: slots 2i and 2i + 1, times the inter-level twiddle of
    // row j2, straight to rows rev(2i) and rev(2i + 1) in device memory
    if (inter != nullptr) {
      const int4* p = inter + (((col & gm) << log_f) + 2 * i) * 4;
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = p[u];
      a = fe_mul_cc<kPasta>(a, fe_join(v), k);
      b = fe_mul_cc<kPasta>(b, fe_join(v + 4), k);
    }
    const long long r0 = __brev((unsigned)(2 * i)) >> (32 - log_f);
    const long long r1 = __brev((unsigned)(2 * i + 1)) >> (32 - log_f);
    const long long e0 = perm != nullptr ? perm[col] + r0 * cols : base + (r0 << log_g);
    const long long e1 = perm != nullptr ? perm[col] + r1 * cols : base + (r1 << log_g);
    fe_store4(y + e0 * 4, a);
    fe_store4(y + e1 * 4, b);
  }
}

}  // namespace

// x, y: (B, f, g, 16) int32 device tensors (y (f, B, 16) with perm), B g =
// cols, g = 2^log_g; stw: (log_f, f/2, 16); inter: (g, f, 16) or null; perm:
// (B,) int32 or null (with perm, g = 1); threads: threads a block at most
// (f/2 a column); consts: host FieldConsts. Returns cudaGetLastError().
extern "C" int cg_ntt_level(const int32_t* x, int32_t* y, const int32_t* stw,
                            const int32_t* inter, const int32_t* perm, long long cols, int log_f,
                            int log_g, int threads, const FieldConsts* consts, void* stream) {
  if (log_f < 1 || log_f > kMaxLogF) return (int)cudaErrorInvalidValue;
  const int half = 1 << (log_f - 1);
  // cols, threads and f/2 are powers of two, so cpb divides cols
  long long cpb = threads / half;
  if (cpb < 1) cpb = 1;
  if (cpb > cols) cpb = cols;
  const size_t smem = 2 * (size_t)cpb * 8 * (1 << log_f) * sizeof(uint32_t);
  auto kernel = pasta_form(*consts) ? cg_level_kernel<true> : cg_level_kernel<false>;
  static size_t smem_set[2] = {48 * 1024, 48 * 1024};
  size_t& set = smem_set[pasta_form(*consts)];
  if (smem > set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    set = smem;
  }
  const long long blocks = (cols + cpb - 1) / cpb;
  kernel<<<(unsigned)blocks, (unsigned)(cpb * half), smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(x), reinterpret_cast<int4*>(y),
      reinterpret_cast<const int4*>(stw), reinterpret_cast<const int4*>(inter), perm, cols,
      log_f, log_g, (int)cpb, *consts);
  return (int)cudaGetLastError();
}
