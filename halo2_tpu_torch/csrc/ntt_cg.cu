// Kernel 1: one level of the constant-geometry (Pease) NTT.
//
// Replaces halo2_tpu/ops/ntt_pallas2.py::_cg_kernel (pallas_call at :219).
// For every column of x (cols, f, 16) it runs log2(f) stages of
//     y[2i]   = x[i] + tw_s[i] * x[i + f/2]
//     y[2i+1] = x[i] - tw_s[i] * x[i + f/2]        i < f/2
// and then, when an inter-level table is given, multiplies row r of column
// j by inter[j mod g][r]. Rows come out in bit-reversed slot order; the
// torch wrapper (ops/ntt_cg.py) owns the level structure and the gathers.
//
// What bounds it on an H100: each element is read once and written once per
// level (64 B in 16-bit limbs), and every stage does one Montgomery product
// per butterfly (64 word multiplies of the CIOS loop plus 64 for the
// reduction). At f = 256 that is 8 products per element read, so the level
// is bound by integer multiply throughput, not by device memory. The design
// keeps a column's f values (f * 32 B, 8 KB at f = 256) in shared memory for
// all stages, so a level touches device memory once each way; the loads and
// stores are word-pair (int2) accesses on consecutive addresses.
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void cg_level_kernel(const int2* __restrict__ x, int2* __restrict__ y,
                                const int32_t* __restrict__ stw,
                                const int32_t* __restrict__ inter, long long cols,
                                int log_f, long long g, int cpb, FieldConsts k) {
  extern __shared__ uint32_t sm[];  // cpb columns x f elements x 8 words
  const int f = 1 << log_f;
  const int half = f >> 1;
  const long long col0 = (long long)blockIdx.x * cpb;
  const long long ncols = (cols - col0) < cpb ? (cols - col0) : cpb;
  const int nwords = (int)ncols * f * 8;  // 32-bit words of this block's columns

  // load: one int2 = two 16-bit limbs = one 32-bit word
  const int2* src = x + col0 * f * 8;
  for (int w = threadIdx.x; w < nwords; w += blockDim.x) {
    int2 v = src[w];
    sm[w] = (uint32_t)v.x | ((uint32_t)v.y << 16);
  }
  __syncthreads();

  const int c = threadIdx.x / half;  // local column of this thread's butterfly
  const int i = threadIdx.x % half;
  const bool active = c < ncols;
  uint32_t* colm = sm + (size_t)c * f * 8;
  for (int s = 0; s < log_f; ++s) {
    Fe a, b;
    if (active) {
      Fe lo = fe_from(colm + i * 8);
      Fe hi = fe_from(colm + (i + half) * 8);
      Fe tw = fe_load16(stw + ((long long)s * half + i) * 16, 1);
      Fe t = fe_mul(hi, tw, k);
      a = fe_add(lo, t, k);
      b = fe_sub(lo, t, k);
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        colm[(2 * i) * 8 + l] = a.v[l];
        colm[(2 * i + 1) * 8 + l] = b.v[l];
      }
    }
    __syncthreads();
  }

  if (inter != nullptr && active) {
    const long long j2 = (col0 + c) % g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = i + h * half;
      Fe v = fe_from(colm + r * 8);
      Fe tw = fe_load16(inter + (j2 * f + r) * 16, 1);
      v = fe_mul(v, tw, k);
#pragma unroll
      for (int l = 0; l < 8; ++l) colm[r * 8 + l] = v.v[l];
    }
  }
  __syncthreads();

  int2* dst = y + col0 * f * 8;
  for (int w = threadIdx.x; w < nwords; w += blockDim.x) {
    uint32_t v = sm[w];
    dst[w] = make_int2((int)(v & 0xFFFFu), (int)(v >> 16));
  }
}

}  // namespace

// x, y: (cols, f, 16) int32 device tensors; stw: (log_f, f/2, 16);
// inter: (g, f, 16) or null; consts: host FieldConsts.
extern "C" int cg_ntt_level(const int32_t* x, int32_t* y, const int32_t* stw,
                            const int32_t* inter, long long cols, int log_f,
                            long long g, const FieldConsts* consts, void* stream) {
  const int f = 1 << log_f;
  const int half = f >> 1;
  int cpb = kThreads / half;
  if (cpb < 1) cpb = 1;
  const int threads = cpb * half;
  const size_t smem = (size_t)cpb * f * 8 * sizeof(uint32_t);
  const long long blocks = (cols + cpb - 1) / cpb;
  cg_level_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const int2*>(x), reinterpret_cast<int2*>(y), stw, inter, cols,
      log_f, g, cpb, *consts);
  return (int)cudaGetLastError();
}
