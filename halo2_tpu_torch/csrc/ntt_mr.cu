// Kernel 8: one level of the mixed-radix (four-step) NTT.
//
// Replaces halo2_tpu/ops/ntt_pallas.py::_col_ntt_kernel (defined at :233,
// pallas_call at :392). For every column of x (cols, f, 16) it reads the f
// rows in bit-reversed order, runs log2(f) radix-2 decimation-in-time
// stages: at stage s, m = 2^s, butterfly i < f/2 pairs rows
//     lo = (i / m) * 2m + (i mod m),   hi = lo + m
//     x[lo], x[hi] = x[lo] + t, x[lo] - t,   t = stw[s][i] * x[hi]
// (stage 0's twiddles are all 1: t = x[hi], no product), which leaves the
// rows in natural order, and then, when an inter-level table is given,
// multiplies row r of column c by inter[c mod g][r]. The torch wrapper
// (ops/ntt_mr.py) owns the level structure and the transposes between
// levels. It is its own kernel, not kernel 1's: the constant-geometry
// kernel pairs rows i and i + f/2 at every stage and emits bit-reversed slots.
//
// What bounds it on an H100: each element is read once and written once per
// level (64 B in 16-bit limbs), and its inter-level twiddle is read once
// (64 B more). Counting only twiddles other than 1, as for kernel 1, the
// stages take 3.0 Montgomery products per element at f = 256 and the
// inter-level twiddle 1.0, at 176 32-bit multiply instructions each on the
// Pasta moduli: 704 instructions per 192 B, below the card's 5 multiply
// instructions per byte of device memory, so a level is bound by bytes, with
// multiplies close behind. The design
// keeps a column's f values (f * 32 B, 8 KB at f = 256) in shared memory for
// all stages, one thread per butterfly and one __syncthreads per stage, so a
// level touches device memory once each way; the bit reversal costs nothing
// extra, as it is the address of the load. Several columns share a block
// when f is small, so every block has 256 threads. FieldConsts comes by
// value, so the same kernel serves Fp, Fq and FrBn (field.cuh states the
// bounds for each).
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void mr_col_kernel(const int2* __restrict__ x, int2* __restrict__ y,
                              const int32_t* __restrict__ stw,
                              const int32_t* __restrict__ inter, long long cols,
                              int log_f, long long g, int cpb, FieldConsts k) {
  extern __shared__ uint32_t sm[];  // cpb columns x f elements x 8 words
  const int f = 1 << log_f;
  const int half = f >> 1;
  const long long col0 = (long long)blockIdx.x * cpb;
  const long long ncols = (cols - col0) < cpb ? (cols - col0) : cpb;
  const int nwords = (int)ncols * f * 8;  // 32-bit words of this block's columns

  // load: word w of element (c, r) of shared memory comes from row rev(r) of
  // column c; one int2 = two 16-bit limbs = one 32-bit word
  const int2* src = x + col0 * f * 8;
  for (int w = threadIdx.x; w < nwords; w += blockDim.x) {
    const int e = w >> 3;
    const int r = e & (f - 1);
    const int c = e >> log_f;
    const int rr = (int)(__brev((unsigned)r) >> (32 - log_f));
    int2 v = src[((long long)c * f + rr) * 8 + (w & 7)];
    sm[w] = (uint32_t)v.x | ((uint32_t)v.y << 16);
  }
  __syncthreads();

  const int c = threadIdx.x / half;  // local column of this thread's butterfly
  const int i = threadIdx.x % half;
  const bool active = c < ncols;
  uint32_t* colm = sm + (size_t)c * f * 8;
  for (int s = 0; s < log_f; ++s) {
    if (active) {
      const int m = 1 << s;
      const int lo = ((i >> s) << (s + 1)) | (i & (m - 1));
      const int hi = lo + m;
      Fe a = fe_from(colm + lo * 8);
      Fe t = fe_from(colm + hi * 8);
      if (s > 0) t = fe_mul(t, fe_load16(stw + ((long long)s * half + i) * 16, 1), k);
      Fe u = fe_add(a, t, k);
      Fe v = fe_sub(a, t, k);
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        colm[lo * 8 + l] = u.v[l];
        colm[hi * 8 + l] = v.v[l];
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
      v = fe_mul(v, fe_load16(inter + (j2 * f + r) * 16, 1), k);
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

// x, y: (cols, f, 16) int32 device tensors, f = 2^log_f with 1 <= log_f <= 10;
// stw: (log_f, f/2, 16); inter: (g, f, 16) or null; consts: host FieldConsts.
extern "C" int mr_col_ntt(const int32_t* x, int32_t* y, const int32_t* stw,
                          const int32_t* inter, long long cols, int log_f, long long g,
                          const FieldConsts* consts, void* stream) {
  const int f = 1 << log_f;
  const int half = f >> 1;
  int cpb = kThreads / half;
  if (cpb < 1) cpb = 1;
  const int threads = cpb * half;
  const size_t smem = (size_t)cpb * f * 8 * sizeof(uint32_t);
  const long long blocks = (cols + cpb - 1) / cpb;
  mr_col_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const int2*>(x), reinterpret_cast<int2*>(y), stw, inter, cols,
      log_f, g, cpb, *consts);
  return (int)cudaGetLastError();
}
