// Kernel H: the Horner fold of the quotient's pieces by x^n,
// acc = (...(s_0 x + s_1) x + ...) x + s_{M-1}, over (n, 16) limb tensors.
//
// Replaces the device program that XLA compiles from the JAX package's
// jitted fold (halo2_tpu/ops/polyeval.py:113 _horner_fold_kernel, called by
// horner_fold_mont at :122): in the port it ran as M - 1 products and
// M - 1 sums of kernel A over the pieces stacked by a torch copy. Here a
// thread folds one row of every piece in registers, the pieces reached by
// pointers in the launch's __grid_constant__ parameters (in the order the
// fold takes them: plonk/vanishing.py passes the last piece first) and x
// by value, so a call is one launch that copies nothing.
//
// The products are fe_mul_cc<kPasta> (the Pasta form chosen on the host),
// the sums fe_add_cc: every output lies in the lazy domain [0, 2p) and
// equals the plain version (ops/polyeval.py horner_fold_mont_plain, kernel
// A's products and sums) bit for bit, since both take the same operations
// in the same order on the same words.
//
// What bounds it on an H100: its bytes, M + 1 rows of 64 bytes a row (the
// pieces read once, the fold written once), against M - 1 products a row;
// at n = 2^14 and M = 3 that is 3 microseconds of memory. A thread's
// products run one after another, so a row's chain is M - 1 products; the
// next piece's row is loaded before each product.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

constexpr int kMaxPieces = 64;
constexpr int kHornerThreads = 128;

}  // namespace

// The launch's parameters (mirrored by ops/polyeval.py's HornerParams).
struct HornerParams {
  const int32_t* pieces[kMaxPieces];  // (n, 16) each, in the fold's order
  int32_t* out;                       // (n, 16)
  long long n;
  int m;                              // pieces, 2 .. kMaxPieces
  uint32_t x[8];                      // Montgomery words
  FieldConsts k;
};
static_assert(sizeof(HornerParams) <= 4096, "a kernel's parameters fit 4 KB");

namespace {

template <bool kPasta>
__global__ void __launch_bounds__(kHornerThreads) pieces_horner_kernel(const __grid_constant__ HornerParams p) {
  const long long r = (long long)blockIdx.x * kHornerThreads + threadIdx.x;
  if (r >= p.n) return;
  const FieldConsts& k = p.k;
  const Fe x = fe_from(p.x);
  Fe acc = row_load(p.pieces[0], r);
  Fe next = row_load(p.pieces[1], r);
#pragma unroll 1
  for (int i = 1; i < p.m; ++i) {
    const Fe s = next;
    if (i + 1 < p.m) next = row_load(p.pieces[i + 1], r);
    acc = fe_add_cc(fe_mul_cc<kPasta>(acc, x, k), s, k);
  }
  row_store(p.out, r, acc);
}

}  // namespace

extern "C" int horner_params_size() { return (int)sizeof(HornerParams); }

extern "C" int horner_fold(const HornerParams* params, void* stream) {
  const HornerParams& p = *params;
  const long long blocks = (p.n + kHornerThreads - 1) / kHornerThreads;
  if (p.n <= 0 || blocks > 0x7FFFFFFFLL || p.m < 2 || p.m > kMaxPieces || p.out == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < p.m; ++i)
    if (p.pieces[i] == nullptr) return (int)cudaErrorInvalidValue;
  auto kernel = pasta_form(p.k) ? pieces_horner_kernel<true> : pieces_horner_kernel<false>;
  kernel<<<(unsigned)blocks, kHornerThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
