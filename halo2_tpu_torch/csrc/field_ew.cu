// Kernel A: elementwise Montgomery product, sum and difference over limb
// tensors with broadcasting.
//
// Replaces the jitted field ops of halo2_tpu/ops/field_jax.py:75-78
// (ctx.mul / ctx.add / ctx.sub, bodies mont_mul :182, add_mod :211 and
// sub_mod :230), which XLA fuses into every program that calls them. In the
// port they are ops/field.py's mont_mul, add_mod and sub_mod on CUDA
// tensors: the prover's eager limb arithmetic (FVec's operators, the grand
// products' elementwise terms, the Horner fold, the full quotient fold,
// MockProver's vectorised check, the mesh's twiddle product).
//
// One thread an element: its two operands are loaded as four 16-byte
// vectors each from (..., 16) int32 limb tensors in the lazy domain
// [0, 2p), combined with field.cuh's carry-chain forms and stored as four
// vectors into a contiguous output:
// - op 0, the product fe_mul_cc<kPasta>: (a b + M p) / 2^256 with no final
//   subtraction, the integer ops/field.py's plain _mont_mul32 returns;
//   kPasta for a modulus of pasta_form (Fp, Fq), chosen on the host as
//   kernel 1 does, the generic form for BN254's FrBn and FqBn;
// - op 1, fe_add_cc: a + b, less 2p when that is at least 2p, modulo 2^256
//   (the carry out of 2^256 kept, as the plain add_mod keeps it);
// - op 2, fe_sub_cc: a - b, plus 2p when b > a, modulo 2^256.
// So every output is the plain version's limbs, bit for bit.
//
// Broadcasting: the wrapper (ops/field_ew.py launch_args) collapses the
// broadcast shape to at most four dimensions and passes each operand's
// stride of each dimension in int32 units; a broadcast dimension has stride
// 0, so an expanded operand is read where it lies and never copied.
//
// What bounds it on an H100: a product reads 128 and writes 64 bytes for
// one Montgomery product, about 17 ps of the card's multiply pipe against
// 57 ps of its memory at 3.35 TB/s, so the product, the sum and the
// difference are all bound by bytes. The design keeps each element's
// 192 bytes in 16-byte vectors and nothing else in memory.
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDims = 4;

struct EwArgs {
  const int32_t* a;
  const int32_t* b;
  int32_t* out;
  long long size[kDims];  // the collapsed shape, outermost first
  long long sa[kDims];    // a's stride of each dimension, in int32 units
  long long sb[kDims];
  long long n;            // elements: the product of size
};

template <int kOp, bool kPasta>
__global__ void __launch_bounds__(kThreads) ew_kernel(EwArgs g, FieldConsts k) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= g.n) return;
  long long r = e, oa = 0, ob = 0;
#pragma unroll
  for (int d = kDims - 1; d > 0; --d) {
    const long long s = g.size[d];
    const long long i = s == 1 ? 0 : r % s;
    r = s == 1 ? r : r / s;
    oa += i * g.sa[d];
    ob += i * g.sb[d];
  }
  oa += r * g.sa[0];
  ob += r * g.sb[0];
  const Fe x = fe_load16_v(reinterpret_cast<const int4*>(g.a + oa));
  const Fe y = fe_load16_v(reinterpret_cast<const int4*>(g.b + ob));
  Fe z;
  if (kOp == 0)
    z = fe_mul_cc<kPasta>(x, y, k);
  else if (kOp == 1)
    z = fe_add_cc(x, y, k);
  else
    z = fe_sub_cc(x, y, k);
  fe_store16_v(reinterpret_cast<int4*>(g.out + 16 * e), z);
}

}  // namespace

// op: 0 product, 1 sum, 2 difference; size / sa / sb: kDims entries each.
extern "C" int field_ew(int op, const int32_t* a, const int32_t* b, int32_t* out,
                        const long long* size, const long long* sa, const long long* sb,
                        long long n, const FieldConsts* consts, void* stream) {
  if (op < 0 || op > 2 || n <= 0) return (int)cudaErrorInvalidValue;
  EwArgs g;
  g.a = a;
  g.b = b;
  g.out = out;
  g.n = n;
  for (int d = 0; d < kDims; ++d) {
    g.size[d] = size[d];
    g.sa[d] = sa[d];
    g.sb[d] = sb[d];
  }
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (op == 0) {
    auto kernel = pasta_form(*consts) ? ew_kernel<0, true> : ew_kernel<0, false>;
    kernel<<<(unsigned)blocks, kThreads, 0, s>>>(g, *consts);
  } else if (op == 1) {
    ew_kernel<1, false><<<(unsigned)blocks, kThreads, 0, s>>>(g, *consts);
  } else {
    ew_kernel<2, false><<<(unsigned)blocks, kThreads, 0, s>>>(g, *consts);
  }
  return (int)cudaGetLastError();
}
