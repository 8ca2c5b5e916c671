// Kernel B: the quotient fold of one part in one launch.
//
// Replaces the device program that XLA compiles from the JAX package's
// fold (halo2_tpu/plonk/evaluation.py:290-405, jax.jit at :412): every
// constraint of the clusters a part fires, scaled by its power of y and
// summed into its cluster's accumulator, over the part's rows. The port
// records that fold once as a program (ops/fold.py) and this kernel
// interprets it: one thread a row runs every instruction on its row.
//
// Instructions are four int32 (op, dst, a, b), read by every thread of the
// grid at the same address:
//   LOAD     slot[dst] = array a at row (i + b) mod n (b the rotation,
//            torch.roll's rule over the n local rows)
//   SCALAR   slot[dst] = scalar table entry a
//   COSET_X  slot[dst] = the coset point of row i
//   ADD, SUB, MUL  slot[dst] = slot[a] op slot[b]
//   NEG      slot[dst] = 0 - slot[a]
//   ACC      output dst (a cluster) at row i = slot[a]
// The arithmetic is kernel A's (fe_mul_cc<kPasta>, fe_add_cc, fe_sub_cc;
// the Pasta form chosen on the host as kernel 1 does), so each output row
// is the eager fold's limbs, bit for bit.
//
// What bounds it on an H100: for the folds of the proofs here the
// products, not the bytes (a part reads each column once and writes each
// cluster once, 64 bytes a row each, against tens to hundreds of products
// a row). This first version is simple: the slots are an array in the
// thread's local memory (kSlots of them, the smallest class that holds the
// program's live values), each instruction is decoded by a switch, the
// columns are read through a device table of pointers with 16-byte vector
// loads, a row's loads are not coalesced with its neighbours' beyond what
// the L1 cache gives, and at k = 14 a part has only 2^14 rows, so 2^14
// threads: 128 blocks of 128, under one block an SM.
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 128;
enum Op { kLoad = 0, kScalar, kCosetX, kAdd, kSub, kMul, kNeg, kAcc };

template <int kSlots, bool kPasta>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const int4* __restrict__ prog, int len, const int32_t* const* __restrict__ arrays,
            const int32_t* __restrict__ coset_x, const int32_t* __restrict__ scalars,
            int32_t* __restrict__ out, long long n, FieldConsts k) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  Fe slot[kSlots];
#pragma unroll 1
  for (int pc = 0; pc < len; ++pc) {
    const int4 ins = __ldg(prog + pc);
    switch (ins.x) {
      case kLoad: {
        long long r = (row + ins.w) % n;
        if (r < 0) r += n;
        slot[ins.y] = fe_load16_v(reinterpret_cast<const int4*>(arrays[ins.z] + 16 * r));
        break;
      }
      case kScalar:
        slot[ins.y] = fe_load16_v(reinterpret_cast<const int4*>(scalars + 16 * (long long)ins.z));
        break;
      case kCosetX:
        slot[ins.y] = fe_load16_v(reinterpret_cast<const int4*>(coset_x + 16 * row));
        break;
      case kAdd:
        slot[ins.y] = fe_add_cc(slot[ins.z], slot[ins.w], k);
        break;
      case kSub:
        slot[ins.y] = fe_sub_cc(slot[ins.z], slot[ins.w], k);
        break;
      case kMul:
        slot[ins.y] = fe_mul_cc<kPasta>(slot[ins.z], slot[ins.w], k);
        break;
      case kNeg:
        slot[ins.y] = fe_sub_cc(fe_zero(), slot[ins.z], k);
        break;
      default:  // kAcc
        fe_store16_v(reinterpret_cast<int4*>(out + 16 * ((long long)ins.y * n + row)), slot[ins.z]);
        break;
    }
  }
}

template <int kSlots>
cudaError_t launch(bool pasta, const int4* prog, int len, const int32_t* const* arrays,
                   const int32_t* coset_x, const int32_t* scalars, int32_t* out, long long n,
                   const FieldConsts& k, cudaStream_t s) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  auto kernel = pasta ? fold_kernel<kSlots, true> : fold_kernel<kSlots, false>;
  kernel<<<(unsigned)blocks, kThreads, 0, s>>>(prog, len, arrays, coset_x, scalars, out, n, k);
  return cudaGetLastError();
}

}  // namespace

// prog: len instructions of four int32; arrays: a device table of the
// columns' pointers; slots: 8, 16, 32, 64 or 128, at least the program's
// live slots (the wrapper checks).
extern "C" int fold_program(const int32_t* prog, int len, const int32_t* const* arrays,
                            const int32_t* coset_x, const int32_t* scalars, int32_t* out,
                            long long n, int slots, const FieldConsts* consts, void* stream) {
  if (n <= 0 || (n + kThreads - 1) / kThreads > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const int4* p = reinterpret_cast<const int4*>(prog);
  const bool pasta = pasta_form(*consts);
  cudaStream_t s = (cudaStream_t)stream;
  switch (slots) {
    case 8: return (int)launch<8>(pasta, p, len, arrays, coset_x, scalars, out, n, *consts, s);
    case 16: return (int)launch<16>(pasta, p, len, arrays, coset_x, scalars, out, n, *consts, s);
    case 32: return (int)launch<32>(pasta, p, len, arrays, coset_x, scalars, out, n, *consts, s);
    case 64: return (int)launch<64>(pasta, p, len, arrays, coset_x, scalars, out, n, *consts, s);
    case 128: return (int)launch<128>(pasta, p, len, arrays, coset_x, scalars, out, n, *consts, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
