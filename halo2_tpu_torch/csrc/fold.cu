// Kernel B: the quotient fold of one part in one launch.
//
// Replaces the device program that XLA compiles from the JAX package's
// fold (halo2_tpu/plonk/evaluation.py:290-405, jax.jit at :412): every
// constraint of the clusters a part fires, scaled by its power of y and
// summed into its cluster's accumulator, over the part's rows. The port
// records that fold once as a program (ops/fold.py) and this kernel
// interprets it over the part's rows. The same kernel, over one row,
// computes the fold's scalar table (the powers of y, beta * delta^j, the
// constants' products) from y, beta, gamma, theta and the challenges in
// one launch.
//
// The program is a list of bundles of FOLD_WIDTH instructions of one
// opcode, each two records of four int32, (op, dst, a, b) and (a's mode,
// a's rotation, b's mode, b's rotation):
//   ADD, SUB, MUL  slot[dst] = a op b
//   NEG      slot[dst] = 0 - a
//   ACC      output dst (a cluster) at row i = a
// and a bundle with fewer instructions is filled with PAD (-1), which does
// nothing. An operand is a slot (mode SLOT, a the slot), or a leaf of the
// recording read where it lies: an input column at row (i + rotation) mod n
// (COLUMN, a the column; the wrapper passes the rotation reduced to [0, n):
// torch.roll's rule over the n local rows), a scalar table entry (ENTRY, a
// the entry) or the coset point of row i (COSET). No instruction of a bundle
// depends on another of it, and none reads or writes a slot that another of
// the bundle writes (ops/fold.py schedules and allocates so).
//
// A block is FOLD_WIDTH warps over 32 rows, one row a lane: warp j runs
// instruction j of every bundle on the block's rows, and a barrier ends the
// bundle. The arithmetic is kernel A's (fe_mul_cc<kPasta>, fe_add_cc,
// fe_sub_cc; the Pasta form chosen on the host as kernel 1 does), so each
// output row is the eager fold's limbs, bit for bit.
//
// What bounds it on an H100: the products (a part reads each column once
// and writes each cluster once, 64 bytes a row each, against tens to
// hundreds of products a row). A thread's products are chains of carries
// (about 900 cycles a product on one thread), so the card stays busy only
// with many warps in flight: one thread a row gives a 2^14-row part one
// warp for each of the card's 528 schedulers. The design:
// - a bundle's instructions run on FOLD_WIDTH warps at once, so a part has
//   FOLD_WIDTH times the warps, a bundle's independent products and loads
//   run side by side, and a warp with no instruction in a bundle (a PAD)
//   waits at the barrier without taking issue slots; no lane diverges;
// - the slots live in shared memory, word-major across the block's rows
//   ([slot][word][row] in 32-bit words: a warp reading one word of one
//   slot touches 32 consecutive banks), slots x 1 KB a block, above 48 KB
//   by the opt-in; the thread's stack frame is empty;
// - a leaf takes no instruction and no slot: the instruction that uses it
//   reads it itself, 32 consecutive rows of one column (2 KB, 16-byte
//   vectors) for a warp, and issues both operands' loads before it waits on
//   either; an ACC writes 32 consecutive rows of one cluster;
// - each warp fetches its next instruction before it runs the current one;
// - the column pointers travel in the launch's parameters (a
//   __grid_constant__ struct, read with a runtime index from the constant
//   bank), so a launch copies no pointer table to the card;
// - a column's row wraps with a compare and a subtraction, not a 64-bit
//   division; rows past n repeat row n - 1 and store nothing.
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

#ifndef FOLD_WIDTH
#define FOLD_WIDTH 4
#endif

namespace {

constexpr int kW = FOLD_WIDTH;
constexpr int kRows = 32;  // rows a block, one a lane of each warp
constexpr int kThreads = kW * kRows;
constexpr int kMaxArrays = 448;
constexpr int kMaxShared = 232448;  // 227 KB, a block's most on an H100
enum Op { kPad = -1, kAdd = 3, kSub, kMul, kNeg, kAcc };
enum Mode { kSlot = 0, kColumn, kEntry, kCoset };

static_assert(kW >= 1 && kW <= 32, "FOLD_WIDTH");

}  // namespace

// The launch's parameters (mirrored by ops/fold.py's FoldParams).
struct FoldParams {
  const int4* prog;  // bundles x FOLD_WIDTH instructions, two records each
  const int32_t* coset_x;
  const int32_t* scalars;
  int32_t* out;  // (clusters, n, 16)
  long long n;
  int bundles;
  FieldConsts k;
  const int32_t* arrays[kMaxArrays];
};
static_assert(sizeof(FoldParams) <= 4096, "a kernel's parameters fit 4 KB");

namespace {

// slot d of this lane's row: word w at s[(8 d + w) kRows]
__device__ __forceinline__ Fe slot_get(const uint32_t* s, int d) {
  const uint32_t* q = s + d * 8 * kRows;
  Fe r;
#pragma unroll
  for (int w = 0; w < 8; ++w) r.v[w] = q[w * kRows];
  return r;
}

__device__ __forceinline__ void slot_put(uint32_t* s, int d, const Fe& a) {
  uint32_t* q = s + d * 8 * kRows;
#pragma unroll
  for (int w = 0; w < 8; ++w) q[w * kRows] = a.v[w];
}

// Where a leaf operand of this row lies.
__device__ __forceinline__ const int4* leaf(int mode, int v, int rot, const FoldParams& p,
                                            long long at) {
  if (mode == kColumn) {
    long long r = at + rot;
    if (r >= p.n) r -= p.n;
    return reinterpret_cast<const int4*>(p.arrays[v] + 16 * r);
  }
  if (mode == kEntry) return reinterpret_cast<const int4*>(p.scalars + 16 * (long long)v);
  return reinterpret_cast<const int4*>(p.coset_x + 16 * at);
}

__device__ __forceinline__ Fe from_limbs(const int4 (&q)[4]) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r.v[2 * i] = (uint32_t)q[i].x | ((uint32_t)q[i].y << 16);
    r.v[2 * i + 1] = (uint32_t)q[i].z | ((uint32_t)q[i].w << 16);
  }
  return r;
}

// One instruction on this lane's row: the leaf operands' 16-byte loads all
// issued before either operand is used.
template <bool kPasta>
__device__ __forceinline__ void run(uint32_t* s, const int4 ins, const int4 m, const FoldParams& p,
                                    long long at, long long row, bool live) {
  int4 ra[4], rb[4];
  const bool two = ins.x != kNeg && ins.x != kAcc;
  if (m.x != kSlot) {
    const int4* src = leaf(m.x, ins.z, m.y, p, at);
#pragma unroll
    for (int i = 0; i < 4; ++i) ra[i] = __ldg(src + i);
  }
  if (two && m.z != kSlot) {
    const int4* src = leaf(m.z, ins.w, m.w, p, at);
#pragma unroll
    for (int i = 0; i < 4; ++i) rb[i] = __ldg(src + i);
  }
  const Fe a = m.x == kSlot ? slot_get(s, ins.z) : from_limbs(ra);
  Fe b;
  if (two) b = m.z == kSlot ? slot_get(s, ins.w) : from_limbs(rb);
  switch (ins.x) {
    case kAdd:
      slot_put(s, ins.y, fe_add_cc(a, b, p.k));
      break;
    case kSub:
      slot_put(s, ins.y, fe_sub_cc(a, b, p.k));
      break;
    case kMul:
      slot_put(s, ins.y, fe_mul_cc<kPasta>(a, b, p.k));
      break;
    case kNeg:
      slot_put(s, ins.y, fe_sub_cc(fe_zero(), a, p.k));
      break;
    default:  // kAcc
      if (live) fe_store16_v(reinterpret_cast<int4*>(p.out + 16 * ((long long)ins.y * p.n + row)), a);
      break;
  }
}

template <bool kPasta>
__global__ void __launch_bounds__(kThreads) fold_kernel(const __grid_constant__ FoldParams p) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int j = threadIdx.x >> 5;  // the instruction of each bundle this warp runs
  const long long row = (long long)blockIdx.x * kRows + lane;
  const bool live = row < p.n;
  const long long at = live ? row : p.n - 1;
  uint32_t* s = smem + lane;
  const int4* prog = p.prog + 2 * j;  // instruction j of bundle bi at prog[2 kW bi]
  int4 ins = __ldg(prog), mode = __ldg(prog + 1);
#pragma unroll 1
  for (int bi = 0; bi < p.bundles; ++bi) {
    const int4 cur = ins, cur_mode = mode;
    if (bi + 1 < p.bundles) {
      ins = __ldg(prog + 2 * kW * (bi + 1));
      mode = __ldg(prog + 2 * kW * (bi + 1) + 1);
    }
    if (cur.x != kPad) run<kPasta>(s, cur, cur_mode, p, at, row, live);
    __syncthreads();
  }
}

cudaError_t launch(bool pasta, const FoldParams& p, int shared_bytes, cudaStream_t s) {
  auto kernel = pasta ? fold_kernel<true> : fold_kernel<false>;
  if (shared_bytes > 48 * 1024) {  // the opt-in, which holds for the current device only
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (p.n + kRows - 1) / kRows;
  kernel<<<(unsigned)blocks, kThreads, shared_bytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The bundle width the library was built for and the size of its
// parameter struct, which the wrapper checks against its own.
extern "C" int fold_width() { return kW; }
extern "C" int fold_params_size() { return (int)sizeof(FoldParams); }

// shared_bytes: slots x 1 KB (32 rows of 32 bytes).
extern "C" int fold_program(const FoldParams* params, int shared_bytes, void* stream) {
  const FoldParams& p = *params;
  if (p.n <= 0 || (p.n + kRows - 1) / kRows > 0x7FFFFFFFLL || shared_bytes < 0 ||
      shared_bytes > kMaxShared)
    return (int)cudaErrorInvalidValue;
  return (int)launch(pasta_form(p.k), p, shared_bytes, (cudaStream_t)stream);
}
