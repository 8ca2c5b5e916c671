// Kernel C: prefix products and batch inversion over (n, 16) limb tensors.
//
// Replaces the device programs that XLA compiles from the JAX package's
// scans (halo2_tpu/ops/scan.py:27 prefix_product, a lax.associative_scan
// of Montgomery products; :35 exclusive_prefix_product with its `init`;
// :52 batch_invert, two scans and one Fermat inversion on the device). In
// the port they carry the grand products' z columns
// (plonk/lookup_prover.py _lookup_z, plonk/permutation_prover.py _perm_z,
// one chunk at a time with the previous chunk's last z as init) and
// FVec.invert.
//
// A reduce-then-scan over runs of kRunRows rows (csrc/scan.cuh):
// - run_product_kernel: a thread a run, the run's product in registers;
// - scan_carry_kernel: one block scans the run products into each run's
//   carry in (init times the runs before it);
// - scan_apply_kernel: a thread a run again, from its carry in, writes the
//   inclusive or exclusive products of its rows.
// batch_invert masks its zeros (the limbs 0 or p, as ops/field.py is_zero)
// to one, and its second launch also inverts the total on the card (one
// thread, the Fermat ladder a^(p - 2) over the bits of p - 2, as
// halo2_tpu/ops/scan.py:66 inv_mod does) and gives each run the inverse of
// its own product (the total's inverse times the products of the runs
// before and after it); its third launch is Montgomery's trick within the
// run: the run's prefix products in registers, then back down the run,
// each row's inverse the running inverse times the prefix before it. A
// zero row is written as zero.
//
// The products are fe_mul_cc<kPasta> (the Pasta form chosen on the host as
// kernel A does), so every output lies in the lazy domain [0, 2p) and
// equals the plain version (ops/scan.py, Hillis-Steele rounds of kernel A)
// as a value mod p, not always in its limbs: the association order differs.
//
// What bounds it on an H100: its n - 1 products (17 ps each in the Pasta
// form) and 128 bytes a row (one read, one write) are both well under a
// microsecond at n = 2^14, so a call is bound by latency: each launch is a
// chain of products on every thread (a product takes about 900 cycles on
// one thread), the carry scan 2 log2(kCarryThreads) products in series, and
// batch_invert's ladder about 380 products in series on one thread. The
// design keeps each chain short: kRunRows = 8 rows a thread, one block of
// kCarryThreads threads for the carries, no round trip to the host.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

struct ScanArgs {
  const int32_t* in;    // (n, 16)
  int32_t* out;         // (n, 16)
  int32_t* tot;         // (T, 16): run totals
  int32_t* carry;       // (T, 16): each run's carry in
  const int32_t* init;  // (16,) or null (exclusive scans only)
  long long n;
  long long runs;       // T = ceil(n / kRunRows)
};

// the limbs 0 or p: a zero of the lazy domain
__device__ __forceinline__ bool fe_is_zero(const Fe& a, const FieldConsts& k) {
  bool zero = true, isp = true;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    zero &= a.v[i] == 0;
    isp &= a.v[i] == k.p[i];
  }
  return zero || isp;
}

// a^(p - 2): square and multiply over the bits of p - 2, the top bit first
// (the word loop unrolled, so that e stays in registers)
template <bool kPasta>
__device__ __forceinline__ Fe fe_inverse(const Fe& a, const FieldConsts& k) {
  uint32_t e[8];
  uint32_t borrow = 2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t w = k.p[i];
    e[i] = w - borrow;
    borrow = w < borrow ? 1 : 0;
  }
  Fe acc = a;
  bool started = false;
#pragma unroll
  for (int w = 7; w >= 0; --w) {
    for (int b = 31; b >= 0; --b) {
      if (started) acc = fe_mul_cc<kPasta>(acc, acc, k);
      if ((e[w] >> b) & 1) {
        if (started) acc = fe_mul_cc<kPasta>(acc, a, k);
        started = true;
      }
    }
  }
  return acc;
}

// the product of each run's rows (kMask: zeros count as one; a run of
// zeros only, or past n, is one)
template <bool kPasta, bool kMask>
__global__ void __launch_bounds__(kRunThreads) run_product_kernel(ScanArgs g, FieldConsts k) {
  const long long t = (long long)blockIdx.x * kRunThreads + threadIdx.x;
  if (t >= g.runs) return;
  const long long r0 = t * kRunRows;
  Fe acc = fe_from(k.one);
  bool any = false;
#pragma unroll
  for (int j = 0; j < kRunRows; ++j) {
    if (r0 + j < g.n) {
      const Fe v = row_load(g.in, r0 + j);
      if (kMask && fe_is_zero(v, k)) continue;
      acc = any ? fe_mul_cc<kPasta>(acc, v, k) : v;
      any = true;
    }
  }
  row_store(g.tot, t, acc);
}

// one block: each run's carry in, init (or one) times the totals of the
// runs before it
template <bool kPasta>
__global__ void __launch_bounds__(kCarryThreads) scan_carry_kernel(ScanArgs g, FieldConsts k) {
  using Op = MulOp<kPasta>;
  using S = typename Op::S;
  __shared__ S sh[32];
  const Op op{k};
  const long long chunk = (g.runs + kCarryThreads - 1) / kCarryThreads;
  const long long c0 = threadIdx.x * chunk, c1 = min(c0 + chunk, g.runs);
  S agg = op.identity();
  for (long long t = c0; t < c1; ++t) {
    const S e{row_load(g.tot, t)};
    agg = t == c0 ? e : op.combine(agg, e);
  }
  S total;  // unused: every run needs only the runs before it
  S carry = block_exclusive_scan<false>(agg, op, sh, total);
  if (g.init != nullptr) carry = op.combine(S{row_load(g.init, 0)}, carry);
  for (long long t = c0; t < c1; ++t) {
    row_store(g.carry, t, carry.a);
    carry = op.combine(carry, S{row_load(g.tot, t)});
  }
}

// each run's rows from its carry in: out[i] = carry * v[r0] ... v[i]
// (kExclusive: ... v[i - 1])
template <bool kPasta, bool kExclusive>
__global__ void __launch_bounds__(kRunThreads) scan_apply_kernel(ScanArgs g, FieldConsts k) {
  const long long t = (long long)blockIdx.x * kRunThreads + threadIdx.x;
  if (t >= g.runs) return;
  const long long r0 = t * kRunRows;
  Fe acc = row_load(g.carry, t);
#pragma unroll
  for (int j = 0; j < kRunRows; ++j) {
    if (r0 + j < g.n) {
      if (kExclusive) row_store(g.out, r0 + j, acc);
      if (!kExclusive || (j + 1 < kRunRows && r0 + j + 1 < g.n))
        acc = fe_mul_cc<kPasta>(acc, row_load(g.in, r0 + j), k);
      if (!kExclusive) row_store(g.out, r0 + j, acc);
    }
  }
}

// one block: the total's inverse, and each run's inverse of its own
// product, tot[t]^-1 = total^-1 * (the runs before t) * (the runs after t),
// written over the carries
template <bool kPasta>
__global__ void __launch_bounds__(kCarryThreads) invert_carry_kernel(ScanArgs g, FieldConsts k) {
  using Op = MulOp<kPasta>;
  using S = typename Op::S;
  __shared__ S sh[32];
  __shared__ Fe inv_sh;
  const Op op{k};
  const long long chunk = (g.runs + kCarryThreads - 1) / kCarryThreads;
  const long long c0 = threadIdx.x * chunk, c1 = min(c0 + chunk, g.runs);
  S agg = op.identity();
  for (long long t = c0; t < c1; ++t) {
    const S e{row_load(g.tot, t)};
    agg = t == c0 ? e : op.combine(agg, e);
  }
  S total, total_again;
  const S before = block_exclusive_scan<false>(agg, op, sh, total);
  const S after = block_exclusive_scan<true>(agg, op, sh, total_again);
  if (threadIdx.x == 0) inv_sh = fe_inverse<kPasta>(total.a, k);
  __syncthreads();
  if (c0 >= c1) return;
  // the inverse of this chunk's product, then Montgomery's trick over the
  // chunk: prefix products into carry[], then back down
  Fe acc = fe_mul_cc<kPasta>(fe_mul_cc<kPasta>(inv_sh, before.a, k), after.a, k);
  Fe pre = row_load(g.tot, c0);
  row_store(g.carry, c0, pre);
  for (long long t = c0 + 1; t < c1; ++t) {
    pre = fe_mul_cc<kPasta>(pre, row_load(g.tot, t), k);
    row_store(g.carry, t, pre);
  }
  for (long long t = c1 - 1; t > c0; --t) {
    const Fe inv_t = fe_mul_cc<kPasta>(acc, row_load(g.carry, t - 1), k);
    acc = fe_mul_cc<kPasta>(acc, row_load(g.tot, t), k);
    row_store(g.carry, t, inv_t);
  }
  row_store(g.carry, c0, acc);
}

// each row's inverse from its run's inverse product: Montgomery's trick
// over the run's rows, zeros written as zero
template <bool kPasta>
__global__ void __launch_bounds__(kRunThreads) invert_apply_kernel(ScanArgs g, FieldConsts k) {
  const long long t = (long long)blockIdx.x * kRunThreads + threadIdx.x;
  if (t >= g.runs) return;
  const long long r0 = t * kRunRows;
  Fe pre[kRunRows];  // pre[j]: the product of the run's nonzero rows up to j
  bool zero[kRunRows];
  Fe acc = fe_from(k.one);
  bool any = false;
#pragma unroll
  for (int j = 0; j < kRunRows; ++j) {
    zero[j] = true;
    if (r0 + j < g.n) {
      const Fe v = row_load(g.in, r0 + j);
      zero[j] = fe_is_zero(v, k);
      if (!zero[j]) {
        acc = any ? fe_mul_cc<kPasta>(acc, v, k) : v;
        any = true;
      }
    }
    pre[j] = acc;
  }
  Fe inv = row_load(g.carry, t);  // the inverse of pre[kRunRows - 1]
#pragma unroll
  for (int j = kRunRows - 1; j >= 0; --j) {
    if (r0 + j >= g.n) continue;
    if (zero[j]) {
      row_store(g.out, r0 + j, fe_zero());
      continue;
    }
    // pre[j - 1] is one when no nonzero row lies before j in the run
    bool earlier = false;
#pragma unroll
    for (int i = 0; i < j; ++i) earlier |= !zero[i];
    if (earlier) {
      row_store(g.out, r0 + j, fe_mul_cc<kPasta>(inv, pre[j - 1 < 0 ? 0 : j - 1], k));
      inv = fe_mul_cc<kPasta>(inv, row_load(g.in, r0 + j), k);
    } else {
      row_store(g.out, r0 + j, inv);
    }
  }
}

template <bool kPasta>
void launch(int mode, unsigned blocks, const ScanArgs& g, const FieldConsts& k, cudaStream_t s) {
  const int threads = kRunThreads;
  if (mode == 2) {
    run_product_kernel<kPasta, true><<<blocks, threads, 0, s>>>(g, k);
    invert_carry_kernel<kPasta><<<1, kCarryThreads, 0, s>>>(g, k);
    invert_apply_kernel<kPasta><<<blocks, threads, 0, s>>>(g, k);
    return;
  }
  run_product_kernel<kPasta, false><<<blocks, threads, 0, s>>>(g, k);
  scan_carry_kernel<kPasta><<<1, kCarryThreads, 0, s>>>(g, k);
  if (mode == 0)
    scan_apply_kernel<kPasta, false><<<blocks, threads, 0, s>>>(g, k);
  else
    scan_apply_kernel<kPasta, true><<<blocks, threads, 0, s>>>(g, k);
}

}  // namespace

extern "C" int scan_run_rows() { return kRunRows; }

// mode 0: inclusive prefix products, 1: exclusive (times init, when init is
// not null), 2: batch inversion. tot and carry: (ceil(n / kRunRows), 16) scratch.
extern "C" int scan_rows(int mode, const int32_t* in, int32_t* out, int32_t* tot, int32_t* carry,
                         const int32_t* init, long long n, const FieldConsts* consts, void* stream) {
  if (mode < 0 || mode > 2 || n <= 0) return (int)cudaErrorInvalidValue;
  ScanArgs g{in, out, tot, carry, init, n, (n + kRunRows - 1) / kRunRows};
  const long long blocks = (g.runs + kRunThreads - 1) / kRunThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const FieldConsts& k = *consts;
  cudaStream_t s = (cudaStream_t)stream;
  (pasta_form(k) ? launch<true> : launch<false>)(mode, (unsigned)blocks, g, k, s);
  return (int)cudaGetLastError();
}
