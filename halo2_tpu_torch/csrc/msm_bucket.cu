// Kernels 2-4: the bucket (Pippenger) MSM over shared affine bases.
//
// Replace halo2_tpu/ops/msm_pallas.py _accum_fn (pallas_call at :232),
// _fold_fn (:302) and _lane_reduce_fn (:357). Layouts (int32, 16-bit limbs):
//   scal    (M, 16, n_pad)        canonical scalars, limb-major
//   px, py  (16, n_pad)           affine Montgomery bases
//   buckets (rows, T, B, 3, 16)   rows = M * nwin, B = 2^c: a bucket's 48
//                                 limbs together (192 B, 16 B aligned)
//   parts   (rows, 3, 16, T)
//   out     (rows, 3, 16)
// Lane t of a row owns the points t, t + T, ... (P = n_pad / T of them) and
// the B buckets S_b of its column; bucket 0 (digit 0) stays the identity.
//
// msm_accum: a block per (row, G lanes), a thread per run of whole buckets.
// The block first sorts its G * P window digits by (lane, bucket) in shared
// memory: a count per key, an exclusive scan, then a stable placement by
// warp-wide __match_any_sync, so that each bucket's list keeps ascending
// point index. The sorted list is cut into NT nearly equal runs snapped to
// bucket boundaries; a thread walks its run with the bucket in registers
// (24 words), adding each base with the complete mixed addition from the
// identity, and writes each bucket once. Empty buckets and bucket 0 are
// written as the identity, so the tensor is written once and needs no
// initialisation. The additions and their order per bucket are those of the
// TPU kernel (and of msm_accum_plain), so the buckets are bit for bit the same.
// msm_fold: a thread per (row, lane, segment j) of L = 2^l buckets, S = B / L
// segments per lane in S neighbouring lanes of a warp. Each thread takes the
// running and total sums over its segment's buckets r = L-1 .. 1 (W_j =
// sum_r r * S_{jL+r}) and adds bucket jL to the running sum (Sum_j); a
// Hillis-Steele suffix scan by shuffles gives U_j = sum_{i >= j} Sum_i, U_0 is
// dropped, each U_j is doubled l times and added to W_j, and a shuffle tree
// sums the S results: sum_b b * S_b = sum_j W_j + L * sum_{j >= 1} U_j.
// Every addition follows the skip rule of field.cuh, as msm_fold_plain does.
// msm_lane_reduce: a block per row sums the T lane partials by the plain
// version's tree: at level s = T/2, ..., 1, lane i < s takes pt_add(lane i,
// lane i + s). Each addition of the first level runs on a group of 4 lanes
// (quad_add of field.cuh), each later one on a group of 8 (warp_add: its
// products in three rounds on lanes 0-5).
//
// What bounds them on an H100, and what the design does about it. The first
// port ran one thread per (row, lane) with its buckets in device memory: 1 to
// 8 warps per SM, each addition waiting on the load and store of its bucket,
// and a fold of 2(2^c - 1) dependent additions per thread. Field arithmetic
// was not the limit (kernel 9 runs the same products several times faster).
// - accum_kernel (replaces msm_pallas.py:232 _accum_fn): bound by the integer
//   multiplies of its mixed additions (11 general Montgomery products each),
//   after three costs the design keeps small: the 32 scattered 4-byte loads
//   of a base from the (16, n_pad) tables, the spread of run lengths inside a
//   warp (runs of about 60 points, cut only at bucket ends), and the
//   block's sort (two passes over its digits in shared memory). A bucket is
//   written once as 192 contiguous bytes: written lane-innermost, 4 bytes at a
//   time by threads that own different buckets, the 201 MB per MSM at c = 8
//   left the L2 in partial sectors and the stores, not the arithmetic, set the
//   kernel's time. ptxas (-Xptxas -v, sm_90a): 162 registers, 0 bytes of
//   spills, at __launch_bounds__(128, 3); with at most 75 KB of shared memory
//   a block, three blocks (12 warps) fit an SM.
// - fold_kernel (replaces msm_pallas.py:302 _fold_fn): bound by the integer
//   multiplies of its full additions (12 general products) and the latency of
//   each thread's chain of 2L dependent additions; the segments cut the chain
//   (510 additions a lane at c = 8 to about 70 and 5 doublings with L = 32)
//   and multiply the threads. ptxas: 240 registers, 0 bytes of spills, an
//   808-byte stack frame for the calls to fold_add / fold_dbl (inlined, the
//   kernel took 255 registers and spilled 320 bytes).
// - lane_reduce_kernel (replaces msm_pallas.py:357 _lane_reduce_fn): bound
//   by the latency of the tree's log2(T) = 7 dependent full additions, each
//   12 general products (the 3.08 us multiply bound of 192 rows x 127
//   additions at the k = 14 commit shape is far below it). The first port ran
//   one thread an addition, its 14 fe_mul one after another, about 16 threads
//   of a block busy from the third level on, and took 0.124 ms. Here an
//   addition is three rounds of products on 8 lanes (warp_add), each round
//   one fe_mul_cc (about 911 cycles in the Pasta form), with ten
//   carry-chain additions (96 cycles each) and the shuffles between them:
//   about 4 000 cycles, 2 us. The row's points are read once, coalesced,
//   into shared memory as 24 words each (12 KB at T = 128), and every level
//   runs there, one barrier a level, the last three on warp 0 with
//   __syncwarp, all of them through one loop: a second inlined copy of the
//   addition (a shuffle tail) made the kernel slower. At 256 threads a block
//   the first level's 64 additions get a group each only on groups of 4
//   lanes (quad_add: rounds 1 and 3 in two halves, five product latencies):
//   one such addition instead of two of three latencies one after the
//   other, and a sixth fewer lane-products where the level is busiest. At
//   192 rows, more than one an SM, the first two levels are bound by the
//   multiply issue of the SMs that hold two rows. ptxas: 128 registers
//   (__launch_bounds__(256)), no spills.
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int ACCUM_THREADS = 128;
constexpr int FOLD_THREADS = 128;
constexpr int S_BITS = 17;  // point index within a lane, in a sorted item

__device__ __forceinline__ void pt_store(int32_t* base, long long stride_coord,
                                         long long stride_limb, const Pt& p) {
  fe_store16(base, stride_limb, p.x);
  fe_store16(base + stride_coord, stride_limb, p.y);
  fe_store16(base + 2 * stride_coord, stride_limb, p.z);
}

// In-place exclusive scan of a[0 .. n) by the whole block; returns the total.
__device__ uint32_t block_exclusive_scan(uint32_t* a, int n, uint32_t* warp_sums) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int chunk = (n + nt - 1) / nt;
  const int beg = min(n, tid * chunk), end = min(n, beg + chunk);
  uint32_t mine = 0;
  for (int i = beg; i < end; ++i) mine += a[i];
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  uint32_t incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    uint32_t o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < nw ? warp_sums[lane] : 0;
    uint32_t wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      uint32_t o = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += o;
    }
    if (lane < nw) warp_sums[lane] = wi - w;  // exclusive over warps
    if (lane == 31) warp_sums[32] = wi;       // block total
  }
  __syncthreads();
  uint32_t run = warp_sums[warp] + incl - mine;
  for (int i = beg; i < end; ++i) {
    const uint32_t v = a[i];
    a[i] = run;
    run += v;
  }
  const uint32_t total = warp_sums[32];
  __syncthreads();
  return total;
}

// Shared memory of one accum block: G * B + 1 counters, the sorted list of
// at most G * P items and the G * P digits.
__host__ __device__ __forceinline__ size_t accum_smem(int G, int B, int P) {
  return 4 * ((size_t)G * B + 1) + 4 * (size_t)G * P + (size_t)G * P;
}

__global__ void __launch_bounds__(ACCUM_THREADS, 3)
accum_kernel(const int32_t* __restrict__ scal, const int32_t* __restrict__ px,
             const int32_t* __restrict__ py, int32_t* __restrict__ buckets, int nwin,
             long long n_pad, int T, int c, int G, FieldConsts k) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t warp_sums[33];
  const int groups = T / G;
  const int row = blockIdx.x / groups;
  const int lane0 = (blockIdx.x % groups) * G;
  const int m = row / nwin, w = row % nwin;
  const int B = 1 << c;
  const int K = G * B;  // keys g * B + d
  const int P = (int)(n_pad / T);
  const int tid = threadIdx.x, nt = blockDim.x;
  uint32_t* cnt = smem;             // K + 1
  uint32_t* list = smem + K + 1;    // G * P
  uint8_t* dig = (uint8_t*)(list + (size_t)G * P);

  // 1. digits (coalesced over the block's lanes) and counts per key
  for (int i = tid; i <= K; i += nt) cnt[i] = 0;
  __syncthreads();
  const int bit = w * c;
  const int32_t* limb = scal + ((long long)m * 16 + (bit >> 4)) * n_pad + lane0;
  const int shift = bit & 15;
  for (int i = tid; i < G * P; i += nt) {
    const int s = i / G, g = i % G;
    const int d = (limb[(long long)s * T + g] >> shift) & (B - 1);
    dig[i] = (uint8_t)d;
    if (d) atomicAdd(&cnt[g * B + d], 1u);
  }
  __syncthreads();
  // 2. exclusive scan: cnt[key] = first place of the key in the list
  const uint32_t N = block_exclusive_scan(cnt, K, warp_sums);
  // 3. stable placement, a warp per lane, 32 points at a time; afterwards
  //    cnt[key] is the end of the key's run
  const int wl = tid & 31;
  for (int g = tid >> 5; g < G; g += nt >> 5) {
    for (int s0 = 0; s0 < P; s0 += 32) {
      const int s = s0 + wl;
      const int d = s < P ? dig[s * G + g] : 0;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      const int rank = __popc(peers & ((1u << wl) - 1));
      uint32_t at = 0;
      if (d) {
        at = cnt[g * B + d];
        list[at + rank] = ((uint32_t)(g * B + d) << S_BITS) | (uint32_t)s;
      }
      __syncwarp();
      if (d && rank == 0) cnt[g * B + d] = at + __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  // bucket (g, d) of the block at out + (g * B + d) * 48
  int32_t* out = buckets + ((long long)row * T + lane0) * B * 48;
  // 4. the identity into every empty bucket (bucket 0 included)
  const Pt id = pt_identity(k);
  for (int key = tid; key < K; key += nt) {
    const uint32_t beg = key ? cnt[key - 1] : 0;
    if (cnt[key] == beg) bucket_store(out + (long long)key * 48, id);
  }
  // 5. a run of whole buckets per thread, each bucket summed in registers
  uint32_t lo = (uint32_t)(((unsigned long long)tid * N) / nt);
  uint32_t hi = (uint32_t)(((unsigned long long)(tid + 1) * N) / nt);
  while (lo > 0 && lo < N && (list[lo] >> S_BITS) == (list[lo - 1] >> S_BITS)) ++lo;
  while (hi > 0 && hi < N && (list[hi] >> S_BITS) == (list[hi - 1] >> S_BITS)) ++hi;
  Pt acc = id;
  uint32_t item = lo < hi ? list[lo] : 0;
#pragma unroll 1
  for (uint32_t i = lo; i < hi; ++i) {
    const uint32_t key = item >> S_BITS;
    const long long pt = (long long)(item & ((1u << S_BITS) - 1)) * T + lane0 + key / B;
    const Fe X2 = fe_load16(px + pt, n_pad);
    const Fe Y2 = fe_load16(py + pt, n_pad);
    acc = pt_add_mixed(acc, X2, Y2, k);
    item = i + 1 < hi ? list[i + 1] : 0;
    if (i + 1 == hi || (item >> S_BITS) != key) {
      bucket_store(out + (long long)key * 48, acc);
      acc = id;
    }
  }
}

__global__ void __launch_bounds__(FOLD_THREADS)
fold_kernel(const int32_t* __restrict__ buckets, int32_t* __restrict__ parts, int rows, int B,
            int T, int l, FieldConsts k) {
  const int L = 1 << l, S = B >> l;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = gid < (long long)rows * T * S;  // dead threads only shuffle
  const int j = (int)(gid % S);
  const int lane = (int)((gid / S) % T);
  const long long row = live ? gid / ((long long)S * T) : 0;
  const long long sc = 16LL * T;
  const int32_t* seg = buckets + ((row * T + lane) * B + j * L) * 48;
  const Pt id = pt_identity(k);
  Pt run = id, tot = id;
  if (live) {
#pragma unroll 1
    for (int r = L - 1; r >= 1; --r) {
      run = fold_add(run, bucket_load(seg + r * 48), k);
      tot = fold_add(tot, run, k);
    }
    run = fold_add(run, bucket_load(seg), k);
  }
#pragma unroll 1
  for (int d = 1; d < S; d <<= 1) {  // suffix scan: run_j = U_j
    const Pt o = shfl_down_pt(run, d, S);
    if (j + d < S) run = fold_add(run, o, k);
  }
  if (j == 0) run = id;
#pragma unroll 1
  for (int i = 0; i < l; ++i) run = fold_dbl(run, k);
  Pt x = fold_add(tot, run, k);
#pragma unroll 1
  for (int d = S >> 1; d >= 1; d >>= 1) {
    const Pt o = shfl_down_pt(x, d, S);
    if (j < d) x = fold_add(x, o, k);
  }
  if (live && j == 0) pt_store(parts + row * 3 * sc + lane, sc, T, x);
}

// ---- kernel 4: the lane tree, an addition on each group of 4 or 8 lanes ----

constexpr int LANE_GROUP = 8;

// word w (x: 0-7, y: 8-15, z: 16-23) of point t at pw[w * T + t]
__device__ __forceinline__ Pt pw_load(const uint32_t* pw, int T, int t) {
  Pt r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.x.v[i] = pw[i * T + t];
    r.y.v[i] = pw[(8 + i) * T + t];
    r.z.v[i] = pw[(16 + i) * T + t];
  }
  return r;
}

__device__ __forceinline__ void pw_store(uint32_t* pw, int T, int t, const Pt& p) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    pw[i * T + t] = p.x.v[i];
    pw[(8 + i) * T + t] = p.y.v[i];
    pw[(16 + i) * T + t] = p.z.v[i];
  }
}

template <bool kPasta>
__global__ void __launch_bounds__(256)
lane_reduce_kernel(const int32_t* __restrict__ parts, int32_t* __restrict__ out, int T,
                   FieldConsts k) {
  extern __shared__ uint32_t pw[];  // the row's T points, 24 words each
  const int nt = blockDim.x;
  const int lane = threadIdx.x & (LANE_GROUP - 1);
  const int g = threadIdx.x / LANE_GROUP;
  // the row's (3, 16, T) limbs, read coalesced: limbs 2w, 2w + 1 make word w
  const int32_t* src = parts + (long long)blockIdx.x * 48 * T;
  for (int i = threadIdx.x; i < 24 * T; i += nt) {
    const int w = i / T, t = i % T;
    const int32_t* q = src + (long long)2 * w * T + t;
    pw[i] = (uint32_t)q[0] | ((uint32_t)q[T] << 16);
  }
  __syncthreads();
  // Every level in place in shared memory: addition i reads points i and
  // i + s and writes point i. A level's additions are dealt to the groups in
  // turn; s and the groups of a block are multiples of the groups of a warp,
  // so a warp's groups have the same number of additions and the warp never
  // diverges, and a warp that has none waits at the barrier.
  int s = T >> 1;
  if (s >= 8) {  // the first level on groups of 4 lanes
    for (int i = threadIdx.x / 4; i < s; i += nt / 4)
      pw_store(pw, T, i, quad_add<kPasta>(pw_load(pw, T, i), pw_load(pw, T, i + s), k,
                                          threadIdx.x & 3));
    __syncthreads();
    s >>= 1;
  }
  // The other levels on groups of 8 lanes, one loop (and one inlined
  // addition) for all of them: the last ones (s <= 4) on the 4 groups of
  // warp 0 alone, whose groups i >= s add points 0 and s, a sum no one
  // stores; __syncwarp keeps their reads of point 0 before group 0's store.
  for (; s >= 1; s >>= 1) {
    if (s <= 4 && threadIdx.x >= 32) return;
    for (int i = g; i < (s < 4 ? 4 : s); i += nt / LANE_GROUP) {
      const int j = i < s ? i : 0;
      const Pt r = warp_add<kPasta, LANE_GROUP>(pw_load(pw, T, j), pw_load(pw, T, j + s), k, lane);
      if (s <= 4) __syncwarp();
      if (i < s) pw_store(pw, T, i, r);
    }
    if (s > 4)
      __syncthreads();
    else
      __syncwarp();
  }
  if (threadIdx.x == 0) pt_store(out + (long long)blockIdx.x * 48, 16, 1, pw_load(pw, T, 0));
}

}  // namespace

// G lanes per block (a power of two dividing T); the wrapper checks that the
// block's shared memory, accum_smem(G, 2^c, n_pad / T), fits.
extern "C" int msm_accum(const int32_t* scal, const int32_t* px, const int32_t* py,
                         int32_t* buckets, int rows, int nwin, long long n_pad, int T, int c,
                         int G, const FieldConsts* consts, void* stream) {
  const size_t smem = accum_smem(G, 1 << c, (int)(n_pad / T));
  cudaError_t err = cudaFuncSetAttribute(accum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  accum_kernel<<<rows * (T / G), ACCUM_THREADS, smem, (cudaStream_t)stream>>>(
      scal, px, py, buckets, nwin, n_pad, T, c, G, *consts);
  return (int)cudaGetLastError();
}

extern "C" int msm_fold(const int32_t* buckets, int32_t* parts, int rows, int B, int T, int l,
                        const FieldConsts* consts, void* stream) {
  const long long threads = (long long)rows * T * (B >> l);
  const int blocks = (int)((threads + FOLD_THREADS - 1) / FOLD_THREADS);
  fold_kernel<<<blocks, FOLD_THREADS, 0, (cudaStream_t)stream>>>(buckets, parts, rows, B, T, l,
                                                                   *consts);
  return (int)cudaGetLastError();
}

// threads: threads a block at most (a multiple of 32, at most 256); a block
// takes max(32, 2 T) of them at most, 4 for each addition of the first level.
extern "C" int msm_lane_reduce(const int32_t* parts, int32_t* out, int rows, int T, int threads,
                               const FieldConsts* consts, void* stream) {
  if (threads > 2 * T) threads = 2 * T;
  if (threads < 32) threads = 32;
  const size_t smem = (size_t)24 * T * sizeof(uint32_t);
  auto kernel = pasta_form(*consts) ? lane_reduce_kernel<true> : lane_reduce_kernel<false>;
  static size_t smem_set[2] = {48 * 1024, 48 * 1024};
  size_t& set = smem_set[pasta_form(*consts)];
  if (smem > set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    set = smem;
  }
  kernel<<<rows, threads, smem, (cudaStream_t)stream>>>(parts, out, T, *consts);
  return (int)cudaGetLastError();
}
