// Single-pass scans with a decoupled look-back, shared by kernel C
// (csrc/scan.cu), kernel E (csrc/polyeval.cu) and kernel G
// (csrc/grand_product.cu), and the row loads,
// stores, warp sums and last-block completion of kernels D and F.
//
// A scan is one launch over tiles of kTileRows rows (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA
// 2016). Each block draws a ticket from a counter in device memory, so a
// block only ever waits for blocks that drew before it and are already
// running. Ticket 0 writes descriptor 0, the scan's initial value (the
// identity, an init row, or the inverse of a total); ticket d > 0 scans
// row tile d - 1:
// - each thread loads its run of kScanRows rows once and keeps the run's
//   prefixes in registers;
// - the block scans the runs' totals (warp shuffles, then the warp
//   aggregates in warp 0) and publishes the tile's aggregate (flag
//   kAggregate);
// - each thread combines its exclusive prefix into its rows' prefixes;
// - the block looks back over the descriptors before it, each warp over 32
//   of them, each lane waiting for one flag, and combines them up to the
//   nearest inclusive prefix (flag kPrefix) by trees of shuffles; it
//   publishes the tile's inclusive prefix;
// - last, every row's prefix takes the tile's carry by one combine, each
//   independent of the others: no second chain and no second read of the
//   rows.
// The scan runs in scan order: forward (row order) or, with kRev, from the
// last row to the first; rows past n are the identity.
//
// Replays of one CUDA graph must each start from zeroed flags and a zero
// counter: the call zeroes them (cudaMemsetAsync, a memset node in a
// graph, not a kernel) before the launch.
#pragma once
#include "field.cuh"

// A scan's tile geometry; a build with -DSCAN_ROWS / -DSCAN_THREADS is a
// variant of its own (halo2_tpu_torch/tools/msm_ab.py --jit M --sweep).
#ifndef SCAN_ROWS
#define SCAN_ROWS 2
#endif
#ifndef SCAN_THREADS
#define SCAN_THREADS 128
#endif
constexpr int kScanRows = SCAN_ROWS;                 // rows a thread of a scan
constexpr int kScanThreads = SCAN_THREADS;           // threads a tile, a multiple of 64
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kTileRows = kScanRows * kScanThreads;  // 256 rows a tile by default
static_assert(kScanWarps >= 2 && kScanWarps <= 32 && (kScanWarps & (kScanWarps - 1)) == 0,
              "a tile is 2-32 warps, a power of two");

// a descriptor's flag
constexpr uint32_t kEmpty = 0, kAggregate = 1, kPrefix = 2;
// reads of an empty flag before a lane gives up (__trap): a predecessor
// sets its flag within microseconds (the inverse within tens), these
// reads take seconds
constexpr uint32_t kMaxSpins = 1u << 24;

// The scratch of one scan over T row tiles. `words`: T + 2 words that the
// call zeroes before the launch, [0] the ticket counter and [1 + d]
// descriptor d's flag; `values`: (T + 1) x 2 states, descriptor d's
// aggregate and its inclusive prefix (two slots, so that a reader that saw
// one flag never reads the other's value half written).
struct Lookback {
  uint32_t* words;
  uint32_t* values;
};

// the 32-bit words of a state: kernels C and E scan 8-word states (the
// scratch below); kernel G's forward scan 16-word pairs (its own scratch)
constexpr int kStateWords = 8;

// Host side: the row tiles of n rows; the 32-bit words of one scan's
// scratch (its flags, rounded up to 16 bytes, then its states); the
// Lookback of a scratch that starts at `scratch`.
inline long long scan_tiles(long long n) { return (n + kTileRows - 1) / kTileRows; }
inline long long lookback_flag_words(long long tiles) { return (tiles + 2 + 3) / 4 * 4; }
inline long long lookback_words(long long tiles) { return lookback_flag_words(tiles) + (tiles + 1) * 2 * kStateWords; }
inline Lookback lookback_at(int32_t* scratch, long long tiles) {
  uint32_t* w = reinterpret_cast<uint32_t*>(scratch);
  return Lookback{w, w + lookback_flag_words(tiles)};
}

// An operator `Op` of a scan defines a state `S` (a struct of kWords
// 32-bit words), its identity, and combine(earlier, later, pw), which is
// associative; `pw` is what the operator needs to know of the later part,
// a power b^L of its L rows for Kate division's maps (kernel E), nothing
// (NoPow) for products (kernel C). The operator gives those: pow2(e) =
// b^(2^e), lane_pow(l) = b^(kScanRows l), warp_pow(w) = b^(32 kScanRows w),
// row_pow(j) = b^j, and pw_mul, their product.
struct NoPow {};

constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }
constexpr int kLogScanRows = ilog2(kScanRows);
constexpr int kLogScanWarps = ilog2(kScanWarps);
constexpr int kLogTileRows = ilog2(kTileRows);
// the powers b^(2^e) a scan reads: up to a round of the look-back, kScanWarps
// windows of 32 tiles
constexpr int kPow2 = kLogTileRows + 5 + kLogScanWarps + 1;
static_assert((1 << kLogScanRows) == kScanRows, "rows a thread is a power of two");

template <class S>
__device__ __forceinline__ S shfl_s(const S& a, int d, bool up) {
  S r;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&a);
  uint32_t* o = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < S::kWords; ++i)
    o[i] = up ? __shfl_up_sync(0xffffffffu, w[i], d) : __shfl_down_sync(0xffffffffu, w[i], d);
  return r;
}

// A state to and from device memory, 16 bytes a store; loads bypass L1
// (ld.global.cg), so that a value another block released is read from L2.
template <class S>
__device__ __forceinline__ void state_store(uint32_t* dst, const S& s) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&s);
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < S::kWords / 4; ++i) d[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
}

template <class S>
__device__ __forceinline__ S state_load(const uint32_t* src) {
  S s;
  uint32_t* w = reinterpret_cast<uint32_t*>(&s);
  const uint4* p = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < S::kWords / 4; ++i) {
    const uint4 v = __ldcg(p + i);
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
  return s;
}

__device__ __forceinline__ uint32_t flag_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void flag_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Descriptor d's state under `flag`, then the flag (release: the state's
// stores are visible to a thread that acquires the flag). One thread.
template <class S>
__device__ __forceinline__ void publish(const Lookback& lb, long long d, uint32_t flag, const S& s) {
  state_store(lb.values + (2 * d + (flag == kPrefix ? 1 : 0)) * S::kWords, s);
  flag_release(lb.words + 1 + d, flag);
}

// The block's ticket; every thread of the block must call it once.
__device__ __forceinline__ long long draw_ticket(const Lookback& lb) {
  __shared__ uint32_t ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(lb.words, 1u);
  __syncthreads();
  return ticket;
}

// The exclusive scan of x (a run of kScanRows rows) over the block's
// kScanThreads threads in thread order, and in `total` the combination of
// every thread's x. `sh` holds kScanWarps states in shared memory. Every
// thread must call it.
template <class Op>
__device__ __forceinline__ typename Op::S block_scan(const typename Op::S& x, const Op& op,
                                                     typename Op::S* sh, typename Op::S& total) {
  using S = typename Op::S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  S inc = x;  // inclusive within the warp
#pragma unroll
  for (int e = 0; e < 5; ++e) {
    const S y = shfl_s(inc, 1 << e, true);
    if (lane >= (1 << e)) inc = op.combine(y, inc, op.pow2(kLogScanRows + e));
  }
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {  // the warp aggregates, inclusive, in log2(kScanWarps) levels
    S a = sh[lane < kScanWarps ? lane : 0];
#pragma unroll
    for (int e = 0; e < kLogScanWarps; ++e) {
      const S y = shfl_s(a, 1 << e, true);
      if (lane >= (1 << e)) a = op.combine(y, a, op.pow2(kLogScanRows + 5 + e));
    }
    if (lane < kScanWarps) sh[lane] = a;
  }
  __syncthreads();
  const S ex = shfl_s(inc, 1, true);
  S out;
  if (lane > 0)
    out = warp == 0 ? ex : op.combine(sh[warp - 1], ex, op.lane_pow(lane));
  else
    out = warp == 0 ? op.identity() : sh[warp - 1];
  total = sh[kScanWarps - 1];
  return out;
}

// The combination of descriptors 0 .. d - 1, everything before row tile
// d - 1, in thread 0; every thread of the block must call it. It reads
// rounds of kScanWarps windows of 32 descriptors, the latest first: lane i
// of warp w reads descriptor base - 32 w - i once its flag is set, and the
// warp combines its window from its earliest inclusive prefix on (or whole)
// by a tree of shuffles; then warp 0 combines the windows, from the latest
// one that holds an inclusive prefix on (or all of them, and the next round
// follows). Descriptor 0 only ever holds an inclusive prefix, so the walk
// ends there at the latest. A flag still empty after kMaxSpins reads traps:
// the launch fails instead of hanging the card.
template <class Op>
__device__ __forceinline__ typename Op::S look_back(const Op& op, const Lookback& lb, long long d) {
  using S = typename Op::S;
  using Pw = typename Op::Pw;
  __shared__ S win[kScanWarps];
  __shared__ uint32_t win_prefix[kScanWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  S run;      // warp 0: the rounds read so far
  Pw run_pw;  // warp 0: b^(their rows)
  for (long long base = d - 1, round = 0;; base -= 32 * kScanWarps, ++round) {
    const long long top = base - 32LL * warp;
    uint32_t pre = 0;
    if (top >= 0) {  // the same for the whole warp
      const long long idx = top - lane;
      uint32_t f = kEmpty;
      if (idx >= 0) {
        for (uint32_t spins = 0; (f = flag_acquire(lb.words + 1 + idx)) == kEmpty; ++spins)
          if (spins == kMaxSpins) __trap();  // a fault, not a hang
      }
      pre = __ballot_sync(0xffffffffu, f == kPrefix);
      const int last = pre ? __ffs(pre) - 1 : 31;  // the window's earliest lane that counts
      S v = op.identity();
      if (lane <= last) v = state_load<S>(lb.values + (2 * idx + (f == kPrefix ? 1 : 0)) * S::kWords);
#pragma unroll
      for (int e = 0; e < 5; ++e) {  // lane i combines lanes i .. i + 2^(e+1) - 1
        if ((1 << e) <= last) {
          const S y = shfl_s(v, 1 << e, false);
          if ((lane & ((2 << e) - 1)) == 0 && lane + (1 << e) <= last)
            v = op.combine(y, v, op.pow2(kLogTileRows + e));
        }
      }
      if (lane == 0) win[warp] = v;
    }
    if (lane == 0) win_prefix[warp] = pre != 0;
    __syncthreads();
    uint32_t wins = 0;
#pragma unroll
    for (int w = 0; w < kScanWarps; ++w) wins |= win_prefix[w] << w;
    if (warp == 0) {
      const int last = wins ? __ffs(wins) - 1 : kScanWarps - 1;  // the earliest window that counts
      S v = lane <= last ? win[lane] : op.identity();
#pragma unroll
      for (int e = 0; e < kLogScanWarps; ++e) {
        if ((1 << e) <= last) {
          const S y = shfl_s(v, 1 << e, false);
          if ((lane & ((2 << e) - 1)) == 0 && lane + (1 << e) <= last)
            v = op.combine(y, v, op.pow2(kLogTileRows + 5 + e));
        }
      }
      const Pw round_pw = op.pow2(kLogTileRows + 5 + kLogScanWarps);  // a whole round's rows
      if (round == 0) {
        run = v;
        run_pw = round_pw;
      } else {
        run = op.combine(v, run, run_pw);
        run_pw = op.pw_mul(run_pw, round_pw);
      }
    }
    if (wins) return run;
    __syncthreads();  // win[] is written again
  }
}

// One row tile of a scan, ticket d > 0: the rows of tile d - 1 in scan
// order, position pos -> row kRev ? tiles * kTileRows - 1 - pos : pos.
// `rows` gives each of a thread's rows its element (`element(j, row)`, for
// rows below n; the identity stands for the others), turns the row's prefix
// within the tile into what waits for the carry (`prepare(j, x)`) and
// writes the row from the carry's combination with that (`emit(j, row,
// s)`). kExclusive: a row's prefix leaves the row out.
template <bool kRev, bool kExclusive, class Op, class Rows>
__device__ __forceinline__ void scan_tile(const Op& op, Rows& rows, const Lookback& lb, long long d,
                                          long long n, long long tiles) {
  using S = typename Op::S;
  using Pw = typename Op::Pw;
  static_assert(S::kWords % 4 == 0, "a state is stored 16 bytes at a time");
  __shared__ S sh[kScanWarps];
  __shared__ S carry_sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long pos0 = (d - 1) * kTileRows + (long long)threadIdx.x * kScanRows;
  long long row[kScanRows];
  S x[kScanRows];  // x[j]: the run's rows up to j (kExclusive: before j; x[0] unused)
  S acc;
#pragma unroll
  for (int j = 0; j < kScanRows; ++j) {
    row[j] = kRev ? tiles * kTileRows - 1 - (pos0 + j) : pos0 + j;
    const S e = row[j] < n ? rows.element(j, row[j]) : op.identity();
    if (kExclusive && j > 0) x[j] = acc;
    acc = j == 0 ? e : op.combine(acc, e, op.pow2(0));
    if (!kExclusive) x[j] = acc;
  }
  S total;
  const S ex = block_scan(acc, op, sh, total);
  if (threadIdx.x == 0) publish(lb, d, kAggregate, total);
  // each row's prefix within the tile, and b^(its rows) for the carry
  const Pw tid_pw = op.pw_mul(op.lane_pow(lane), op.warp_pow(warp));
  Pw x_pw[kScanRows];
#pragma unroll
  for (int j = 0; j < kScanRows; ++j) {
    const int run_rows = kExclusive ? j : j + 1;
    x[j] = rows.prepare(j, run_rows == 0 ? ex : op.combine(ex, x[j], op.row_pow(run_rows)));
    x_pw[j] = run_rows == 0 ? tid_pw : op.pw_mul(tid_pw, op.row_pow(run_rows));
  }
  const S before = look_back(op, lb, d);
  if (threadIdx.x == 0) {
    publish(lb, d, kPrefix, op.combine(before, total, op.pow2(kLogTileRows)));
    carry_sh = before;
  }
  __syncthreads();
  const S carry = carry_sh;
#pragma unroll
  for (int j = 0; j < kScanRows; ++j)
    if (row[j] < n) rows.emit(j, row[j], op.combine(carry, x[j], x_pw[j]));
}

// The sum of the warp's 32 v (fe_add_cc) in lane 0; every lane of the
// warp must call it.
__device__ __forceinline__ Fe warp_sum(Fe v, const FieldConsts& k) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    Fe o;
#pragma unroll
    for (int i = 0; i < 8; ++i) o.v[i] = __shfl_down_sync(0xffffffffu, v.v[i], d);
    v = fe_add_cc(v, o, k);  // lanes >= 32 - d add what no one reads
  }
  return v;
}

// A value as 8 words at dst (two 16-byte stores), and back with loads that
// bypass L1 (ld.global.cg), so that a value another block wrote in this
// launch is read from L2: the partial sums that the last block adds up.
__device__ __forceinline__ void fe_store_words(uint32_t* dst, const Fe& a) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  d[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

__device__ __forceinline__ Fe fe_load_words_cg(const uint32_t* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  const uint4 a = __ldcg(s), b = __ldcg(s + 1);
  Fe r;
  r.v[0] = a.x, r.v[1] = a.y, r.v[2] = a.z, r.v[3] = a.w;
  r.v[4] = b.x, r.v[5] = b.y, r.v[6] = b.z, r.v[7] = b.w;
  return r;
}

// The sum of `count` values stored as 8 words each from src on, over the
// lanes of one warp (`lane` of `lanes`, lanes a multiple of 32 that start
// on a warp), in each of those warps' lane 0: each lane adds up a strided
// share with four loads in flight, then the warp's shuffles. The last
// block's sums of the other blocks' partials.
__device__ __forceinline__ Fe sum_words(const uint32_t* src, long long count, int lane, int lanes,
                                        const FieldConsts& k) {
  Fe v = fe_zero();
  long long i = lane;
  for (; i + 3LL * lanes < count; i += 4LL * lanes) {
    const Fe a = fe_load_words_cg(src + i * 8), b = fe_load_words_cg(src + (i + lanes) * 8);
    const Fe c = fe_load_words_cg(src + (i + 2LL * lanes) * 8), d = fe_load_words_cg(src + (i + 3LL * lanes) * 8);
    v = fe_add_cc(v, fe_add_cc(fe_add_cc(a, b, k), fe_add_cc(c, d, k), k), k);
  }
  for (; i < count; i += lanes) v = fe_add_cc(v, fe_load_words_cg(src + i * 8), k);
  return warp_sum(v, k);
}

// sum_words over every thread of the block, the sum in every thread; `sh`
// holds 32 values in shared memory. Every thread of the block must call it.
__device__ __forceinline__ Fe block_sum_words(const uint32_t* src, long long count, Fe* sh, const FieldConsts& k) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  Fe v = sum_words(src, count, threadIdx.x, blockDim.x, k);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < warps; ++w) v = fe_add_cc(v, sh[w], k);
    sh[0] = v;
  }
  __syncthreads();
  v = sh[0];
  __syncthreads();  // sh may be used again
  return v;
}

// Whether this block is the launch's last to finish; every thread of the
// block must call it, `stored` true in the threads that stored what the
// last block reads (they fence their stores; the other stores need not be
// visible to it). Then thread 0 draws a ticket from `counter` (a word in
// device memory that is 0 when the launch starts); the block that draws the
// grid's last ticket sees every other block's fenced stores and sets the
// counter back to 0 for the next launch, so that a call needs no memset
// and every replay of a CUDA graph starts from 0.
__device__ __forceinline__ bool last_block(uint32_t* counter, bool stored) {
  __shared__ bool last;
  if (stored) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t blocks = gridDim.x * gridDim.y * gridDim.z;
    last = atomicAdd(counter, 1u) == blocks - 1;
    if (last) *counter = 0;  // every block has drawn its ticket
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// 16 int32 limbs of row r of an (n, 16) tensor, and back.
__device__ __forceinline__ Fe row_load(const int32_t* base, long long r) {
  return fe_load16_v(reinterpret_cast<const int4*>(base + 16 * r));
}

__device__ __forceinline__ void row_store(int32_t* base, long long r, const Fe& a) {
  fe_store16_v(reinterpret_cast<int4*>(base + 16 * r), a);
}
