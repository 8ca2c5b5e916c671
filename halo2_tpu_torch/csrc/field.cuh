// Montgomery field and curve helpers shared by the port's CUDA kernels.
//
// Replaces the in-kernel helpers of the TPU build (halo2_tpu/ops/ntt_pallas.py
// _mul_cols/_sweep_ks/_mont_mul/_add_mod/_sub_mod and
// halo2_tpu/ops/msm_pallas.py _mixed_padd/_full_padd). The TPU has no
// 32x32->64 multiply, so it split elements into 16 limbs of 16 bits; Hopper
// multiplies 32-bit words into 64 bits in one instruction pair (mul.lo/mul.hi),
// so inside a kernel an element is 8 words of 32 bits and the product is a
// word-serial CIOS Montgomery reduction with R = 2^256. R is the same as the
// JAX package's, so the Montgomery values are the same numbers; tensors keep
// the (..., 16) int32 layout of 16-bit limbs and are converted on load and
// store.
//
// Values are reduced lazily, with the same bounds as the JAX package's
// arithmetic, and are not always below 2p. For inputs below 2p the CIOS
// product (a*b + m*p)/R, m < R, is below 4p^2/R + p; the Pasta moduli are
// p = 2^254 + d with d < 2^126, so that is 2p + d + 1 < 2p + 2^126 < 2^256. It
// fits the 8 words and needs no final subtraction, but lands in [2p, 2p + d]
// for about 2^-129 of uniform outputs. fe_add subtracts 2p once and fe_sub
// adds 2p once, so an operand in that range still gives a result correct mod
// p, unless it is fe_sub's b and a < b - 2p < 2^126: a further 2^-129. For
// BN254's moduli, its scalar field FrBn (kernels 1 and 8 on the KZG path) and
// its base field FqBn (kernels 2-7 on G1), p < 2^254, so 4p^2/R + p < 2p: the
// product stays below 2p and that range never occurs.
#pragma once
#include <cstdint>

struct Fe {
  uint32_t v[8];
};

// Per-modulus constants, passed to every kernel by value.
struct FieldConsts {
  uint32_t p[8];
  uint32_t twop[8];
  uint32_t one[8];  // R mod p (Montgomery one)
  uint32_t b3[8];   // 3 * b in Montgomery form (curve kernels only)
  uint32_t n0;      // -p^-1 mod 2^32
};

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = 0;
  return r;
}

__device__ __forceinline__ Fe fe_from(const uint32_t* w) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = w[i];
  return r;
}

// 16 int32 limbs at src[l * stride] -> 8 words.
__device__ __forceinline__ Fe fe_load16(const int32_t* src, long long stride) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t lo = (uint32_t)src[(2 * i) * stride];
    uint32_t hi = (uint32_t)src[(2 * i + 1) * stride];
    r.v[i] = lo | (hi << 16);
  }
  return r;
}

__device__ __forceinline__ void fe_store16(int32_t* dst, long long stride, const Fe& a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    dst[(2 * i) * stride] = (int32_t)(a.v[i] & 0xFFFFu);
    dst[(2 * i + 1) * stride] = (int32_t)(a.v[i] >> 16);
  }
}

// CIOS Montgomery product a*b/R mod p, inputs in [0, 2p).
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b, const FieldConsts& k) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)a.v[j] * b.v[i] + t[j] + carry;
      t[j] = (uint32_t)s;
      carry = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + carry;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * k.n0;
    s = (uint64_t)m * k.p[0] + t[0];
    carry = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)m * k.p[j] + t[j] + carry;
      t[j - 1] = (uint32_t)s;
      carry = s >> 32;
    }
    s = (uint64_t)t[8] + carry;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  return fe_from(t);
}

// The moduli of the Pasta curves: p = 1 + d' 2^32 + 2^254 with d' < 2^94
// (words 4-6 zero, word 7 = 2^30) and so n0 = -1/p mod 2^32 = 2^32 - 1.
inline bool pasta_form(const FieldConsts& k) {
  return k.p[0] == 1 && k.p[4] == 0 && k.p[5] == 0 && k.p[6] == 0 && k.p[7] == 0x40000000u &&
         k.n0 == 0xFFFFFFFFu;
}

// The same CIOS product with PTX carry chains: each row's word products
// a_j b_i by mul.wide.u32, their low and high words added into t by two add
// chains (add.cc / addc), against fe_mul's 64-bit adds, which emulate each
// carry with a compare or a second add. The carry flag is one, so the chain
// is the latency: kPasta (p of pasta_form, checked by the caller) adds m p
// as m + 2^32 m d' + 2^254 m, with m d' formed by six products off the
// chain. `profile_kernels oplat` gives a product's cycles on one thread
// beside fe_mul's (PERF.md has them). Rows of mad.lo.cc / madc.hi.cc
// chains give the same integers, but ptxas splits every madc into a
// multiply and an IADD3.X anyway, and a mul.wide costs about what a mad.lo
// and a mad.hi cost together (`profile_kernels oplat`, mul_peak), so the
// wide rows leave fewer instructions on the multiply pipe, which bounds the
// throughput kernels 9 and 10.
// It returns the integer fe_mul returns, (a*b + M*p) / 2^256 with
// M = -a*b/p mod 2^256 and no final subtraction: for inputs below 2p + 2^126
// every partial sum of a row stays below 2^288 (9 words) and every row's
// result below 2^256 (see the note at the head of this file), so no carry
// leaves the 9 words. Kernels 1, 4, 7, 8, 9 and 10 use it; kernels 2, 3, 5
// and 6 keep fe_mul.
template <bool kPasta>
__device__ __forceinline__ Fe fe_mul_cc(const Fe& a, const Fe& b, const FieldConsts& k) {
  uint32_t t[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t bi = b.v[i];
    // t += a * b_i: the low halves into words 0-7 (the carry into word 8),
    // then the high halves into words 1-8
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint64_t w = (uint64_t)a.v[j] * bi;
      lo[j] = (uint32_t)w;
      hi[j] = (uint32_t)(w >> 32);
    }
    asm volatile("add.cc.u32 %0, %0, %1;" : "+r"(t[0]) : "r"(lo[0]));
#pragma unroll
    for (int j = 1; j < 8; ++j) asm volatile("addc.cc.u32 %0, %0, %1;" : "+r"(t[j]) : "r"(lo[j]));
    asm volatile("addc.u32 %0, %0, 0;" : "+r"(t[8]));
    asm volatile("add.cc.u32 %0, %0, %1;" : "+r"(t[1]) : "r"(hi[0]));
#pragma unroll
    for (int j = 1; j < 7; ++j)
      asm volatile("addc.cc.u32 %0, %0, %1;" : "+r"(t[j + 1]) : "r"(hi[j]));
    asm volatile("addc.u32 %0, %0, %1;" : "+r"(t[8]) : "r"(hi[7]));
    // t += m * p with m = t_0 * n0, which clears word 0
    if (kPasta) {
      const uint32_t m = 0u - t[0];
      // q = m (d1 + d2 2^32 + d3 2^64) < 2^126 in words q1-q4
      const uint32_t q1 = m * k.p[1];
      uint32_t q2 = __umulhi(m, k.p[1]), q3 = __umulhi(m, k.p[2]), q4 = __umulhi(m, k.p[3]);
      asm volatile("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(q2) : "r"(m), "r"(k.p[2]));
      asm volatile("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(q3) : "r"(m), "r"(k.p[3]));
      asm volatile("addc.u32 %0, %0, 0;" : "+r"(q4));
      asm volatile("add.cc.u32 %0, %0, %1;" : "+r"(t[0]) : "r"(m));
      asm volatile("addc.cc.u32 %0, %0, %1;" : "+r"(t[1]) : "r"(q1));
      asm volatile("addc.cc.u32 %0, %0, %1;" : "+r"(t[2]) : "r"(q2));
      asm volatile("addc.cc.u32 %0, %0, %1;" : "+r"(t[3]) : "r"(q3));
      asm volatile("addc.cc.u32 %0, %0, %1;" : "+r"(t[4]) : "r"(q4));
      asm volatile("addc.cc.u32 %0, %0, 0;" : "+r"(t[5]));
      asm volatile("addc.cc.u32 %0, %0, 0;" : "+r"(t[6]));
      asm volatile("addc.cc.u32 %0, %0, %1;" : "+r"(t[7]) : "r"(m << 30));
      asm volatile("addc.u32 %0, %0, %1;" : "+r"(t[8]) : "r"(m >> 2));
    } else {
      const uint32_t m = t[0] * k.n0;
      asm volatile("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[0]) : "r"(m), "r"(k.p[0]));
#pragma unroll
      for (int j = 1; j < 8; ++j)
        asm volatile("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[j]) : "r"(m), "r"(k.p[j]));
      asm volatile("addc.u32 %0, %0, 0;" : "+r"(t[8]));
      asm volatile("mad.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[1]) : "r"(m), "r"(k.p[0]));
#pragma unroll
      for (int j = 1; j < 7; ++j)
        asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[j + 1]) : "r"(m), "r"(k.p[j]));
      asm volatile("madc.hi.u32 %0, %1, %2, %0;" : "+r"(t[8]) : "r"(m), "r"(k.p[7]));
    }
    // divide by 2^32
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
    t[8] = 0;
  }
  return fe_from(t);
}

// (a + b) reduced below 2p.
__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b, const FieldConsts& k) {
  Fe s, d;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t x = (uint64_t)a.v[i] + b.v[i] + c;
    s.v[i] = (uint32_t)x;
    c = x >> 32;
  }
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t x = (uint64_t)s.v[i] - k.twop[i] - borrow;
    d.v[i] = (uint32_t)x;
    borrow = x >> 63;
  }
  return (c || !borrow) ? d : s;
}

// (a - b) in [0, 2p): a - b, or a - b + 2p when b > a.
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b, const FieldConsts& k) {
  Fe d, e;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t x = (uint64_t)a.v[i] - b.v[i] - borrow;
    d.v[i] = (uint32_t)x;
    borrow = x >> 63;
  }
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t x = (uint64_t)d.v[i] + k.twop[i] + c;
    e.v[i] = (uint32_t)x;
    c = x >> 32;
  }
  return borrow ? e : d;
}

// fe_add and fe_sub with PTX carry chains: the same results in about 96
// cycles on one thread against 160 and 190 (the kernels of fe_mul_cc use
// them).
__device__ __forceinline__ Fe fe_add_cc(const Fe& a, const Fe& b, const FieldConsts& k) {
  Fe s, d;
  uint32_t c;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(s.v[0]) : "r"(a.v[0]), "r"(b.v[0]));
#pragma unroll
  for (int i = 1; i < 8; ++i)
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(s.v[i]) : "r"(a.v[i]), "r"(b.v[i]));
  asm volatile("addc.u32 %0, 0, 0;" : "=r"(c));
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(d.v[0]) : "r"(s.v[0]), "r"(k.twop[0]));
#pragma unroll
  for (int i = 1; i < 8; ++i)
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(d.v[i]) : "r"(s.v[i]), "r"(k.twop[i]));
  asm volatile("subc.u32 %0, %0, 0;" : "+r"(c));  // carry - borrow: all ones iff a + b < 2p
  return c == 0xFFFFFFFFu ? s : d;
}

__device__ __forceinline__ Fe fe_sub_cc(const Fe& a, const Fe& b, const FieldConsts& k) {
  Fe d, r;
  uint32_t m;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(d.v[0]) : "r"(a.v[0]), "r"(b.v[0]));
#pragma unroll
  for (int i = 1; i < 8; ++i)
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(d.v[i]) : "r"(a.v[i]), "r"(b.v[i]));
  asm volatile("subc.u32 %0, 0, 0;" : "=r"(m));  // all ones iff b > a
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r.v[0]) : "r"(d.v[0]), "r"(k.twop[0] & m));
#pragma unroll
  for (int i = 1; i < 7; ++i)
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r.v[i]) : "r"(d.v[i]), "r"(k.twop[i] & m));
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r.v[7]) : "r"(d.v[7]), "r"(k.twop[7] & m));
  return r;
}

struct Pt {
  Fe x, y, z;
};

__device__ __forceinline__ Pt pt_identity(const FieldConsts& k) {
  Pt r;
  r.x = fe_zero();
  r.y = fe_from(k.one);
  r.z = fe_zero();
  return r;
}

// Complete mixed addition, Renes-Costello-Batina 2015 algorithm 8 (a = 0,
// Z2 = 1); the same operation sequence as _mixed_padd in msm_pallas.py.
__device__ __forceinline__ Pt pt_add_mixed(const Pt& a, const Fe& X2, const Fe& Y2,
                                           const FieldConsts& k) {
  Fe b3 = fe_from(k.b3);
  Fe t0 = fe_mul(a.x, X2, k);
  Fe t1 = fe_mul(a.y, Y2, k);
  Fe t3 = fe_add(X2, Y2, k);
  Fe t4 = fe_add(a.x, a.y, k);
  t3 = fe_mul(t3, t4, k);
  t4 = fe_add(t0, t1, k);
  t3 = fe_sub(t3, t4, k);
  t4 = fe_mul(Y2, a.z, k);
  t4 = fe_add(t4, a.y, k);
  Fe Y3 = fe_mul(X2, a.z, k);
  Y3 = fe_add(Y3, a.x, k);
  Fe X3 = fe_add(t0, t0, k);
  t0 = fe_add(X3, t0, k);
  Fe t2 = fe_mul(b3, a.z, k);
  Fe Z3 = fe_add(t1, t2, k);
  t1 = fe_sub(t1, t2, k);
  Y3 = fe_mul(b3, Y3, k);
  X3 = fe_mul(t4, Y3, k);
  t2 = fe_mul(t3, t1, k);
  X3 = fe_sub(t2, X3, k);
  Y3 = fe_mul(Y3, t0, k);
  t1 = fe_mul(t1, Z3, k);
  Y3 = fe_add(t1, Y3, k);
  t0 = fe_mul(t0, t3, k);
  Z3 = fe_mul(Z3, t4, k);
  Z3 = fe_add(Z3, t0, k);
  Pt r;
  r.x = X3;
  r.y = Y3;
  r.z = Z3;
  return r;
}

// 15 x mod p for a Pasta p (p = 2^254 + d, d < 2^126, so 2p = 2^255 + 2d with
// 2d in words 0-3): v = 16 x - x < 2^260, q = v >> 255, then
// (v mod 2^255) - 2 q d, plus 2p if that borrowed. Below 2p for any 8-word
// x, and congruent to the Montgomery product by 3b R mod p of a curve with
// 3b = 15 (b = 5: Pallas and Vesta), but not always the same representative.
// Two subtraction chains, an addition chain and four small wide products,
// against a product's 176 multiplies or four doublings' eight chains.
__device__ __forceinline__ Fe fe_mul15_pasta(const Fe& x, const FieldConsts& k) {
  uint32_t x16[9], v[9];
  x16[0] = x.v[0] << 4;
#pragma unroll
  for (int i = 1; i < 8; ++i) x16[i] = __funnelshift_l(x.v[i - 1], x.v[i], 4);
  x16[8] = x.v[7] >> 28;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(v[0]) : "r"(x16[0]), "r"(x.v[0]));
#pragma unroll
  for (int i = 1; i < 8; ++i)
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(v[i]) : "r"(x16[i]), "r"(x.v[i]));
  asm volatile("subc.u32 %0, %1, 0;" : "=r"(v[8]) : "r"(x16[8]));
  const uint32_t q = (v[8] << 1) | (v[7] >> 31);
  v[7] &= 0x7FFFFFFFu;
  // q 2d < 2^132 in words 0-4
  const uint64_t w0 = (uint64_t)q * k.twop[0];
  const uint64_t w1 = (uint64_t)q * k.twop[1] + (w0 >> 32);
  const uint64_t w2 = (uint64_t)q * k.twop[2] + (w1 >> 32);
  const uint64_t w3 = (uint64_t)q * k.twop[3] + (w2 >> 32);
  Fe r;
  uint32_t m;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r.v[0]) : "r"(v[0]), "r"((uint32_t)w0));
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r.v[1]) : "r"(v[1]), "r"((uint32_t)w1));
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r.v[2]) : "r"(v[2]), "r"((uint32_t)w2));
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r.v[3]) : "r"(v[3]), "r"((uint32_t)w3));
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r.v[4]) : "r"(v[4]), "r"((uint32_t)(w3 >> 32)));
#pragma unroll
  for (int i = 5; i < 8; ++i) asm volatile("subc.cc.u32 %0, %1, 0;" : "=r"(r.v[i]) : "r"(v[i]));
  asm volatile("subc.u32 %0, 0, 0;" : "=r"(m));  // all ones iff it borrowed
  asm volatile("add.cc.u32 %0, %0, %1;" : "+r"(r.v[0]) : "r"(k.twop[0] & m));
#pragma unroll
  for (int i = 1; i < 7; ++i) asm volatile("addc.cc.u32 %0, %0, %1;" : "+r"(r.v[i]) : "r"(k.twop[i] & m));
  asm volatile("addc.u32 %0, %0, %1;" : "+r"(r.v[7]) : "r"(k.twop[7] & m));
  return r;
}

// pt_add_mixed's operation sequence on the carry-chain forms (kernel 10;
// kernels 2 and 5 keep pt_add_mixed): fe_mul_cc<kPasta>, fe_add_cc,
// fe_sub_cc. With kB15 (a Pasta modulus and 3b = 15) the two products by 3b
// are fe_mul15_pasta, so the coordinates are pt_add_mixed's up to their
// representatives (equal canonical values); without it they are
// pt_add_mixed's integers.
template <bool kPasta, bool kB15>
__device__ __forceinline__ Pt pt_add_mixed_cc(const Pt& a, const Fe& X2, const Fe& Y2,
                                              const FieldConsts& k) {
  static_assert(kPasta || !kB15, "fe_mul15_pasta needs a Pasta modulus");
  Fe t0 = fe_mul_cc<kPasta>(a.x, X2, k);
  Fe t1 = fe_mul_cc<kPasta>(a.y, Y2, k);
  Fe t3 = fe_add_cc(X2, Y2, k);
  Fe t4 = fe_add_cc(a.x, a.y, k);
  t3 = fe_mul_cc<kPasta>(t3, t4, k);
  t4 = fe_add_cc(t0, t1, k);
  t3 = fe_sub_cc(t3, t4, k);
  t4 = fe_mul_cc<kPasta>(Y2, a.z, k);
  t4 = fe_add_cc(t4, a.y, k);
  Fe Y3 = fe_mul_cc<kPasta>(X2, a.z, k);
  Y3 = fe_add_cc(Y3, a.x, k);
  Fe X3 = fe_add_cc(t0, t0, k);
  t0 = fe_add_cc(X3, t0, k);
  Fe t2;
  if constexpr (kB15) {
    t2 = fe_mul15_pasta(a.z, k);
  } else {
    t2 = fe_mul_cc<kPasta>(fe_from(k.b3), a.z, k);
  }
  Fe Z3 = fe_add_cc(t1, t2, k);
  t1 = fe_sub_cc(t1, t2, k);
  if constexpr (kB15) {
    Y3 = fe_mul15_pasta(Y3, k);
  } else {
    Y3 = fe_mul_cc<kPasta>(fe_from(k.b3), Y3, k);
  }
  X3 = fe_mul_cc<kPasta>(t4, Y3, k);
  t2 = fe_mul_cc<kPasta>(t3, t1, k);
  X3 = fe_sub_cc(t2, X3, k);
  Y3 = fe_mul_cc<kPasta>(Y3, t0, k);
  t1 = fe_mul_cc<kPasta>(t1, Z3, k);
  Y3 = fe_add_cc(t1, Y3, k);
  t0 = fe_mul_cc<kPasta>(t0, t3, k);
  Z3 = fe_mul_cc<kPasta>(Z3, t4, k);
  Z3 = fe_add_cc(Z3, t0, k);
  Pt r;
  r.x = X3;
  r.y = Y3;
  r.z = Z3;
  return r;
}

// Complete doubling, RCB15 algorithm 9 (a = 0); the same operation
// sequence as pdouble in ops/curve.py.
__device__ __forceinline__ Pt pt_double(const Pt& a, const FieldConsts& k) {
  Fe b3 = fe_from(k.b3);
  Fe t0 = fe_mul(a.y, a.y, k);
  Fe Z3 = fe_add(t0, t0, k);
  Z3 = fe_add(Z3, Z3, k);
  Z3 = fe_add(Z3, Z3, k);
  Fe t1 = fe_mul(a.y, a.z, k);
  Fe t2 = fe_mul(a.z, a.z, k);
  t2 = fe_mul(b3, t2, k);
  Fe X3 = fe_mul(t2, Z3, k);
  Fe Y3 = fe_add(t0, t2, k);
  Z3 = fe_mul(t1, Z3, k);
  t1 = fe_add(t2, t2, k);
  t2 = fe_add(t1, t2, k);
  t0 = fe_sub(t0, t2, k);
  Y3 = fe_mul(t0, Y3, k);
  Y3 = fe_add(X3, Y3, k);
  t1 = fe_mul(a.x, a.y, k);
  X3 = fe_mul(t0, t1, k);
  X3 = fe_add(X3, X3, k);
  Pt r;
  r.x = X3;
  r.y = Y3;
  r.z = Z3;
  return r;
}

// Complete projective addition, RCB15 algorithm 7 (a = 0); the same
// operation sequence as _full_padd in msm_pallas.py.
__device__ __forceinline__ Pt pt_add(const Pt& a, const Pt& b, const FieldConsts& k) {
  Fe b3 = fe_from(k.b3);
  Fe t0 = fe_mul(a.x, b.x, k);
  Fe t1 = fe_mul(a.y, b.y, k);
  Fe t2 = fe_mul(a.z, b.z, k);
  Fe t3 = fe_add(a.x, a.y, k);
  Fe t4 = fe_add(b.x, b.y, k);
  t3 = fe_mul(t3, t4, k);
  t4 = fe_add(t0, t1, k);
  t3 = fe_sub(t3, t4, k);
  t4 = fe_add(a.y, a.z, k);
  Fe X3 = fe_add(b.y, b.z, k);
  t4 = fe_mul(t4, X3, k);
  X3 = fe_add(t1, t2, k);
  t4 = fe_sub(t4, X3, k);
  X3 = fe_add(a.x, a.z, k);
  Fe Y3 = fe_add(b.x, b.z, k);
  X3 = fe_mul(X3, Y3, k);
  Y3 = fe_add(t0, t2, k);
  Y3 = fe_sub(X3, Y3, k);
  X3 = fe_add(t0, t0, k);
  t0 = fe_add(X3, t0, k);
  t2 = fe_mul(b3, t2, k);
  Fe Z3 = fe_add(t1, t2, k);
  t1 = fe_sub(t1, t2, k);
  Y3 = fe_mul(b3, Y3, k);
  X3 = fe_mul(t4, Y3, k);
  t2 = fe_mul(t3, t1, k);
  X3 = fe_sub(t2, X3, k);
  Y3 = fe_mul(Y3, t0, k);
  t1 = fe_mul(t1, Z3, k);
  Y3 = fe_add(t1, Y3, k);
  t0 = fe_mul(t0, t3, k);
  Z3 = fe_mul(Z3, t4, k);
  Z3 = fe_add(Z3, t0, k);
  Pt r;
  r.x = X3;
  r.y = Y3;
  r.z = Z3;
  return r;
}

// ---- the skip rule, shared by the bucket fold (kernel 3) and kernels 5-7 ----
// An operand that is the identity (Z = 0 mod p) is not added: the other one
// is returned as it is. The plain versions (ops/curve.py add_skip, dbl_skip)
// apply the same rule, so kernel and plain give the same coordinates.

// a >= b as 256-bit integers.
__device__ __forceinline__ bool fe_geq(const Fe& a, const uint32_t* b) {
#pragma unroll
  for (int i = 7; i >= 0; --i) {
    if (a.v[i] != b[i]) return a.v[i] > b[i];
  }
  return true;
}

// z = 0 mod p. Lazy values lie below 2^256 < 4p, so z is 0 mod p iff, after
// taking 2p off once if z >= 2p, it is 0 or p.
__device__ __forceinline__ bool is_identity(const Pt& a, const FieldConsts& k) {
  Fe z = a.z;
  if (fe_geq(z, k.twop)) {
    uint64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint64_t x = (uint64_t)z.v[i] - k.twop[i] - borrow;
      z.v[i] = (uint32_t)x;
      borrow = x >> 63;
    }
  }
  bool zero = true, isp = true;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    zero &= z.v[i] == 0;
    isp &= z.v[i] == k.p[i];
  }
  return zero || isp;
}

// b is the identity -> a; a is the identity -> b; else a + b.
__device__ __forceinline__ Pt add_skip(const Pt& a, const Pt& b, const FieldConsts& k) {
  if (is_identity(b, k)) return a;
  if (is_identity(a, k)) return b;
  return pt_add(a, b, k);
}

__device__ __forceinline__ Pt dbl_skip(const Pt& a, const FieldConsts& k) {
  return is_identity(a, k) ? a : pt_double(a, k);
}

// The point of the thread d lanes up within segments of `width` lanes (all
// 32 lanes of the warp take part); a thread whose source lies beyond its
// segment gets its own point back.
__device__ __forceinline__ Pt shfl_down_pt(const Pt& a, int d, int width = 32) {
  Pt r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.x.v[i] = __shfl_down_sync(0xffffffffu, a.x.v[i], d, width);
    r.y.v[i] = __shfl_down_sync(0xffffffffu, a.y.v[i], d, width);
    r.z.v[i] = __shfl_down_sync(0xffffffffu, a.z.v[i], d, width);
  }
  return r;
}

// 16 contiguous limbs as 4 loads or stores of 16 bytes (the address 16-byte
// aligned), and a point's 48 limbs (a bucket: 192 contiguous bytes).
__device__ __forceinline__ Fe fe_load16_v(const int4* s) {
  Fe r;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int4 v = s[q];
    r.v[2 * q] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    r.v[2 * q + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
  return r;
}

__device__ __forceinline__ void fe_store16_v(int4* d, const Fe& a) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t lo = a.v[2 * q], hi = a.v[2 * q + 1];
    d[q] = make_int4((int)(lo & 0xFFFFu), (int)(lo >> 16), (int)(hi & 0xFFFFu), (int)(hi >> 16));
  }
}

__device__ __forceinline__ Pt bucket_load(const int32_t* src) {
  const int4* s = reinterpret_cast<const int4*>(src);
  Pt r;
  r.x = fe_load16_v(s);
  r.y = fe_load16_v(s + 4);
  r.z = fe_load16_v(s + 8);
  return r;
}

__device__ __forceinline__ void bucket_store(int32_t* dst, const Pt& p) {
  int4* d = reinterpret_cast<int4*>(dst);
  fe_store16_v(d, p.x);
  fe_store16_v(d + 4, p.y);
  fe_store16_v(d + 8, p.z);
}

// The folds' additions (kernels 3 and 6) are calls, not inlined: a segment
// loop, a scan and a tree would otherwise inline several complete additions
// and a doubling into one kernel, which then runs out of registers and spills.
__device__ __noinline__ Pt fold_add(const Pt& a, const Pt& b, const FieldConsts& k) {
  return add_skip(a, b, k);
}

__device__ __noinline__ Pt fold_dbl(const Pt& a, const FieldConsts& k) { return dbl_skip(a, k); }

// ---- one complete addition on a group of W lanes (kernels 4 and 7) ----
// Each round of independent products of RCB15 algorithm 7 runs on lanes 0-5
// of the group at once, a product a lane (fe_mul_cc); lane j's product
// reaches every lane of the group by shuffles of width W, and every lane
// makes the additions and subtractions itself, so the group never diverges
// and every lane ends with the sum. All 32 lanes of the warp take part in
// each shuffle; lanes 6 .. W-1 of a group multiply operands no one reads.

// word by word a from lane `src` of this thread's group of W lanes
template <int W = 32>
__device__ __forceinline__ Fe shfl_fe(const Fe& a, int src) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = __shfl_sync(0xffffffffu, a.v[i], src, W);
  return r;
}

// c ? a : b word by word, in registers (a select of whole structs would go
// through a local-memory copy)
__device__ __forceinline__ Fe fe_sel(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// pt_add's operations and integers, its 14 general products in three rounds
// of 6, 2, 6; lanes 3-5 multiply sums (X1 + Y1)(X2 + Y2), (Y1 + Z1)(Y2 + Z2),
// (X1 + Z1)(X2 + Z2). Between rounds 1 and 2 lanes 0-3 each make one of the
// four sums t0b = 3 t0, y3, t3, t4 (two additions a lane instead of eight in
// a row), and lane 1 multiplies its own y3 in round 2. `lane` is the
// thread's lane within its group.
template <bool kPasta, int W = 32>
__device__ __forceinline__ Pt warp_add(const Pt& a, const Pt& b, const FieldConsts& k, int lane) {
  const Fe b3 = fe_from(k.b3);
  const bool x1 = lane == 0 || lane == 3 || lane == 5, y1 = lane == 1 || lane == 4;
  const bool y2 = lane == 3;
  Fe u = fe_sel(x1, a.x, fe_sel(y1, a.y, a.z)), v = fe_sel(x1, b.x, fe_sel(y1, b.y, b.z));
  const Fe us = fe_add_cc(u, fe_sel(y2, a.y, a.z), k), vs = fe_add_cc(v, fe_sel(y2, b.y, b.z), k);
  Fe r = fe_mul_cc<kPasta>(fe_sel(lane >= 3, us, u), fe_sel(lane >= 3, vs, v), k);
  const Fe t0 = shfl_fe<W>(r, 0), t1 = shfl_fe<W>(r, 1), t2 = shfl_fe<W>(r, 2);
  // lane 0: t0b = (t0 + t0) + t0; lane 1: y3 = r5 - (t0 + t2); lane 2: t3 = r3 - (t0 + t1);
  // lane 3: t4 = r4 - (t1 + t2)
  const Fe s = shfl_fe<W>(r, lane == 1 ? 5 : lane == 2 ? 3 : 4);
  const Fe A = fe_add_cc(fe_sel(lane == 3, t1, t0), fe_sel(lane == 0, t0, fe_sel(lane == 2, t1, t2)), k);
  const Fe m = fe_sel(lane == 0, fe_add_cc(A, t0, k), fe_sub_cc(s, A, k));
  r = fe_mul_cc<kPasta>(b3, fe_sel(lane == 0, t2, m), k);
  const Fe t0b = shfl_fe<W>(m, 0), t3 = shfl_fe<W>(m, 2), t4 = shfl_fe<W>(m, 3);
  const Fe t2b = shfl_fe<W>(r, 0), y3b = shfl_fe<W>(r, 1);
  const Fe z3 = fe_add_cc(t1, t2b, k);
  const Fe t1b = fe_sub_cc(t1, t2b, k);
  // lanes 0-5: t4 y3b, t3 t1b, y3b t0b, t1b z3, t0b t3, z3 t4
  u = fe_sel(lane == 0, t4, fe_sel(lane == 1, t3, fe_sel(lane == 2, y3b,
          fe_sel(lane == 3, t1b, fe_sel(lane == 4, t0b, z3)))));
  v = fe_sel(lane == 0, y3b, fe_sel(lane == 1, t1b, fe_sel(lane == 2, t0b,
          fe_sel(lane == 3, z3, fe_sel(lane == 4, t3, t4)))));
  r = fe_mul_cc<kPasta>(u, v, k);
  Pt out;
  out.x = fe_sub_cc(shfl_fe<W>(r, 1), shfl_fe<W>(r, 0), k);
  out.y = fe_add_cc(shfl_fe<W>(r, 3), shfl_fe<W>(r, 2), k);
  out.z = fe_add_cc(shfl_fe<W>(r, 5), shfl_fe<W>(r, 4), k);
  return out;
}

// The same addition on a group of 4 lanes (kernel 4's first level): rounds 1
// and 3 run in two halves, products 0-3 on lanes 0-3 and then products 4-5
// on lanes 0-1, so an addition takes five products' latency instead of three
// but a warp makes eight at once, with a sixth fewer lane-products each.
template <bool kPasta>
__device__ __forceinline__ Pt quad_add(const Pt& a, const Pt& b, const FieldConsts& k, int lane) {
  constexpr int W = 4;
  const Fe b3 = fe_from(k.b3);
  // round 1: X1 X2, Y1 Y2, Z1 Z2, (X1 + Y1)(X2 + Y2); then (Y1 + Z1)(Y2 + Z2), (X1 + Z1)(X2 + Z2)
  Fe u = fe_sel(lane == 0 || lane == 3, a.x, fe_sel(lane == 1, a.y, a.z));
  Fe v = fe_sel(lane == 0 || lane == 3, b.x, fe_sel(lane == 1, b.y, b.z));
  const Fe us = fe_add_cc(u, a.y, k), vs = fe_add_cc(v, b.y, k);
  const Fe ra = fe_mul_cc<kPasta>(fe_sel(lane == 3, us, u), fe_sel(lane == 3, vs, v), k);
  u = fe_add_cc(fe_sel(lane == 0, a.y, a.x), a.z, k);
  v = fe_add_cc(fe_sel(lane == 0, b.y, b.x), b.z, k);
  const Fe rb = fe_mul_cc<kPasta>(u, v, k);
  const Fe t0 = shfl_fe<W>(ra, 0), t1 = shfl_fe<W>(ra, 1), t2 = shfl_fe<W>(ra, 2);
  const Fe s3 = shfl_fe<W>(ra, 3), s4 = shfl_fe<W>(rb, 0), s5 = shfl_fe<W>(rb, 1);
  // lane 0: t0b = (t0 + t0) + t0; lane 1: y3 = s5 - (t0 + t2); lane 2: t3 = s3 - (t0 + t1);
  // lane 3: t4 = s4 - (t1 + t2)
  const Fe s = fe_sel(lane == 1, s5, fe_sel(lane == 2, s3, s4));
  const Fe A = fe_add_cc(fe_sel(lane == 3, t1, t0), fe_sel(lane == 0, t0, fe_sel(lane == 2, t1, t2)), k);
  const Fe m = fe_sel(lane == 0, fe_add_cc(A, t0, k), fe_sub_cc(s, A, k));
  const Fe r = fe_mul_cc<kPasta>(b3, fe_sel(lane == 0, t2, m), k);
  const Fe t0b = shfl_fe<W>(m, 0), t3 = shfl_fe<W>(m, 2), t4 = shfl_fe<W>(m, 3);
  const Fe t2b = shfl_fe<W>(r, 0), y3b = shfl_fe<W>(r, 1);
  const Fe z3 = fe_add_cc(t1, t2b, k);
  const Fe t1b = fe_sub_cc(t1, t2b, k);
  // round 3: t4 y3b, t3 t1b, y3b t0b, t1b z3; then t0b t3, z3 t4
  u = fe_sel(lane == 0, t4, fe_sel(lane == 1, t3, fe_sel(lane == 2, y3b, t1b)));
  v = fe_sel(lane == 0, y3b, fe_sel(lane == 1, t1b, fe_sel(lane == 2, t0b, z3)));
  const Fe rc = fe_mul_cc<kPasta>(u, v, k);
  const Fe rd = fe_mul_cc<kPasta>(fe_sel(lane == 0, t0b, z3), fe_sel(lane == 0, t3, t4), k);
  Pt out;
  out.x = fe_sub_cc(shfl_fe<W>(rc, 1), shfl_fe<W>(rc, 0), k);
  out.y = fe_add_cc(shfl_fe<W>(rc, 3), shfl_fe<W>(rc, 2), k);
  out.z = fe_add_cc(shfl_fe<W>(rd, 1), shfl_fe<W>(rd, 0), k);
  return out;
}
