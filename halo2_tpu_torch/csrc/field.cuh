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
// p, unless it is fe_sub's b and a < b - 2p < 2^126: a further 2^-129.
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
