// Pieces of batch inversion shared by kernel C (csrc/scan.cu) and kernel G
// (csrc/grand_product.cu): the product operator of a scan, the zero test
// of the lazy domain, and the inverse of one value by a binary GCD
// (fe_inverse_gcd; ops/scan.py inverse_model is the same algorithm in
// Python integers).
//
// The inverse: Bernstein and Yang's divsteps ("Fast constant-time gcd
// computation and modular inversion", 2019) in the form of libsecp256k1's
// modinv32: batches of 30 divsteps on the low 32 bits of f and g, each
// batch's 2x2 matrix applied to f, g and to d, e mod p on signed 30-bit
// limbs, at most 20 batches (600 divsteps; 590 suffice for inputs below
// 2^256), ending when g is 0. It inverts the canonical value x = a R, and
// one product by R^3 mod p turns (a R)^-1 into a^-1 R.
#pragma once
#include "scan.cuh"

constexpr int kInvSteps = 30;    // divsteps a batch
constexpr int kInvBatches = 20;  // batches at most: 600 >= 590 divsteps
constexpr int32_t kM30 = (int32_t)(0xFFFFFFFFu >> 2);

// the product of 256-bit values mod p
template <bool kPasta>
struct MulOp {
  struct S {
    static constexpr int kWords = 8;
    Fe a;
  };
  using Pw = NoPow;
  FieldConsts k;
  __device__ S identity() const { return S{fe_from(k.one)}; }
  __device__ S combine(const S& x, const S& y, const Pw&) const { return S{fe_mul_cc<kPasta>(x.a, y.a, k)}; }
  __device__ Pw pow2(int) const { return {}; }
  __device__ Pw lane_pow(int) const { return {}; }
  __device__ Pw warp_pow(int) const { return {}; }
  __device__ Pw row_pow(int) const { return {}; }
  __device__ Pw pw_mul(const Pw&, const Pw&) const { return {}; }
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

// ---- the inverse ----

// A signed integer in 9 limbs of 30 bits: limbs 0-7 in [0, 2^30), limb 8
// signed (it carries the sign).
struct S30 {
  int32_t v[9];
};

struct Trans {
  int32_t u, v, q, r;
};

__device__ __forceinline__ S30 s30_from(const Fe& a) {
  S30 r;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int bit = 30 * i, w = bit >> 5, s = bit & 31;
    uint32_t x = a.v[w] >> s;
    if (s > 2 && w + 1 < 8) x |= a.v[w + 1] << (32 - s);
    r.v[i] = i < 8 ? (int32_t)(x & (uint32_t)kM30) : (int32_t)x;
  }
  return r;
}

// back to 8 words; a must lie in [0, 2^256)
__device__ __forceinline__ Fe s30_words(const S30& a) {
  Fe r;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const int i = (32 * w) / 30, s = 32 * w - 30 * i;
    r.v[w] = ((uint32_t)a.v[i] >> s) | ((uint32_t)a.v[i + 1] << (30 - s));
  }
  return r;
}

// limbs 0-7 back into [0, 2^30), the carry into limb 8
__device__ __forceinline__ void s30_carry(S30& a) {
  int32_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += a.v[i];
    a.v[i] = c & kM30;
    c >>= 30;
  }
  a.v[8] += c;
}

// a + m p, m in {-1, 1}
__device__ __forceinline__ void s30_add_p(S30& a, const S30& p, int32_t m) {
#pragma unroll
  for (int i = 0; i < 9; ++i) a.v[i] += m * p.v[i];
  s30_carry(a);
}

__device__ __forceinline__ bool s30_is_zero(const S30& a) {
  int32_t o = 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) o |= a.v[i];
  return o == 0;
}

// kInvSteps divsteps on the low words of f and g (f odd), zeta =
// -(delta + 1/2): the new zeta, and the matrix t with t [f; g] = 2^30 [f'; g']
// (libsecp256k1's secp256k1_modinv32_divsteps_30). As in its variable-time
// form, a run of g's zero low bits is taken at once (each such divstep only
// halves g), and so are up to 8 divsteps that add f to an odd g, which no
// swap can interrupt while zeta stays at 0 or above: they add w f to g for
// the w = -g / f mod 2^k that clears g's k low bits.
__device__ __forceinline__ int32_t divsteps_30(int32_t zeta, uint32_t f0, uint32_t g0, Trans& t) {
  uint32_t u = 1, v = 0, q = 0, r = 1, f = f0, g = g0;
  for (int i = kInvSteps;;) {
    const int zeros = __ffs(g | (0xFFFFFFFFu << i)) - 1;  // at most the i steps left
    g >>= zeros;
    u <<= zeros;
    v <<= zeros;
    zeta -= zeros;
    i -= zeros;
    if (i == 0) break;
    if (zeta < 0) {  // g odd, delta > 0: (f, g) = (g, -f), and the step's halving follows
      const uint32_t f1 = f, u1 = u, v1 = v;
      f = g;
      u = q;
      v = r;
      g = 0u - f1;
      q = 0u - u1;
      r = 0u - v1;
      zeta = -zeta - 1;
    }
    const int limit = min(zeta + 1, i);  // divsteps before a swap can come, at most i
    const uint32_t m = (0xFFFFFFFFu >> (32 - limit)) & 255u;
    uint32_t inv = f;  // f^-1 mod 2^12 by Newton's iteration (f f = 1 mod 8)
    inv *= 2u - f * inv;
    inv *= 2u - f * inv;
    const uint32_t w = (0u - g * inv) & m;
    g += f * w;
    q += u * w;
    r += v * w;
  }
  t = Trans{(int32_t)u, (int32_t)v, (int32_t)q, (int32_t)r};
  return zeta;
}

// [f; g] = t [f; g] / 2^30, exact
__device__ __forceinline__ void update_fg(S30& f, S30& g, const Trans& t) {
  int64_t cf = (int64_t)t.u * f.v[0] + (int64_t)t.v * g.v[0];
  int64_t cg = (int64_t)t.q * f.v[0] + (int64_t)t.r * g.v[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    cf += (int64_t)t.u * f.v[i] + (int64_t)t.v * g.v[i];
    cg += (int64_t)t.q * f.v[i] + (int64_t)t.r * g.v[i];
    f.v[i - 1] = (int32_t)cf & kM30;
    cf >>= 30;
    g.v[i - 1] = (int32_t)cg & kM30;
    cg >>= 30;
  }
  f.v[8] = (int32_t)cf;
  g.v[8] = (int32_t)cg;
}

// [d; e] = t [d; e] / 2^30 mod p, d and e kept in (-2p, p)
// (libsecp256k1 secp256k1_modinv32_update_de_30); pinv = p^-1 mod 2^30
__device__ __forceinline__ void update_de(S30& d, S30& e, const Trans& t, const S30& p, uint32_t pinv) {
  const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
  int32_t md = (t.u & sd) + (t.v & se), me = (t.q & sd) + (t.r & se);
  int64_t cd = (int64_t)t.u * d.v[0] + (int64_t)t.v * e.v[0];
  int64_t ce = (int64_t)t.q * d.v[0] + (int64_t)t.r * e.v[0];
  md -= (int32_t)((pinv * (uint32_t)cd + (uint32_t)md) & (uint32_t)kM30);
  me -= (int32_t)((pinv * (uint32_t)ce + (uint32_t)me) & (uint32_t)kM30);
  cd += (int64_t)p.v[0] * md;
  ce += (int64_t)p.v[0] * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    cd += (int64_t)t.u * d.v[i] + (int64_t)t.v * e.v[i] + (int64_t)p.v[i] * md;
    ce += (int64_t)t.q * d.v[i] + (int64_t)t.r * e.v[i] + (int64_t)p.v[i] * me;
    d.v[i - 1] = (int32_t)cd & kM30;
    cd >>= 30;
    e.v[i - 1] = (int32_t)ce & kM30;
    ce >>= 30;
  }
  d.v[8] = (int32_t)cd;
  e.v[8] = (int32_t)ce;
}

// a^-1 R mod p for a nonzero x = a R in [0, 2p) (Montgomery form), in
// [0, 2p); r3 = R^3 mod p. One thread.
template <bool kPasta>
__device__ __forceinline__ Fe fe_inverse_gcd(const Fe& x, const Fe& r3, const FieldConsts& k) {
  Fe c;  // x mod p: x - p unless that borrows
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t s = (uint64_t)x.v[i] - k.p[i] - borrow;
    c.v[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  if (borrow) c = x;
  const S30 p = s30_from(fe_from(k.p));
  const uint32_t pinv = (0u - k.n0) & (uint32_t)kM30;  // n0 = -p^-1 mod 2^32
  S30 f = p, g = s30_from(c), d, e;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    d.v[i] = 0;
    e.v[i] = i == 0;
  }
  int32_t zeta = -1;
  for (int b = 0; b < kInvBatches && !s30_is_zero(g); ++b) {
    Trans t;
    zeta = divsteps_30(zeta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
    update_de(d, e, t, p, pinv);
    update_fg(f, g, t);
  }
  // f = +-1 and f = d x mod p: x^-1 = sign(f) d, d in (-2p, p)
  if (f.v[8] < 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) d.v[i] = -d.v[i];
    s30_carry(d);
  }
  if (d.v[8] < 0) s30_add_p(d, p, 1);
  if (d.v[8] < 0) s30_add_p(d, p, 1);
  S30 t = d;
  s30_add_p(t, p, -1);
  if (t.v[8] >= 0) d = t;
  return fe_mul_cc<kPasta>(s30_words(d), r3, k);
}
