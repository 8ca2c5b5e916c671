"""Host-side prime-field specification layer.

This module is the *executable specification* of the field arithmetic used
throughout the framework: exact arbitrary-precision arithmetic over the Pasta
(Pallas/Vesta) and BN254 base/scalar fields, with the byte-level encodings of
`halo2curves` (tag 0.3.2, see reference `halo2_proofs/Cargo.toml:56`).

It plays the role the `ff`/`halo2curves` crates play for the Rust reference
(SURVEY.md layer 0): every TPU kernel (limb-based Montgomery arithmetic, NTT,
MSM) is tested for exact agreement with this layer, and all
serialization/transcript boundaries round-trip through it.

Design notes (TPU-first):
  * Scalars that live on the host (Fiat-Shamir challenges, single polynomial
    evaluations, domain constants) use these classes directly - native Python
    bigints are both exact and fast for scalar work.
  * Bulk vectors (witness columns, polynomial coefficient arrays) live as
    limb tensors on device; see `halo2_tpu_torch.ops.field`. Conversions happen
    only at serialization boundaries.

Reference parity notes:
  * `to_repr`/`from_repr`: 32-byte little-endian canonical encoding
    (`ff::PrimeField::to_repr` for both pasta and bn256 fields).
  * `from_uniform_bytes`: 64-byte little-endian integer reduced mod p
    (`ff::FromUniformBytes<64>`), used by `Challenge255`
    (reference `halo2_proofs/src/transcript.rs:486-519`).
  * Constants (GENERATOR, S, ROOT_OF_UNITY, DELTA) follow the `ff::PrimeField`
    definitions: ROOT_OF_UNITY = GENERATOR^((p-1)/2^S),
    DELTA = GENERATOR^(2^S).
"""

from __future__ import annotations

from typing import Iterable, Type


class FieldElement:
    """An element of a prime field, stored as a canonical Python int.

    Subclasses define MODULUS / GENERATOR / S; all derived constants are
    computed in ``__init_subclass__``.
    """

    __slots__ = ("v",)

    # Filled in by __init_subclass__
    MODULUS: int = 0
    GENERATOR: int = 0  # multiplicative generator of the full group
    S: int = 0  # 2-adicity
    ROOT_OF_UNITY: int = 0
    ROOT_OF_UNITY_INV: int = 0
    DELTA: int = 0
    TWO_INV: int = 0
    ZETA: int = 0  # element of multiplicative order 3
    NUM_BITS: int = 0
    REPR_BYTES: int = 32

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if not cls.MODULUS:
            return
        p = cls.MODULUS
        t = (p - 1) >> cls.S
        cls.ROOT_OF_UNITY = pow(cls.GENERATOR, t, p)
        cls.ROOT_OF_UNITY_INV = pow(cls.ROOT_OF_UNITY, p - 2, p)
        cls.DELTA = pow(cls.GENERATOR, 1 << cls.S, p)
        cls.TWO_INV = pow(2, p - 2, p)
        if (p - 1) % 3 == 0:
            # halo2curves picks g^(2(p-1)/3), not g^((p-1)/3): validated by
            # the plonk_api.rs pinned VK's lookup-table commitment (the
            # table contains 2834758237 * ZETA). Consensus-critical: ZETA is
            # the extended-domain coset generator (poly/domain.py).
            cls.ZETA = pow(cls.GENERATOR, 2 * (p - 1) // 3, p)
        cls.NUM_BITS = p.bit_length()
        # Tonelli-Shanks precomputation
        cls._TS_T = t  # odd part of p-1

    def __init__(self, v: int = 0):
        self.v = v % self.MODULUS

    # ---- constructors ----
    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)

    @classmethod
    def from_repr(cls, b: bytes) -> "FieldElement":
        """Canonical little-endian decode; raises if >= modulus."""
        assert len(b) == cls.REPR_BYTES
        v = int.from_bytes(b, "little")
        if v >= cls.MODULUS:
            raise ValueError("non-canonical field encoding")
        return cls(v)

    @classmethod
    def from_uniform_bytes(cls, b: bytes) -> "FieldElement":
        """512-bit little-endian integer reduced mod p (ff::FromUniformBytes<64>)."""
        assert len(b) == 64
        return cls(int.from_bytes(b, "little") % cls.MODULUS)

    @classmethod
    def random(cls, rng) -> "FieldElement":
        """Sample per `ff::Field::random`: 64 uniform bytes reduced mod p.

        `rng` must expose `fill_bytes(n) -> bytes` (see
        halo2_tpu_torch.utils.chacha.ChaCha20Rng) or be a `random.Random`.

        Matches halo2curves `field_common!`'s `random` which draws two u64x4
        wide limbs; equivalent to reducing 64 LE bytes mod p.
        """
        if hasattr(rng, "fill_bytes"):
            return cls.from_uniform_bytes(rng.fill_bytes(64))
        return cls(rng.randrange(cls.MODULUS))

    # ---- encodings ----
    def to_repr(self) -> bytes:
        return self.v.to_bytes(self.REPR_BYTES, "little")

    # ---- arithmetic ----
    def __add__(self, o):
        return type(self)(self.v + o.v)

    def __sub__(self, o):
        return type(self)(self.v - o.v)

    def __mul__(self, o):
        return type(self)(self.v * o.v)

    def __neg__(self):
        return type(self)(-self.v)

    def double(self):
        return type(self)(self.v << 1)

    def square(self):
        return type(self)(self.v * self.v)

    def __pow__(self, e: int):
        return type(self)(pow(self.v, e, self.MODULUS))

    def invert(self):
        if self.v == 0:
            raise ZeroDivisionError("inversion of zero field element")
        return type(self)(pow(self.v, -1, self.MODULUS))

    def is_zero(self) -> bool:
        return self.v == 0

    def is_odd(self) -> bool:
        return bool(self.v & 1)

    def sqrt(self):
        """Return a square root or None (Tonelli-Shanks).

        No sign convention: callers that need a particular root (point
        decompression) select by parity.
        """
        p = self.MODULUS
        if self.v == 0:
            return type(self)(0)
        if pow(self.v, (p - 1) >> 1, p) != 1:
            return None
        # Tonelli-Shanks with the field's ROOT_OF_UNITY as the 2^S generator
        m = self.S
        c = self.ROOT_OF_UNITY
        t_ = pow(self.v, self._TS_T, p)
        r = pow(self.v, (self._TS_T + 1) >> 1, p)
        while t_ != 1:
            # find least i: t^(2^i) == 1
            i, t2 = 0, t_
            while t2 != 1:
                t2 = t2 * t2 % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m = i
            c = b * b % p
            t_ = t_ * c % p
            r = r * b % p
        return type(self)(r)

    # ---- comparisons / misc ----
    def __eq__(self, o):
        return isinstance(o, FieldElement) and type(o) is type(self) and o.v == self.v

    def __hash__(self):
        return hash((type(self).__name__, self.v))

    def __repr__(self):
        return f"{type(self).__name__}(0x{self.v:064x})"

    def __int__(self):
        return self.v

    # Debug formatting parity with halo2curves `Debug` impl:
    # prints as 0x-prefixed 64-nibble big-endian hex. Used by the pinned-VK
    # transcript repr (reference `halo2_proofs/src/plonk.rs:302-315`).
    def rust_debug(self) -> str:
        return f"0x{self.v:064x}"


# --------------------------------------------------------------------------
# Pasta fields (halo2curves::pasta, re-exported from zcash pasta_curves).
# p = 2^254 + 45560315531419706090280762371685220353
# q = 2^254 + 45560315531506369815346746415080538113
# Pallas: y^2 = x^3 + 5 over Fp, scalar field Fq.
# Vesta:  y^2 = x^3 + 5 over Fq, scalar field Fp.
# GENERATOR = 5, S = 32 for both (pasta_curves field definitions).
# --------------------------------------------------------------------------

PASTA_P = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
PASTA_Q = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001


class Fp(FieldElement):
    """Pallas base field / Vesta scalar field."""

    MODULUS = PASTA_P
    GENERATOR = 5
    S = 32


class Fq(FieldElement):
    """Vesta base field / Pallas scalar field."""

    MODULUS = PASTA_Q
    GENERATOR = 5
    S = 32


# --------------------------------------------------------------------------
# BN254 (halo2curves::bn256). G1: y^2 = x^3 + 3 over FqBn, scalar FrBn.
# Fr GENERATOR = 7, S = 28; Fq GENERATOR = 3 (S = 1).
# --------------------------------------------------------------------------

BN254_FR = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
BN254_FQ = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47


class FrBn(FieldElement):
    """BN254 scalar field."""

    MODULUS = BN254_FR
    GENERATOR = 7
    S = 28


class FqBn(FieldElement):
    """BN254 base field."""

    MODULUS = BN254_FQ
    GENERATOR = 3
    S = 1


# --------------------------------------------------------------------------
# secp256k1 (halo2curves secp256k1/{fp,fq}.rs; in halo2curves' concrete
# curve set, SURVEY.md layer 0). Not FFT-friendly (S = 1 / S = 6): used for
# in-circuit ECC/ECDSA, never as a proof-system domain field.
# --------------------------------------------------------------------------

SECP_P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
SECP_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141


class FpSecp(FieldElement):
    """secp256k1 base field (2^256 - 2^32 - 977)."""

    MODULUS = SECP_P
    GENERATOR = 3
    S = 1


class FqSecp(FieldElement):
    """secp256k1 scalar field (the group order)."""

    MODULUS = SECP_N
    GENERATOR = 7
    S = 6


def batch_invert(elems: Iterable[FieldElement]) -> list:
    """Montgomery's trick: invert many elements with one field inversion.

    Zero elements are passed through unchanged (matching the semantics of
    `Assigned` batch inversion, reference `halo2_proofs/src/poly.rs:179-206`).
    """
    elems = list(elems)
    if not elems:
        return []
    cls: Type[FieldElement] = type(elems[0])
    p = cls.MODULUS
    prefix = []
    acc = 1
    for e in elems:
        prefix.append(acc)
        if e.v != 0:
            acc = acc * e.v % p
    inv = pow(acc, -1, p)
    out = [None] * len(elems)
    for i in range(len(elems) - 1, -1, -1):
        e = elems[i]
        if e.v == 0:
            out[i] = e
        else:
            out[i] = cls(inv * prefix[i])
            inv = inv * e.v % p
    return out
