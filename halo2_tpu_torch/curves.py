"""Host-side elliptic-curve specification layer (short Weierstrass, a = 0).

Executable spec for the curves the framework supports (SURVEY.md layer 0):

  * Pallas:  y^2 = x^3 + 5 over Fp, group order q (scalar field Fq)
  * Vesta:   y^2 = x^3 + 5 over Fq, group order p (scalar field Fp)
  * BN254 G1: y^2 = x^3 + 3 over FqBn, group order r (scalar field FrBn)

Generators are (-1, 2) for the Pasta curves and (1, 2) for BN254 G1, matching
halo2curves 0.3.2.

Compressed encodings follow halo2curves / pasta_curves: 32 bytes = x in
little-endian with the parity of y in the top bit of the last byte; the
identity encodes as 32 zero bytes. Used for proof bytes by
`TranscriptWrite::write_point` (reference `halo2_proofs/src/transcript.rs`).

Internally points are carried in Jacobian coordinates as plain int tuples
(X, Y, Z) with the identity encoded as Z = 0; all hot loops (MSM, batched
adds) use module-level functions over those tuples. The TPU counterpart is
`halo2_tpu_torch.ops.curve` which mirrors these formulas branchlessly over limb
tensors.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Type

from .fields import FieldElement, Fp, FpSecp, Fq, FqBn, FqSecp, FrBn

# Jacobian point = (X, Y, Z) ints; identity = (0, 1, 0) with Z == 0.
Jac = Tuple[int, int, int]

JAC_IDENTITY: Jac = (0, 1, 0)


def jac_is_identity(pt: Jac) -> bool:
    return pt[2] == 0


def jac_double(pt: Jac, p: int) -> Jac:
    """Doubling for a = 0 (2M + 5S single-point form)."""
    X1, Y1, Z1 = pt
    if Z1 == 0 or Y1 == 0:
        return JAC_IDENTITY
    A = X1 * X1 % p
    B = Y1 * Y1 % p
    C = B * B % p
    t = (X1 + B) % p
    D = (2 * (t * t - A - C)) % p  # 2*((X1+B)^2 - A - C)
    E = 3 * A % p
    F = E * E % p
    X3 = (F - 2 * D) % p
    Y3 = (E * (D - X3) - 8 * C) % p
    Z3 = 2 * Y1 * Z1 % p
    return (X3, Y3, Z3)


def jac_add(a: Jac, b: Jac, p: int) -> Jac:
    """Complete Jacobian + Jacobian addition (handles identity and doubling)."""
    X1, Y1, Z1 = a
    X2, Y2, Z2 = b
    if Z1 == 0:
        return b
    if Z2 == 0:
        return a
    Z1Z1 = Z1 * Z1 % p
    Z2Z2 = Z2 * Z2 % p
    U1 = X1 * Z2Z2 % p
    U2 = X2 * Z1Z1 % p
    S1 = Y1 * Z2 * Z2Z2 % p
    S2 = Y2 * Z1 * Z1Z1 % p
    if U1 == U2:
        if S1 != S2:
            return JAC_IDENTITY
        return jac_double(a, p)
    H = (U2 - U1) % p
    I = (2 * H) * (2 * H) % p
    J = H * I % p
    r = 2 * (S2 - S1) % p
    V = U1 * I % p
    X3 = (r * r - J - 2 * V) % p
    Y3 = (r * (V - X3) - 2 * S1 * J) % p
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) % p * H % p
    return (X3, Y3, Z3)


def jac_add_affine(a: Jac, bx: int, by: int, p: int) -> Jac:
    """Mixed addition: Jacobian + affine (Z2 = 1)."""
    X1, Y1, Z1 = a
    if Z1 == 0:
        return (bx, by, 1)
    Z1Z1 = Z1 * Z1 % p
    U2 = bx * Z1Z1 % p
    S2 = by * Z1 * Z1Z1 % p
    if U2 == X1:
        if S2 != Y1:
            return JAC_IDENTITY
        return jac_double(a, p)
    H = (U2 - X1) % p
    HH = H * H % p
    I = 4 * HH % p
    J = H * I % p
    r = 2 * (S2 - Y1) % p
    V = X1 * I % p
    X3 = (r * r - J - 2 * V) % p
    Y3 = (r * (V - X3) - 2 * Y1 * J) % p
    Z3 = (Z1 + H) * (Z1 + H) % p
    Z3 = (Z3 - Z1Z1 - HH) % p
    return (X3, Y3, Z3)


def jac_neg(a: Jac, p: int) -> Jac:
    return (a[0], (-a[1]) % p, a[2])


def jac_mul(a: Jac, k: int, p: int) -> Jac:
    """Double-and-add scalar multiplication (host spec; not constant time)."""
    acc = JAC_IDENTITY
    if k == 0 or a[2] == 0:
        return acc
    add = a
    while k:
        if k & 1:
            acc = jac_add(acc, add, p)
        add = jac_double(add, p)
        k >>= 1
    return acc


def jac_to_affine(a: Jac, p: int) -> Optional[Tuple[int, int]]:
    if a[2] == 0:
        return None
    zinv = pow(a[2], -1, p)
    zinv2 = zinv * zinv % p
    return (a[0] * zinv2 % p, a[1] * zinv2 % p * zinv % p)


def batch_to_affine(pts: Sequence[Jac], p: int) -> List[Optional[Tuple[int, int]]]:
    """Batch-normalize Jacobian points with a single inversion."""
    zs = [pt[2] for pt in pts]
    prefix = []
    acc = 1
    for z in zs:
        prefix.append(acc)
        if z != 0:
            acc = acc * z % p
    inv = pow(acc, -1, p) if acc != 1 or any(z != 0 for z in zs) else 1
    out: List[Optional[Tuple[int, int]]] = [None] * len(pts)
    for i in range(len(pts) - 1, -1, -1):
        X, Y, Z = pts[i]
        if Z == 0:
            out[i] = None
            continue
        zinv = inv * prefix[i] % p
        inv = inv * Z % p
        zinv2 = zinv * zinv % p
        out[i] = (X * zinv2 % p, Y * zinv2 % p * zinv % p)
    return out


class Curve:
    """A short-Weierstrass curve y^2 = x^3 + B with a = 0.

    Class attributes are set by subclasses; affine points are `Point`
    instances bound to the curve class.
    """

    BASE: Type[FieldElement]  # coordinate field
    SCALAR: Type[FieldElement]  # scalar field (group order)
    B: int
    GENERATOR_XY: Tuple[int, int]
    CURVE_ID: str = ""  # hash-to-curve curve id, e.g. "pallas"
    COMPRESSED_SIZE: int = 32  # 33 when the base field fills all 256 bits

    @classmethod
    def p(cls) -> int:
        return cls.BASE.MODULUS

    @classmethod
    def identity(cls) -> "Point":
        return Point(cls, None)

    @classmethod
    def generator(cls) -> "Point":
        return Point(cls, cls.GENERATOR_XY)

    @classmethod
    def from_jacobian(cls, j: Jac) -> "Point":
        return Point(cls, jac_to_affine(j, cls.p()))

    @classmethod
    def is_on_curve(cls, x: int, y: int) -> bool:
        p = cls.p()
        return (y * y - (x * x % p * x + cls.B)) % p == 0

    @classmethod
    def from_xy(cls, x: int, y: int) -> "Point":
        if not cls.is_on_curve(x, y):
            raise ValueError("point not on curve")
        return Point(cls, (x, y))

    # -- compressed serialization (halo2curves convention) --
    @classmethod
    def from_bytes(cls, b: bytes) -> "Point":
        assert len(b) == cls.COMPRESSED_SIZE
        if cls.COMPRESSED_SIZE == 33:
            sign = b[32] >> 7
            x = int.from_bytes(b[:32], "little")
        else:
            sign = b[31] >> 7
            xb = bytes(b[:31]) + bytes([b[31] & 0x7F])
            x = int.from_bytes(xb, "little")
        if x == 0 and sign == 0:
            return cls.identity()
        if x >= cls.p():
            raise ValueError("x out of range")
        p = cls.p()
        rhs = cls.BASE((x * x % p * x + cls.B) % p)
        y = rhs.sqrt()
        if y is None:
            raise ValueError("not a valid x-coordinate")
        yv = y.v
        if (yv & 1) != sign:
            yv = p - yv
        return Point(cls, (x, yv))

    @classmethod
    def from_bytes_uncompressed(cls, b: bytes) -> "Point":
        assert len(b) == 64
        x = int.from_bytes(b[:32], "little")
        y = int.from_bytes(b[32:], "little")
        if x == 0 and y == 0:
            return cls.identity()
        return cls.from_xy(x, y)


class Point:
    """Affine point on `curve` (None coords = identity)."""

    __slots__ = ("curve", "xy")

    def __init__(self, curve: Type[Curve], xy: Optional[Tuple[int, int]]):
        self.curve = curve
        self.xy = xy

    # -- predicates / accessors --
    def is_identity(self) -> bool:
        return self.xy is None

    @property
    def x(self) -> FieldElement:
        return self.curve.BASE(self.xy[0])

    @property
    def y(self) -> FieldElement:
        return self.curve.BASE(self.xy[1])

    def jacobian(self) -> Jac:
        if self.xy is None:
            return JAC_IDENTITY
        return (self.xy[0], self.xy[1], 1)

    # -- group ops (convenience; hot paths use jac_* directly) --
    def __add__(self, o: "Point") -> "Point":
        assert self.curve is o.curve
        return self.curve.from_jacobian(jac_add(self.jacobian(), o.jacobian(), self.curve.p()))

    def __neg__(self) -> "Point":
        if self.xy is None:
            return self
        return Point(self.curve, (self.xy[0], (-self.xy[1]) % self.curve.p()))

    def __sub__(self, o: "Point") -> "Point":
        return self + (-o)

    def mul(self, k) -> "Point":
        k = int(k) % self.curve.SCALAR.MODULUS
        return self.curve.from_jacobian(jac_mul(self.jacobian(), k, self.curve.p()))

    def __eq__(self, o) -> bool:
        return isinstance(o, Point) and o.curve is self.curve and o.xy == self.xy

    def __hash__(self):
        return hash((self.curve.__name__, self.xy))

    def __repr__(self):
        if self.xy is None:
            return f"{self.curve.__name__}(identity)"
        return f"{self.curve.__name__}(0x{self.xy[0]:x}, 0x{self.xy[1]:x})"

    def to_bytes(self) -> bytes:
        """Compressed encoding: x LE, top bit = parity of y; identity = zeros.
        Curves with COMPRESSED_SIZE = 33 carry the sign in a trailing byte
        (halo2curves Secp256k1Compressed)."""
        size = self.curve.COMPRESSED_SIZE
        if self.xy is None:
            return bytes(size)
        if size == 33:
            return self.xy[0].to_bytes(32, "little") + bytes(
                [(self.xy[1] & 1) << 7]
            )
        xb = bytearray(self.xy[0].to_bytes(32, "little"))
        xb[31] |= (self.xy[1] & 1) << 7
        return bytes(xb)

    def to_bytes_uncompressed(self) -> bytes:
        """Raw encoding: x LE || y LE (halo2curves raw); identity = zeros."""
        if self.xy is None:
            return bytes(64)
        return self.xy[0].to_bytes(32, "little") + self.xy[1].to_bytes(32, "little")


class Pallas(Curve):
    BASE = Fp
    SCALAR = Fq
    B = 5
    GENERATOR_XY = (Fp.MODULUS - 1, 2)
    CURVE_ID = "pallas"


class Vesta(Curve):
    BASE = Fq
    SCALAR = Fp
    B = 5
    GENERATOR_XY = (Fq.MODULUS - 1, 2)
    CURVE_ID = "vesta"


class Bn254G1(Curve):
    BASE = FqBn
    SCALAR = FrBn
    B = 3
    GENERATOR_XY = (1, 2)
    CURVE_ID = "bn254-g1"


class Secp256k1(Curve):
    """secp256k1 (halo2curves secp256k1/curve.rs). The 256-bit base field
    leaves no spare bit in 32 bytes, so compressed points carry a 33rd
    sign byte (halo2curves Secp256k1Compressed)."""

    BASE = FpSecp
    SCALAR = FqSecp
    B = 7
    GENERATOR_XY = (
        0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
        0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
    )
    CURVE_ID = "secp256k1"
    COMPRESSED_SIZE = 33
