"""Hash-to-curve for parameter/generator derivation.

The reference derives IPA generators via pasta_curves'
`hash_to_curve(domain_prefix)` — RFC 9380 hash_to_field with
expand_message_xmd(BLAKE2b-512) followed by simplified SWU over a
3-isogenous curve (used at `poly/ipa/commitment.rs:160-201` with prefix
"Halo2-Parameters", and by the Sinsemilla gadget with the "z.cash:*"
prefixes).

For Pallas this module is **byte-exact** with pasta_curves: the iso-curve
and isogeny constants below were re-derived from first principles (Vélu's
formulas over the 3-torsion of Pallas; see `tools/derive_sswu_params.py`)
and validated against the 1024 `SINSEMILLA_S` vectors of
`halo2_gadgets/src/sinsemilla/primitives/sinsemilla_s.rs` (sampled fixture
in tests/fixtures_sinsemilla_s.json).

Derivation notes (tools/derive_sswu_params.py reproduces all of this):
  * Pallas y^2 = x^3 + 5 has 3-division polynomial 3x(x^3 + 20); its three
    Fp-rational kernel x-coordinates all yield Vélu image curves
    y^2 = x^3 + a_img x + 1265 (b_img = -70*(-20) - 135 = 1265). The one
    matching pasta_curves' IsoEp is A_ISO below.
  * The dual direction (iso -> Pallas) is Vélu with the iso-curve's unique
    Fp-rational 3-torsion x-coordinate X0, whose image is y^2 = x^3 + 3645,
    composed with the sextic-twist scaling by W (W^6 = 5/3645); the W
    branch is fixed by the SINSEMILLA_S vectors.
  * SSWU parameter Z = -13; sign convention: sgn0(y) matches sgn0(u)
    (parity of the canonical representative).

Vesta's iso constants have the same structure (three conjugate candidates
with b = 1265) but no in-repo oracle pins which conjugate/scaling
pasta_curves chose; Vesta therefore still uses the interim
try-and-increment map below until the golden-VK harness (docs/PARITY.md)
disambiguates. All Vesta-derived parameters are self-consistent within
this framework.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Optional, Tuple, Type

from .curves import Curve, Point
from .fields import Fp, Fq


def _expand_message_xmd_blake2b(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 expand_message_xmd with BLAKE2b-512 (block size 128)."""
    b_in_bytes = 64
    r_in_bytes = 128
    ell = -(-len_in_bytes // b_in_bytes)
    assert ell <= 255 and len(dst) <= 255
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(r_in_bytes)
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.blake2b(z_pad + msg + l_i_b_str + b"\x00" + dst_prime, digest_size=64).digest()
    bs = []
    prev = hashlib.blake2b(b0 + b"\x01" + dst_prime, digest_size=64).digest()
    bs.append(prev)
    for i in range(2, ell + 1):
        xored = bytes(a ^ b for a, b in zip(b0, prev))
        prev = hashlib.blake2b(xored + bytes([i]) + dst_prime, digest_size=64).digest()
        bs.append(prev)
    return b"".join(bs)[:len_in_bytes]


def hash_to_field(curve: Type[Curve], domain_prefix: str, message: bytes):
    """Two base-field elements from the message (RFC 9380 hash_to_field with
    expand_message_xmd(BLAKE2b), DST = prefix||"-"||curve_id||suffix).

    Each 64-byte chunk is reduced as a BIG-endian integer (RFC 9380 OS2IP),
    matching pasta_curves."""
    dst = (domain_prefix + "-" + curve.CURVE_ID + "_XMD:BLAKE2b_SSWU_RO_").encode()
    uniform = _expand_message_xmd_blake2b(message, dst, 128)
    F = curve.BASE
    u0 = F(int.from_bytes(uniform[:64], "big") % F.MODULUS)
    u1 = F(int.from_bytes(uniform[64:], "big") % F.MODULUS)
    return u0, u1


class IsoParams:
    """Constants of the 3-isogenous SSWU curve y^2 = x^3 + A x + B and the
    (Vélu-parameterized) isogeny back to the target curve."""

    def __init__(self, field, a_iso: int, b_iso: int, z: int, x0: int, w: int):
        p = field.MODULUS
        self.field = field
        self.p = p
        self.a = a_iso
        self.b = b_iso
        self.z = z % p
        self.x0 = x0
        # Vélu data for the kernel at x0 on the iso curve
        self.t = (6 * x0 * x0 + 2 * a_iso) % p
        self.u = 4 * (pow(x0, 3, p) + a_iso * x0 + b_iso) % p
        self.w2 = w * w % p
        self.w3 = pow(w, 3, p)


# pasta_curves IsoEp, re-derived (see module docstring); validated against
# the reference SINSEMILLA_S table.
_PALLAS_ISO = IsoParams(
    field=Fp,
    a_iso=0x36BD18A330B54795D39B53E049FF8F65EB078C8E49E6BD5B4B27CC9E316FE8A1,
    b_iso=1265,
    z=-13,
    x0=0x088EB06B31B9628FF8E29A3C5C9D30AE981CD22A4C090210CAA1223F09373022,
    w=0x39BBBC7EE710C1DA4671B8B68D71C4C56DE6BFB5F6BDE8ADE49E1158560091C3,
)

# pasta_curves IsoEq: same canonical construction over Vesta; the composite
# map is conjugate-independent (all three (a_iso, x0, w) factorizations
# agree), validated against the reference plonk_api.rs pinned VK whose
# fixed_commitments[0] is exactly [1]W = hash("Halo2-Parameters")([1]) on
# Vesta (the `sf` fixed column is never assigned, so its commitment is the
# default-blind W point).
_VESTA_ISO = IsoParams(
    field=Fq,
    a_iso=0x267F9B2EE592271A81639C4D96F787739673928C7D01B212C515AD7242EAA6B1,
    b_iso=1265,
    z=-13,
    x0=0x1AE90DBD54BF6D1575D5C33AD251D4A6BF4C98BD6FEF5204EA8F4DD1286F2E8C,
    w=0x2AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAC18465FD5BB87093B2D9F21600000001,
)

_ISO_BY_CURVE_ID = {"pallas": _PALLAS_ISO, "vesta": _VESTA_ISO}


def _sswu_iso(iso: IsoParams, u: int) -> Tuple[int, int]:
    """Simplified SWU onto the iso curve (RFC 9380 §6.6.2), sign of y
    matched to sgn0(u) = u mod 2."""
    p = iso.p
    A, B, Z = iso.a, iso.b, iso.z
    tv1 = Z * u % p * u % p
    ta = (tv1 * tv1 + tv1) % p
    if ta == 0:
        x1 = B * pow(Z * A % p, -1, p) % p
    else:
        x1 = (p - B) * pow(A, -1, p) % p * (1 + pow(ta, -1, p)) % p
    gx1 = (pow(x1, 3, p) + A * x1 + B) % p

    s = iso.field(gx1).sqrt()
    if s is not None:
        x, y = x1, s.v
    else:
        x2 = tv1 * x1 % p
        gx2 = (pow(x2, 3, p) + A * x2 + B) % p
        s2 = iso.field(gx2).sqrt()
        assert s2 is not None
        x, y = x2, s2.v
    if (u & 1) != (y & 1):
        y = p - y
    return x, y


def _iso_map(curve: Type[Curve], iso: IsoParams, x: int, y: int) -> Point:
    """The normalized Vélu 3-isogeny iso-curve -> curve, composed with the
    twist scaling (X, Y) -> (W^2 X, W^3 Y)."""
    p = iso.p
    d = (x - iso.x0) % p
    assert d != 0, "hash landed on the isogeny kernel"
    dinv = pow(d, -1, p)
    X = (x + iso.t * dinv + iso.u * dinv * dinv % p) % p
    Y = y * (1 - iso.t * dinv * dinv - 2 * iso.u * pow(dinv, 3, p)) % p
    return Point(curve, (iso.w2 * X % p, iso.w3 * Y % p))


def _map_to_curve_interim(curve: Type[Curve], u) -> Point:
    """Interim deterministic field->curve map (try-and-increment from u).

    Used only for curves without derived iso constants (currently Vesta);
    NOT byte-compatible with pasta_curves (docs/PARITY.md)."""
    p = curve.p()
    x = u.v
    while True:
        rhs = curve.BASE((x * x % p * x + curve.B) % p)
        y = rhs.sqrt()
        if y is not None:
            # canonical root choice: even y
            yv = y.v if y.v % 2 == 0 else p - y.v
            return Point(curve, (x, yv))
        x = (x + 1) % p


def hash_to_curve(curve: Type[Curve], domain_prefix: str) -> Callable[[bytes], Point]:
    """Returns a message -> point hasher (mirrors CurveExt::hash_to_curve)."""
    iso = _ISO_BY_CURVE_ID.get(curve.CURVE_ID)

    def hasher(message: bytes) -> Point:
        u0, u1 = hash_to_field(curve, domain_prefix, message)
        if iso is not None:
            q0 = _iso_map(curve, iso, *_sswu_iso(iso, u0.v))
            q1 = _iso_map(curve, iso, *_sswu_iso(iso, u1.v))
        else:
            q0 = _map_to_curve_interim(curve, u0)
            q1 = _map_to_curve_interim(curve, u1)
        return q0 + q1

    return hasher
