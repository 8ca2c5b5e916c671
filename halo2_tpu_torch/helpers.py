"""Serialization formats and helpers (reference `halo2_proofs/src/helpers.rs`).

`SerdeFormat` (helpers.rs:8-20):
  * PROCESSED - compressed-canonical curve points, canonical field bytes
    (checked on read);
  * RAW_BYTES - uncompressed points / field elements in Montgomery form,
    validated on read;
  * RAW_BYTES_UNCHECKED - same layout, no validation (fast path for trusted
    key files, used by examples/serialization.rs).

Plus selector bit-packing (helpers.rs:99-113) and polynomial-vector IO
(helpers.rs:116-146) used by VerifyingKey/ProvingKey read/write
(plonk.rs:170-263, 418-490).
"""

from __future__ import annotations

import io
from typing import List, Sequence, Type

from .curves import Curve, Point
from .fields import FieldElement

PROCESSED = "processed"
RAW_BYTES = "raw_bytes"
RAW_BYTES_UNCHECKED = "raw_bytes_unchecked"


# ---------------------------------------------------------------------------
# field elements
# ---------------------------------------------------------------------------


def write_field(w: io.BytesIO, field: Type[FieldElement], v: int, fmt: str):
    p = field.MODULUS
    if fmt == PROCESSED:
        w.write((v % p).to_bytes(32, "little"))
    else:
        # Montgomery representation (v * 2^256 mod p), like halo2curves' repr
        r = (1 << 256) % p
        w.write(((v % p) * r % p).to_bytes(32, "little"))


def read_field(r: io.BytesIO, field: Type[FieldElement], fmt: str) -> int:
    b = r.read(32)
    assert len(b) == 32, "unexpected EOF"
    v = int.from_bytes(b, "little")
    p = field.MODULUS
    if fmt == PROCESSED:
        if v >= p:
            raise ValueError("non-canonical field element")
        return v
    if fmt == RAW_BYTES and v >= p:
        raise ValueError("non-canonical Montgomery representation")
    rinv = pow((1 << 256) % p, -1, p)
    return v * rinv % p


# ---------------------------------------------------------------------------
# curve points
# ---------------------------------------------------------------------------


def write_point(w: io.BytesIO, pt: Point, fmt: str):
    if fmt == PROCESSED:
        w.write(pt.to_bytes())
        return
    curve = pt.curve
    p = curve.p()
    r = (1 << 256) % p
    if pt.is_identity():
        w.write(bytes(64))
    else:
        w.write((pt.xy[0] * r % p).to_bytes(32, "little"))
        w.write((pt.xy[1] * r % p).to_bytes(32, "little"))


def read_point(r: io.BytesIO, curve: Type[Curve], fmt: str) -> Point:
    if fmt == PROCESSED:
        b = r.read(32)
        assert len(b) == 32, "unexpected EOF"
        return curve.from_bytes(b)
    b = r.read(64)
    assert len(b) == 64, "unexpected EOF"
    p = curve.p()
    rinv = pow((1 << 256) % p, -1, p)
    x = int.from_bytes(b[:32], "little")
    y = int.from_bytes(b[32:], "little")
    if fmt == RAW_BYTES and (x >= p or y >= p):
        raise ValueError("non-canonical Montgomery coordinate")
    x = x * rinv % p
    y = y * rinv % p
    if x == 0 and y == 0:
        return curve.identity()
    if fmt == RAW_BYTES:
        return curve.from_xy(x, y)  # validates on-curve
    return Point(curve, (x, y))


# ---------------------------------------------------------------------------
# selectors (helpers.rs:99-113)
# ---------------------------------------------------------------------------


def pack_selector(bits: Sequence[bool]) -> bytes:
    out = bytearray((len(bits) + 7) // 8)
    for i, bit in enumerate(bits):
        if bit:
            out[i // 8] |= 1 << (i % 8)
    return bytes(out)


def unpack_selector(data: bytes, n: int) -> List[bool]:
    return [(data[i // 8] >> (i % 8)) & 1 == 1 for i in range(n)]


# ---------------------------------------------------------------------------
# polynomials (helpers.rs:116-146)
# ---------------------------------------------------------------------------


def write_poly_ints(w: io.BytesIO, field: Type[FieldElement], vals: Sequence[int], fmt: str):
    w.write(len(vals).to_bytes(4, "big"))
    for v in vals:
        write_field(w, field, v, fmt)


def read_poly_ints(r: io.BytesIO, field: Type[FieldElement], fmt: str) -> List[int]:
    n = int.from_bytes(r.read(4), "big")
    return [read_field(r, field, fmt) for _ in range(n)]


def write_poly_vec(w: io.BytesIO, field: Type[FieldElement], polys, fmt: str):
    w.write(len(polys).to_bytes(4, "big"))
    for poly in polys:
        write_poly_ints(w, field, _ints_of(poly), fmt)


def read_poly_vec(r: io.BytesIO, field: Type[FieldElement], fmt: str) -> List[List[int]]:
    n = int.from_bytes(r.read(4), "big")
    return [read_poly_ints(r, field, fmt) for _ in range(n)]


def _ints_of(poly) -> List[int]:
    if isinstance(poly, list):
        return poly
    return poly.vec.to_ints()
