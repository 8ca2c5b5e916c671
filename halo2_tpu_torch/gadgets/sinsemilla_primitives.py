"""Sinsemilla host primitives
(reference `halo2_gadgets/src/sinsemilla/primitives{,.rs}`).

SinsemillaHashToPoint (Zcash spec 5.4.1.9): pad the message to a multiple
of K=10 bits, then fold acc <- (acc + S[chunk]) + acc with *incomplete*
addition starting from the domain point Q; S[j] =
GroupHash("z.cash:SinsemillaS", LE32(j)) for j in [0, 2^K). CommitDomain
adds a blinding term r*R with complete addition.

Generator derivation goes through the port's `hash_to_curve`; byte-parity of
those generators with pasta_curves' iso-Pallas SSWU is tracked in
docs/PARITY.md (the 14,344-line SINSEMILLA_S table in the reference is the
oracle once SSWU lands).

A copy of `halo2_tpu/gadgets/sinsemilla_primitives.py` on the port's curves.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Iterable, List, Optional, Tuple

from ..curves import Pallas, Point
from ..hash_to_curve import hash_to_curve

K = 10
C = 253  # max words: the largest c with 2^c <= (r_P - 1)/2

Q_PERSONALIZATION = "z.cash:SinsemillaQ"
S_PERSONALIZATION = "z.cash:SinsemillaS"


def lebs2ip_k(bits: List[bool]) -> int:
    assert len(bits) == K
    return sum(1 << i for i, b in enumerate(bits) if b)


def pad(msg: Iterable[bool]) -> List[bool]:
    """Pad with zero bits to a multiple of K (primitives.rs Pad)."""
    bits = list(msg)
    assert len(bits) <= K * C
    rem = len(bits) % K
    if rem:
        bits.extend([False] * (K - rem))
    return bits


@lru_cache(maxsize=1)
def sinsemilla_s() -> List[Point]:
    """The 2^K S generators (reference sinsemilla_s.rs SINSEMILLA_S)."""
    hasher = hash_to_curve(Pallas, S_PERSONALIZATION)
    return [hasher(j.to_bytes(4, "little")) for j in range(1 << K)]


class IncompletePoint:
    """Incomplete-addition accumulator: None = failure (primitives/addition.rs).

    Addition fails on identity operands or equal x-coordinates (doubling or
    inverse), exactly the in-circuit incomplete addition's domain."""

    __slots__ = ("pt",)

    def __init__(self, pt: Optional[Point]):
        self.pt = pt

    def add(self, other: Point) -> "IncompletePoint":
        if self.pt is None:
            return self
        if self.pt.is_identity() or other.is_identity():
            return IncompletePoint(None)
        if self.pt.xy[0] == other.xy[0]:
            return IncompletePoint(None)  # doubling or inverse: incomplete
        return IncompletePoint(self.pt + other)


class HashDomain:
    def __init__(self, domain: str, _q: Point = None):
        self.Q = _q if _q is not None else hash_to_curve(Pallas, Q_PERSONALIZATION)(
            domain.encode()
        )

    def hash_to_point(self, msg: Iterable[bool]) -> Optional[Point]:
        padded = pad(msg)
        S = sinsemilla_s()
        acc = IncompletePoint(self.Q)
        for start in range(0, len(padded), K):
            chunk = padded[start : start + K]
            s = S[lebs2ip_k(chunk)]
            if acc.pt is None:
                return None
            prev = acc.pt
            acc = acc.add(s).add(prev)  # (acc + S_chunk) + acc
        return acc.pt

    def hash(self, msg: Iterable[bool]) -> Optional[int]:
        """Extract_P (x-coordinate; identity -> 0) of the hash point."""
        pt = self.hash_to_point(msg)
        if pt is None:
            return None
        return 0 if pt.is_identity() else pt.xy[0]


class CommitDomain:
    def __init__(self, domain: str):
        self.M = HashDomain(f"{domain}-M")
        self.R = hash_to_curve(Pallas, f"{domain}-r")(b"")

    def commit(self, msg: Iterable[bool], r: int) -> Optional[Point]:
        pt = self.M.hash_to_point(msg)
        if pt is None:
            return None
        return pt + self.R.mul(r)

    def short_commit(self, msg: Iterable[bool], r: int) -> Optional[int]:
        pt = self.commit(msg, r)
        if pt is None:
            return None
        return 0 if pt.is_identity() else pt.xy[0]
