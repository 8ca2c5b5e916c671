"""Deferred-division witness values.

Mirrors `Assigned<F>` (reference `halo2_proofs/src/plonk/assigned.rs`):
witness values are carried as rationals (numerator, denominator) so that
all inversions in a column can be batched into a single field inversion at
commit time (`batch_invert_assigned`, reference poly.rs:179-224).

A zero denominator evaluates to zero (matching the reference's convention
that inverting zero yields zero)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Type

from ..fields import FieldElement


@dataclass(frozen=True)
class Assigned:
    """num/den over a prime field given by `p` at evaluation time."""

    num: int
    den: int = 1

    @staticmethod
    def zero() -> "Assigned":
        return Assigned(0, 1)

    @staticmethod
    def trivial(v: int) -> "Assigned":
        return Assigned(v, 1)

    def is_zero_vartime(self) -> bool:
        return self.num == 0

    def __add__(self, other: "Assigned") -> "Assigned":
        other = _coerce(other)
        if self.den == other.den == 1:
            return Assigned(self.num + other.num, 1)
        return Assigned(self.num * other.den + other.num * self.den, self.den * other.den)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other: "Assigned") -> "Assigned":
        return self + (-_coerce(other))

    def __rsub__(self, other):
        return _coerce(other) + (-self)

    def __mul__(self, other: "Assigned") -> "Assigned":
        other = _coerce(other)
        return Assigned(self.num * other.num, self.den * other.den)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __neg__(self) -> "Assigned":
        return Assigned(-self.num, self.den)

    def square(self) -> "Assigned":
        return Assigned(self.num * self.num, self.den * self.den)

    def cube(self) -> "Assigned":
        return Assigned(self.num**3, self.den**3)

    def invert(self) -> "Assigned":
        """Deferred inversion: swap numerator and denominator."""
        return Assigned(self.den, self.num)

    def evaluate(self, p: int) -> int:
        """Resolve to a canonical field int (inverse of 0 is 0)."""
        num = self.num % p
        den = self.den % p
        if den == 1:
            return num
        if den == 0:
            return 0
        return num * pow(den, -1, p) % p


def _coerce(v) -> Assigned:
    if isinstance(v, Assigned):
        return v
    if isinstance(v, FieldElement):
        return Assigned(v.v, 1)
    if isinstance(v, int):
        return Assigned(v, 1)
    raise TypeError(f"cannot treat {type(v)} as Assigned")


def batch_invert_assigned(p: int, columns: Sequence[Sequence[Assigned]]):
    """Resolve whole columns of Assigned to canonical ints with one batched
    inversion pass per column (reference poly.rs:179-206 semantics)."""
    out = []
    for col in columns:
        dens = [a.den % p for a in col]
        # Montgomery trick over nonzero denominators
        prefix = []
        acc = 1
        for d in dens:
            prefix.append(acc)
            if d not in (0, 1):
                acc = acc * d % p
        inv = pow(acc, -1, p)
        invs = [0] * len(dens)
        for i in range(len(dens) - 1, -1, -1):
            d = dens[i]
            if d == 1:
                invs[i] = 1
            elif d == 0:
                invs[i] = 0
            else:
                invs[i] = inv * prefix[i] % p
                inv = inv * d % p
        out.append([a.num % p * invs[i] % p for i, a in enumerate(col)])
    return out
