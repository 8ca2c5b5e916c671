"""Polynomial layer: field vectors on a device and basis-typed polynomials.

Counterpart of `halo2_tpu/poly/__init__.py` (reference `poly.rs:51-325`):
values live as (n, 16) int32 Montgomery limb tensors (`FVec`) on the device
the caller chose, and bulk arithmetic goes through `ops.field`. Host
bigints appear only at scalar boundaries (transcript evals, challenges).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Type

import torch

from ..fields import FieldElement
from ..ops import field as fo
from ..ops.field import NLIMBS

# Basis tags (reference poly.rs:51-63)
COEFF = "coeff"
LAGRANGE = "lagrange"
EXTENDED = "extended"


@dataclass(frozen=True)
class Rotation:
    """Query rotation relative to the current row (reference poly.rs:304-325)."""

    i: int = 0

    @staticmethod
    def cur() -> "Rotation":
        return Rotation(0)

    @staticmethod
    def prev() -> "Rotation":
        return Rotation(-1)

    @staticmethod
    def next() -> "Rotation":
        return Rotation(1)


class FVec:
    """A vector of field elements as (n, 16) Montgomery limbs on a device."""

    __slots__ = ("field", "vals")

    def __init__(self, field: Type[FieldElement], vals: torch.Tensor):
        self.field = field
        self.vals = vals

    # ---- constructors ----
    @classmethod
    def from_ints(cls, field: Type[FieldElement], ints: Sequence[int], device) -> "FVec":
        return cls(field, fo.FieldCtx(field).consts(ints, device))

    @classmethod
    def zeros(cls, field: Type[FieldElement], n: int, device) -> "FVec":
        return cls(field, torch.zeros((n, NLIMBS), dtype=torch.int32, device=device))

    @classmethod
    def fill(cls, field: Type[FieldElement], n: int, value: int, device) -> "FVec":
        c = fo.FieldCtx(field).const(value, device)
        return cls(field, c.expand(n, NLIMBS))

    # ---- host boundary ----
    @property
    def ctx(self) -> fo.FieldCtx:
        return fo.FieldCtx(self.field)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def to_ints(self) -> List[int]:
        return self.ctx.decode_ints(self.vals)

    def to_elems(self) -> List[FieldElement]:
        return [self.field(v) for v in self.to_ints()]

    # ---- structure ----
    def __len__(self) -> int:
        return self.vals.shape[0]

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return FVec(self.field, self.vals[idx])
        return self.field(self.ctx.decode_ints(self.vals[idx : idx + 1])[0])

    def slice(self, start: int, stop: int) -> "FVec":
        return FVec(self.field, self.vals[start:stop])

    def rotate(self, r: int) -> "FVec":
        """Positive r rotates left (reference Polynomial::rotate semantics)."""
        return FVec(self.field, torch.roll(self.vals, -r, dims=0))

    def concat(self, other: "FVec") -> "FVec":
        return FVec(self.field, torch.cat([self.vals, other.vals], dim=0))

    def pad_to(self, n: int) -> "FVec":
        cur = len(self)
        if cur == n:
            return self
        return FVec(self.field, torch.nn.functional.pad(self.vals, (0, 0, 0, n - cur)))

    def copy(self) -> "FVec":
        return FVec(self.field, self.vals)

    # ---- arithmetic ----
    def _coerce(self, other) -> torch.Tensor:
        if isinstance(other, FVec):
            return other.vals
        if isinstance(other, FieldElement):
            return self.ctx.const(other.v, self.device)
        if isinstance(other, int):
            return self.ctx.const(other, self.device)
        raise TypeError(f"cannot combine FVec with {type(other)}")

    def __add__(self, other) -> "FVec":
        return FVec(self.field, fo.add_mod(self.vals, self._coerce(other), self.ctx))

    def __sub__(self, other) -> "FVec":
        return FVec(self.field, fo.sub_mod(self.vals, self._coerce(other), self.ctx))

    def __mul__(self, other) -> "FVec":
        return FVec(self.field, fo.mont_mul(self.vals, self._coerce(other), self.ctx))

    def __neg__(self) -> "FVec":
        return FVec(self.field, fo.neg_mod(self.vals, self.ctx))

    def invert(self) -> "FVec":
        """Batch inversion (zeros pass through)."""
        from ..ops.scan import batch_invert

        return FVec(self.field, batch_invert(self.vals, self.ctx))

    def set_int(self, idx: int, v: int) -> "FVec":
        vals = self.vals.clone()
        vals[idx] = self.ctx.const(v, self.device)
        return FVec(self.field, vals)


class Polynomial:
    """Basis-tagged polynomial over an FVec (reference poly.rs:68)."""

    __slots__ = ("basis", "vec")

    def __init__(self, basis: str, vec: FVec):
        self.basis = basis
        self.vec = vec

    @property
    def field(self):
        return self.vec.field

    def __len__(self):
        return len(self.vec)

    def __add__(self, other: "Polynomial") -> "Polynomial":
        assert self.basis == other.basis
        return Polynomial(self.basis, self.vec + other.vec)

    def __sub__(self, other: "Polynomial") -> "Polynomial":
        assert self.basis == other.basis
        return Polynomial(self.basis, self.vec - other.vec)

    def scale(self, c) -> "Polynomial":
        return Polynomial(self.basis, self.vec * c)

    def rotate(self, r: Rotation) -> "Polynomial":
        assert self.basis == LAGRANGE
        return Polynomial(self.basis, self.vec.rotate(r.i))

    def copy(self) -> "Polynomial":
        return Polynomial(self.basis, self.vec.copy())


def eval_polynomial_host(coeffs: Sequence[int], x: int, p: int) -> int:
    """Horner evaluation over host bigints (reference arithmetic.rs:243)."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def eval_polynomial(poly: Polynomial, x: FieldElement) -> FieldElement:
    """Evaluate a coeff-basis polynomial at a host scalar."""
    assert poly.basis == COEFF
    p = poly.field.MODULUS
    return poly.field(eval_polynomial_host(poly.vec.to_ints(), x.v, p))


def lagrange_interpolate_host(points, evals, field: Type[FieldElement]):
    """Lagrange interpolation over host bigints
    (reference arithmetic.rs:345-398); returns coefficient list."""
    p = field.MODULUS
    n = len(points)
    assert n == len(evals)
    if n == 1:
        return [evals[0] % p]
    coeffs = [0] * n
    for i, (xi, yi) in enumerate(zip(points, evals)):
        denom = 1
        num = [1]
        for j, xj in enumerate(points):
            if j == i:
                continue
            denom = denom * (xi - xj) % p
            new = [0] * (len(num) + 1)
            for d, c in enumerate(num):
                new[d] = (new[d] - c * xj) % p
                new[d + 1] = (new[d + 1] + c) % p
            num = new
        scale = yi * pow(denom, -1, p) % p
        for d, c in enumerate(num):
            coeffs[d] = (coeffs[d] + c * scale) % p
    return coeffs
