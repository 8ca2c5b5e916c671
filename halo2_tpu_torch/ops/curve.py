"""Batched elliptic-curve arithmetic over limb tensors.

Counterpart of `halo2_tpu/ops/curve_jax.py`. Points are homogeneous
projective (X : Y : Z) triples of (..., 16) Montgomery limb tensors, added
with the complete formulas of Renes-Costello-Batina 2015 for a = 0
(algorithm 7 full, 8 mixed), so the identity (0 : 1 : 0), doubling and
inverses need no branches. These are the plain torch versions
the bucket MSM's kernels are held against (`ops/msm_bucket.py`).

`decode_points` reads the projective coordinates back once and takes the
affine coordinates with host inversions (Python `pow`): the device never
runs a Fermat ladder for a decode.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple, Type

import torch

from ..curves import Curve, Point
from .field import NLIMBS, FieldCtx, add_mod, from_mont, ints_to_limbs, limbs_to_ints, mont_mul, sub_mod


class PointVec(NamedTuple):
    """A batch of projective points: X, Y, Z limb tensors (..., 16)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class CurveCtx:
    """Per-curve constants for batched point arithmetic."""

    _cache: dict = {}

    def __new__(cls, curve: Type[Curve]):
        if curve in cls._cache:
            return cls._cache[curve]
        self = super().__new__(cls)
        cls._cache[curve] = self
        self.curve = curve
        self.fctx = FieldCtx(curve.BASE)
        self.b3_int = 3 * curve.B % self.fctx.p_int
        self.b3_mont = self.b3_int * self.fctx.r_int % self.fctx.p_int
        return self

    def b3(self, device) -> torch.Tensor:
        return self.fctx.const(self.b3_int, device)

    # ---- host <-> device ----
    def encode_points(self, points: Sequence[Point], device) -> PointVec:
        """Affine host points -> projective device batch (identity ok)."""
        p, r = self.curve.p(), self.fctx.r_int
        xs, ys, zs = [], [], []
        for pt in points:
            if pt.is_identity():
                xs.append(0)
                ys.append(r % p)
                zs.append(0)
            else:
                xs.append(pt.xy[0] * r % p)
                ys.append(pt.xy[1] * r % p)
                zs.append(r % p)
        return PointVec(*(torch.as_tensor(ints_to_limbs(v), device=device) for v in (xs, ys, zs)))

    def decode_points(self, pv: PointVec) -> List[Point]:
        """Projective device batch -> affine host points (one readback)."""
        packed = torch.stack(
            [from_mont(c.reshape(-1, NLIMBS), self.fctx) for c in pv], dim=0
        ).cpu()
        xs, ys, zs = (limbs_to_ints(packed[i]) for i in range(3))
        p = self.curve.p()
        out = []
        for X, Y, Z in zip(xs, ys, zs):
            if Z == 0:
                out.append(Point(self.curve, None))
            else:
                zinv = pow(Z, -1, p)
                out.append(Point(self.curve, (X * zinv % p, Y * zinv % p)))
        return out

    def identity_vec(self, shape: Tuple[int, ...], device) -> PointVec:
        zeros = torch.zeros(shape + (NLIMBS,), dtype=torch.int32, device=device)
        one = self.fctx.one(device).expand(shape + (NLIMBS,))
        return PointVec(zeros, one.clone(), zeros.clone())


def padd(a: PointVec, b: PointVec, cc: CurveCtx) -> PointVec:
    """Complete projective addition, RCB15 algorithm 7 (a = 0)."""
    ctx = cc.fctx
    b3 = cc.b3(a.x.device)
    X1, Y1, Z1 = a
    X2, Y2, Z2 = b
    t0 = mont_mul(X1, X2, ctx)
    t1 = mont_mul(Y1, Y2, ctx)
    t2 = mont_mul(Z1, Z2, ctx)
    t3 = add_mod(X1, Y1, ctx)
    t4 = add_mod(X2, Y2, ctx)
    t3 = mont_mul(t3, t4, ctx)
    t4 = add_mod(t0, t1, ctx)
    t3 = sub_mod(t3, t4, ctx)
    t4 = add_mod(Y1, Z1, ctx)
    X3 = add_mod(Y2, Z2, ctx)
    t4 = mont_mul(t4, X3, ctx)
    X3 = add_mod(t1, t2, ctx)
    t4 = sub_mod(t4, X3, ctx)
    X3 = add_mod(X1, Z1, ctx)
    Y3 = add_mod(X2, Z2, ctx)
    X3 = mont_mul(X3, Y3, ctx)
    Y3 = add_mod(t0, t2, ctx)
    Y3 = sub_mod(X3, Y3, ctx)
    X3 = add_mod(t0, t0, ctx)
    t0 = add_mod(X3, t0, ctx)
    t2 = mont_mul(b3, t2, ctx)
    Z3 = add_mod(t1, t2, ctx)
    t1 = sub_mod(t1, t2, ctx)
    Y3 = mont_mul(b3, Y3, ctx)
    X3 = mont_mul(t4, Y3, ctx)
    t2 = mont_mul(t3, t1, ctx)
    X3 = sub_mod(t2, X3, ctx)
    Y3 = mont_mul(Y3, t0, ctx)
    t1 = mont_mul(t1, Z3, ctx)
    Y3 = add_mod(t1, Y3, ctx)
    t0 = mont_mul(t0, t3, ctx)
    Z3 = mont_mul(Z3, t4, ctx)
    Z3 = add_mod(Z3, t0, ctx)
    return PointVec(X3, Y3, Z3)


def padd_mixed(a: PointVec, X2: torch.Tensor, Y2: torch.Tensor, cc: CurveCtx) -> PointVec:
    """Complete mixed addition (RCB15 algorithm 8, a = 0, Z2 = 1): projective
    `a` plus affine (X2, Y2); the operation order of msm_pallas._mixed_padd."""
    ctx = cc.fctx
    b3 = cc.b3(a.x.device)
    X1, Y1, Z1 = a
    t0 = mont_mul(X1, X2, ctx)
    t1 = mont_mul(Y1, Y2, ctx)
    t3 = add_mod(X2, Y2, ctx)
    t4 = add_mod(X1, Y1, ctx)
    t3 = mont_mul(t3, t4, ctx)
    t4 = add_mod(t0, t1, ctx)
    t3 = sub_mod(t3, t4, ctx)
    t4 = mont_mul(Y2, Z1, ctx)
    t4 = add_mod(t4, Y1, ctx)
    Y3 = mont_mul(X2, Z1, ctx)
    Y3 = add_mod(Y3, X1, ctx)
    X3 = add_mod(t0, t0, ctx)
    t0 = add_mod(X3, t0, ctx)
    t2 = mont_mul(b3, Z1, ctx)
    Z3 = add_mod(t1, t2, ctx)
    t1 = sub_mod(t1, t2, ctx)
    Y3 = mont_mul(b3, Y3, ctx)
    X3 = mont_mul(t4, Y3, ctx)
    t2 = mont_mul(t3, t1, ctx)
    X3 = sub_mod(t2, X3, ctx)
    Y3 = mont_mul(Y3, t0, ctx)
    t1 = mont_mul(t1, Z3, ctx)
    Y3 = add_mod(t1, Y3, ctx)
    t0 = mont_mul(t0, t3, ctx)
    Z3 = mont_mul(Z3, t4, ctx)
    Z3 = add_mod(Z3, t0, ctx)
    return PointVec(X3, Y3, Z3)
