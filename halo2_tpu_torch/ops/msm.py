"""Multi-scalar multiplication: host Pippenger (spec) + the bucket MSM.

Counterpart of `halo2_tpu/ops/msm.py`. `msm_host` is the reference's
`best_multiexp` bucket method over Python bigints (`arithmetic.rs:41-198`),
used for small MSMs and as the oracle. `msm` sends MSMs of 2^12 points and
more to the bucket pipeline (`ops/msm_bucket.py`) on the bases' device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Type

import torch

from ..curves import JAC_IDENTITY, Curve, Point, jac_add, jac_add_affine, jac_double
from .curve import CurveCtx
from .field import ints_to_limbs

DEVICE_MSM_MIN = 1 << 12


def msm_host(scalars: Sequence[int], points: Sequence[Point], curve: Type[Curve]) -> Point:
    """Bucket-method MSM over host bigints (reference arithmetic.rs:160-198)."""
    assert len(scalars) == len(points)
    n = len(scalars)
    if n == 0:
        return curve.identity()
    p = curve.p()
    bits = curve.SCALAR.MODULUS.bit_length()
    c = 3 if n < 32 else max(1, (n.bit_length() - 1) // 2 + 1)
    c = min(c, 15)
    nwin = (bits + c - 1) // c
    acc = JAC_IDENTITY
    for w in range(nwin - 1, -1, -1):
        for _ in range(c):
            acc = jac_double(acc, p)
        buckets = [JAC_IDENTITY] * ((1 << c) - 1)
        shift = w * c
        mask = (1 << c) - 1
        for s, pt in zip(scalars, points):
            if pt.is_identity():
                continue
            d = (s >> shift) & mask
            if d != 0:
                buckets[d - 1] = jac_add_affine(buckets[d - 1], pt.xy[0], pt.xy[1], p)
        run = JAC_IDENTITY
        total = JAC_IDENTITY
        for b in reversed(buckets):
            run = jac_add(run, b, p)
            total = jac_add(total, run, p)
        acc = jac_add(acc, total, p)
    return curve.from_jacobian(acc)


class MSMBases:
    """Affine MSM bases kept on one device, reusable across many MSMs like
    the reference's ParamsIPA.g arrays."""

    def __init__(self, curve: Type[Curve], points: Sequence[Point], device):
        self.curve = curve
        self.cc = CurveCtx(curve)
        self.n = len(points)
        self.host_points = list(points)
        self.device = torch.device(device)
        self._tables: dict = {}

    def device_tables(self, n_pad: int, device=None):
        """Transposed (16, n_pad) coordinate tables, cached per padded size."""
        device = torch.device(device) if device is not None else self.device
        key = (n_pad, device)
        if key not in self._tables:
            from .msm_bucket import DeviceBases

            self._tables[key] = DeviceBases(self.curve, self.host_points, n_pad, device)
        return self._tables[key]


def msm(scalars: Sequence[int], bases, curve: Optional[Type[Curve]] = None,
        device=None) -> Point:
    """Dispatching MSM: host Pippenger below 2^12 points, else the bucket
    MSM on `bases.device`, or on `device` for a list of host points, which
    then must be given.

    Terms whose base is the identity add nothing and are dropped before the
    bucket MSM, whose bases must be affine."""
    from ..utils.measure import span
    from .msm_bucket import msm_bucket_many

    if isinstance(bases, MSMBases):
        curve = bases.curve
        host_points = bases.host_points
        device = bases.device
    else:
        host_points = list(bases)
        assert curve is not None or host_points, "need curve"
        curve = curve or host_points[0].curve
        if device is None:
            raise ValueError("msm: a list of points needs a device")
    n = len(scalars)
    with span(f"msm n={n}"):
        if n < DEVICE_MSM_MIN:
            return msm_host(scalars, host_points[:n], curve)
        if not isinstance(bases, MSMBases):
            keep = [i for i, pt in enumerate(host_points[:n]) if not pt.is_identity()]
            if len(keep) < n:
                scalars = [scalars[i] for i in keep]
                host_points = [host_points[i] for i in keep]
            bases = MSMBases(curve, host_points, device)
        q = curve.SCALAR.MODULUS
        canon = torch.as_tensor(ints_to_limbs([int(s) % q for s in scalars]), device=device)
        return msm_bucket_many(canon[None], bases, mont=False)[0]
