"""Multi-scalar multiplication: host Pippenger (spec), the bucket MSM and
the sorted-bucket MSM.

Counterpart of `halo2_tpu/ops/msm.py`. `msm_host` is the reference's
`best_multiexp` bucket method over Python bigints (`arithmetic.rs:41-198`),
used for small MSMs and as the oracle. `msm` routes as the JAX package does
(`halo2_tpu/ops/msm.py:309-330`): below 2^12 points to the host; from 2^16
points, when the largest scalar is at least 2^128, to the sorted-bucket MSM
(`ops/msm_sorted.py`), and on its BucketOverflow, or otherwise, to the
bucket pipeline (`ops/msm_bucket.py`), on the bases' device. `ROUTES` counts
per call site how often an MSM of 2^16 points or more took each way.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Sequence, Type

import torch

from ..curves import JAC_IDENTITY, Curve, Point, jac_add, jac_add_affine, jac_double
from .curve import CurveCtx
from .field import ints_to_limbs

DEVICE_MSM_MIN = 1 << 12
SORTED_MSM_MIN = 1 << 16
# (call site, "sorted" | "overflow" | "small_scalars") -> count. "overflow"
# MSMs went to the sorted MSM first and then to the bucket MSM;
# "small_scalars" ones failed the host pre-check (largest scalar < 2^128).
ROUTES: Counter = Counter()


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
        self._rows: dict = {}

    def device_rows(self, device=None):
        """Row-major (n, 16) affine Montgomery tables of x and y for the
        sorted MSM's gather, cached per device. Raises ValueError for an
        identity base."""
        device = torch.device(device) if device is not None else self.device
        if device not in self._rows:
            p, r = self.curve.p(), self.cc.fctx.r_int
            if any(pt.is_identity() for pt in self.host_points):
                raise ValueError("sorted MSM bases must be affine (identity given)")
            self._rows[device] = tuple(
                torch.as_tensor(ints_to_limbs([pt.xy[i] * r % p for pt in self.host_points]),
                                device=device)
                for i in (0, 1)
            )
        return self._rows[device]

    def device_tables(self, n_pad: int, device=None):
        """Transposed (16, n_pad) coordinate tables, cached per padded size."""
        device = torch.device(device) if device is not None else self.device
        key = (n_pad, device)
        if key not in self._tables:
            from .msm_bucket import DeviceBases

            self._tables[key] = DeviceBases(self.curve, self.host_points, n_pad, device)
        return self._tables[key]


def msm(scalars: Sequence[int], bases, curve: Optional[Type[Curve]] = None,
        device=None, site: str = "msm") -> Point:
    """Dispatching MSM on `bases.device`, or on `device` for a list of host
    points, which then must be given; `site` names the caller in ROUTES.

    Terms whose base is the identity add nothing and are dropped before the
    device MSMs, whose bases must be affine."""
    from ..utils.measure import span
    from .msm_bucket import msm_bucket_many
    from .msm_sorted import BucketOverflow, msm_sorted

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
        ints = [int(s) % q for s in scalars]
        canon = torch.as_tensor(ints_to_limbs(ints), device=device)
        if n >= SORTED_MSM_MIN:
            # small or structured scalars (selector and constant columns) put
            # their digits in few lanes and would overflow the sorted MSM
            if max(ints, default=0) < 1 << 128:
                ROUTES[site, "small_scalars"] += 1
            else:
                try:
                    pt = msm_sorted(canon, bases)
                    ROUTES[site, "sorted"] += 1
                    return pt
                except BucketOverflow:
                    ROUTES[site, "overflow"] += 1
        return msm_bucket_many(canon[None], bases, mont=False)[0]
