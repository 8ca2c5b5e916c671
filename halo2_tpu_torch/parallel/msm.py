"""Sharded MSM over a device mesh.

Counterpart of `halo2_tpu/parallel/msm.py`. Points and scalars are cut into
D equal slabs along the point axis; shard i runs the port's bucket MSM
(`ops.msm_bucket.window_sums`: kernels 2-4 on CUDA) on its slab, on its
device, and gets the slab's projective window sums. A log2(D)-round
butterfly of complete additions then sums them: in round s shard i adds
shard (i + s) mod D's sums, moved to its device, so that every shard holds
the total. Shard 0's window sums come back to the host once and are joined
by Horner over the windows, as `msm_bucket_many` does. The JAX package
sums bucket grids across devices instead; the result is the same group
element as `msm_host`.

Each shard's slab of bases is an `MSMBases` on its device, cached per
(bases, mesh, slab length).
"""

from __future__ import annotations

import weakref
from typing import List, Sequence

import torch

from ..curves import JAC_IDENTITY, Point, jac_add, jac_double
from ..ops.curve import PointVec, padd
from ..ops.field import ints_to_limbs
from ..ops.msm import MSMBases
from ..ops.msm_bucket import msm_geometry, window_sums
from .context import CALLS, Mesh

_SLABS: "weakref.WeakKeyDictionary[MSMBases, dict]" = weakref.WeakKeyDictionary()


def _slabs(bases: MSMBases, mesh: Mesh, n: int, m: int) -> List[MSMBases]:
    """The D slabs of bases[:n], m points each (the last ones may be short),
    shard i's on its device."""
    per = _SLABS.setdefault(bases, {})
    key = (mesh.key, n, m)
    if key not in per:
        pts = bases.host_points[:n]
        per[key] = [MSMBases(bases.curve, pts[i * m:(i + 1) * m], dev)
                    for i, dev in enumerate(mesh.devices)]
    return per[key]


def sharded_msm(
    scalars: Sequence[int],
    bases: MSMBases,
    mesh: Mesh,
    axis: str = "x",
    c: int = 4,
    lanes: int = 1 << 10,
) -> Point:
    """MSM with the point axis sharded over `mesh`; the same group element as
    `msm_host`. `c` and `lanes` are the JAX package's signature: each
    shard's bucket MSM takes its own geometry (`msm_geometry`)."""
    CALLS["sharded_msm"] += 1
    curve = bases.curve
    cc = bases.cc
    D = mesh.shape[axis]
    n = len(scalars)
    if n > bases.n:
        raise ValueError(f"sharded_msm: {n} scalars for {bases.n} bases")
    m = -(-n // D)
    q = curve.SCALAR.MODULUS
    ints = [int(s) % q for s in scalars] + [0] * (D * m - n)
    canon = torch.as_tensor(ints_to_limbs(ints)).reshape(D, m, -1)
    slabs = _slabs(bases, mesh, n, m)
    sums = [window_sums(canon[i:i + 1].to(dev), slab, mont=False)
            for i, (slab, dev) in enumerate(zip(slabs, mesh.devices))]  # (nwin, 3, 16) each
    shift = 1
    while shift < D:
        nxt = []
        for i, dev in enumerate(mesh.devices):
            mine, other = sums[i], sums[(i + shift) % D].to(dev)
            s = padd(PointVec(mine[:, 0], mine[:, 1], mine[:, 2]),
                     PointVec(other[:, 0], other[:, 1], other[:, 2]), cc)
            nxt.append(torch.stack(list(s), dim=1))
        sums = nxt
        shift *= 2
    c_used, nwin, _, _ = msm_geometry(curve, m, mesh.devices[0])
    total = sums[0]
    wins = cc.decode_points(PointVec(total[:, 0], total[:, 1], total[:, 2]))
    p = curve.p()
    acc = JAC_IDENTITY
    for w in range(nwin - 1, -1, -1):
        for _ in range(c_used):
            acc = jac_double(acc, p)
        acc = jac_add(acc, wins[w].jacobian(), p)
    return curve.from_jacobian(acc)
