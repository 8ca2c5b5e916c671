"""The device mesh and the active-mesh context.

Counterpart of `halo2_tpu/parallel/context.py`. A `Mesh` is an ordered list
of torch devices along one named axis: shard i's tensors live on
`devices[i]`, and an exchange between shards is a tensor copy. A list may
name one device more than once; its shards are then logical, as the JAX
package's tests run on eight virtual host devices.

Activating a mesh re-routes the port's three dispatch points, and no others:

  * `ops.ntt.get_plan`          -> the four-step NTT (`parallel.ntt`) when
    the transform is large enough for the mesh,
  * `ops.msm.msm`               -> the point-sharded MSM (`parallel.msm`)
    when the point count clears `msm_min`, and
  * `Evaluator.evaluate_h`      -> the row-sharded fold (`evaluate_h_mesh`)
    when the extended domain can be sharded,

so an ordinary `create_proof` runs over the mesh with no prover change.
Every step is exact integer arithmetic, so the proof bytes equal the
single-device bytes.

Usage:

    from halo2_tpu_torch.parallel import make_mesh, use_mesh
    with use_mesh(make_mesh(4)):
        create_proof(params, pk, [circuit], [[inst]], rng, transcript)
"""

from __future__ import annotations

from collections import Counter
from contextlib import contextmanager
from typing import Optional, Sequence

import torch

# Calls that took a mesh route: "four_step_ntt", "sharded_msm" and
# "evaluate_h_mesh", so that a caller can see that no route fell back to
# one device.
CALLS: Counter = Counter()


class Mesh:
    """An ordered list of devices along one named axis."""

    def __init__(self, devices: Sequence, axis: str = "x"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis
        self.shape = {axis: len(self.devices)}

    @property
    def key(self):
        return (self.devices, self.axis)


class MeshContext:
    """A mesh activation: which mesh, which axis, and the dispatch
    thresholds deciding when a problem is large enough to shard."""

    def __init__(self, mesh: Mesh, axis: str = "x", msm_min: int = 1 << 12):
        D = mesh.shape[axis]
        if D & (D - 1):
            raise ValueError(f"mesh axis size must be a power of two, got {D}")
        self.mesh = mesh
        self.axis = axis
        self.D = D
        self.log_d = D.bit_length() - 1
        self.msm_min = msm_min

    def can_shard_ntt(self, log_n: int) -> bool:
        """The four-step split needs n >= D^2 (parallel/ntt.py geometry)."""
        return self.D > 1 and log_n >= 2 * self.log_d

    def can_shard_msm(self, n: int) -> bool:
        return self.D > 1 and n >= max(self.msm_min, 8 * self.D)


_ACTIVE: Optional[MeshContext] = None


def active_mesh() -> Optional[MeshContext]:
    return _ACTIVE


@contextmanager
def use_mesh(mesh: Mesh, axis: str = "x", msm_min: int = 1 << 12):
    """Activate `mesh` for every NTT, MSM and quotient fold dispatched
    inside the block."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = MeshContext(mesh, axis, msm_min)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev
