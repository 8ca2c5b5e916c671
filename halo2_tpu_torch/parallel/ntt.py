"""Sharded four-step NTT over a device mesh.

Counterpart of `halo2_tpu/parallel/ntt.py`. The size-n transform is
decomposed as n = n1 * n2 (both powers of two, both multiples of the mesh
size D). Viewing the coefficient vector row-major as an (n1, n2) matrix
M[j1, j2] = a[j1*n2 + j2]:

    X[k1 + n1*k2] = sum_j2 w^(j2*k1) * w_n2^(j2*k2) * sum_j1 w_n1^(j1*k1) * M[j1, j2]

  1. column NTTs (size n1, root w^n2) over the j1 axis,
  2. twiddle by w^(j2*k1),
  3. transpose (an all-to-all between the shards),
  4. row NTTs (size n2, root w^n1),
  5. transpose back to natural output order.

Shard i holds the flat rows [i n/D, (i + 1) n/D) on entry and exit, so
pointwise sharded steps chain without a reshuffle. An all-to-all is a chunk
exchange: shard i takes chunk i of every shard's split axis, moved to its
device, and concatenates them in shard order. Each shard's sub-NTTs are one
batched transform of the one-device plan (`ops.ntt.single_plan`: kernel 1
on CUDA). `FourStepNtt(a)` takes and returns an (n, 16) tensor on the
caller's device; `sharded` works on the list of shards.
"""

from __future__ import annotations

from typing import List, Sequence, Type

import torch

from ..fields import FieldElement
from ..ops.field import NLIMBS, FieldCtx, ints_to_limbs, mont_mul
from ..ops.ntt import ntt_many, single_plan
from .context import CALLS, Mesh


def make_mesh(n_devices: int = None, axis: str = "x", devices: Sequence = None) -> Mesh:
    """A mesh over `devices`, or else over the first `n_devices` visible CUDA
    devices (all of them when None). Raises when fewer devices exist than
    asked for (the JAX package would give a smaller mesh)."""
    if devices is not None:
        devs = list(devices)
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"make_mesh: n_devices = {n_devices} but {len(devs)} devices given")
        return Mesh(devs, axis)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = count if n_devices is None else n_devices
    if want < 1 or want > count:
        raise RuntimeError(f"make_mesh: {want} CUDA devices asked for, {count} visible")
    return Mesh([torch.device("cuda", i) for i in range(want)], axis)


def scatter_rows(a: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """(n, ...) -> D row blocks, block i on shard i's device."""
    D = len(mesh.devices)
    return [blk.to(dev) for blk, dev in zip(a.chunk(D, dim=0), mesh.devices)]


def gather_rows(shards: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The row blocks of the shards, in shard order, as one tensor on `device`."""
    return torch.cat([s.to(device) for s in shards], dim=0)


def all_to_all(shards: Sequence[torch.Tensor], mesh: Mesh, split_dim: int,
               concat_dim: int) -> List[torch.Tensor]:
    """Tiled all-to-all: shard i gets chunk i of every shard's `split_dim`,
    on its own device, concatenated along `concat_dim` in shard order."""
    D = len(mesh.devices)
    chunks = [s.chunk(D, dim=split_dim) for s in shards]
    return [torch.cat([chunks[j][i].to(dev) for j in range(D)], dim=concat_dim)
            for i, dev in enumerate(mesh.devices)]


class FourStepNtt:
    """Sharded NTT for a fixed (field, log_n, omega, mesh)."""

    _cache: dict = {}

    def __new__(cls, field: Type[FieldElement], log_n: int, omega: int, mesh: Mesh,
                axis: str = "x"):
        key = (field, log_n, omega, mesh.key, axis)
        if key in cls._cache:
            return cls._cache[key]
        D = mesh.shape[axis]
        if D & (D - 1):
            raise ValueError(f"mesh size must be a power of two, got {D}")
        log_d = D.bit_length() - 1
        if log_n < 2 * log_d:
            raise ValueError(f"four-step NTT needs n >= D^2 (n = 2^{log_n}, D = {D})")
        self = super().__new__(cls)
        self.field = field
        self.ctx = FieldCtx(field)
        self.mesh = mesh
        self.axis = axis
        self.log_n = log_n
        self.n = 1 << log_n
        self.D = D
        # balanced split with both factors divisible by D
        self.log_n1 = max(log_d, log_n // 2)
        self.log_n2 = log_n - self.log_n1
        self.n1 = 1 << self.log_n1
        self.n2 = 1 << self.log_n2
        p = field.MODULUS
        self.col_omega = pow(omega, self.n2, p)
        self.row_omega = pow(omega, self.n1, p)
        # twiddle T[j2, k1] = omega^(j2*k1) in Montgomery form, (n2, n1, 16),
        # built on the host once per plan (n bigint products)
        r = self.ctx.r_int
        flat = []
        for j2 in range(self.n2):
            w = pow(omega, j2, p)
            cur = r % p  # 1 in Montgomery form
            for _ in range(self.n1):
                flat.append(cur)
                cur = cur * w % p  # (x R) w = (x w) R: stays in Montgomery form
        self.twiddle = ints_to_limbs(flat).reshape(self.n2, self.n1, NLIMBS)
        self._tw: dict = {}
        cls._cache[key] = self
        return self

    def _tw_shards(self) -> List[torch.Tensor]:
        """Shard i's rows j2 of the twiddle, on its device."""
        if not self._tw:
            rows = self.n2 // self.D
            for i, dev in enumerate(self.mesh.devices):
                self._tw[i] = torch.as_tensor(self.twiddle[i * rows:(i + 1) * rows], device=dev)
        return [self._tw[i] for i in range(self.D)]

    def sharded(self, shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """D flat row blocks of (n/D, 16) -> the D flat row blocks of the DFT."""
        CALLS["four_step_ntt"] += 1
        mesh, D = self.mesh, self.D
        n1, n2 = self.n1, self.n2
        col_plan = single_plan(self.field, self.log_n1, self.col_omega)
        row_plan = single_plan(self.field, self.log_n2, self.row_omega)
        a = [s.reshape(n1 // D, n2, NLIMBS) for s in shards]  # rows j1 of this block
        a = all_to_all(a, mesh, 1, 0)  # (n1, n2/D): whole columns j2 of this block
        a = [ntt_many(col_plan, s.transpose(0, 1).contiguous()) for s in a]  # (n2/D, n1) [j2, k1]
        a = [mont_mul(s, tw, self.ctx) for s, tw in zip(a, self._tw_shards())]
        a = all_to_all(a, mesh, 1, 0)  # (n2, n1/D) [j2, k1 block]
        a = [ntt_many(row_plan, s.transpose(0, 1).contiguous()) for s in a]  # (n1/D, n2) [k1, k2]
        a = all_to_all(a, mesh, 1, 0)  # (n1, n2/D) [k1, k2 block]
        # flat X[k1 + n1 k2]: rows k2 of this block, each n1 long
        return [s.transpose(0, 1).reshape(self.n // D, NLIMBS) for s in a]

    def __call__(self, a: torch.Tensor) -> torch.Tensor:
        """(n, 16) Montgomery limbs -> the DFT, (n, 16) on a's device."""
        if tuple(a.shape) != (self.n, NLIMBS):
            raise ValueError(f"FourStepNtt: expected ({self.n}, 16), got {tuple(a.shape)}")
        return gather_rows(self.sharded(scatter_rows(a, self.mesh)), a.device)
