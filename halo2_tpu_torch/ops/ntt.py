"""Number-theoretic transform over limb tensors.

Counterpart of `halo2_tpu/ops/ntt.py`. `NttPlan` is the plain radix-2
iterative Cooley-Tukey over (n, 16) Montgomery tensors, kept as the
whole-transform reference. `get_plan` hands every basis change of the
prover to the engine that the NTT environment variable names: by default
the constant-geometry plan (`ops/ntt_cg.py`, kernel 1), else the
mixed-radix plan (`ops/ntt_mr.py`, kernel 8), the Toeplitz-product plan
(`ops/mxu_mont.py`) or the radix-2 plan. The levels of the first two run
their hand-written CUDA kernel on a CUDA tensor and its plain version on a
CPU tensor.

Semantics: a_i -> sum_j a_j w^{ij} for the plan's root w; the inverse pass
uses omega_inv and the caller divides by n.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Type

import numpy as np
import torch

from ..fields import FieldElement
from .field import NLIMBS, FieldCtx, add_mod, ints_to_limbs, mont_mul, sub_mod


@lru_cache(maxsize=None)
def bitrev_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


class NttPlan:
    """Radix-2 DIT NTT with precomputed (host) twiddles; any device."""

    _cache: dict = {}

    def __new__(cls, field: Type[FieldElement], log_n: int, omega: int):
        key = (field, log_n, omega)
        if key in cls._cache:
            return cls._cache[key]
        self = super().__new__(cls)
        cls._cache[key] = self
        self.ctx = FieldCtx(field)
        self.log_n = log_n
        self.n = 1 << log_n
        self.omega = omega
        p = field.MODULUS
        r = self.ctx.r_int
        self._tw_host = []
        for s in range(log_n):
            m = 1 << s
            w_m = pow(omega, self.n >> (s + 1), p)
            tw, cur = [], 1
            for _ in range(m):
                tw.append(cur * r % p)
                cur = cur * w_m % p
            self._tw_host.append(ints_to_limbs(tw))
        self._dev: dict = {}
        return self

    def _tables(self, device):
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = (
                [torch.as_tensor(t, device=device) for t in self._tw_host],
                torch.as_tensor(bitrev_perm(self.log_n), device=device),
            )
        return self._dev[device]

    def __call__(self, a: torch.Tensor) -> torch.Tensor:
        """(n, 16) -> (n, 16) DFT with this plan's omega (Montgomery in/out)."""
        ctx = self.ctx
        n = self.n
        tws, perm = self._tables(a.device)
        a = a[perm]
        for s in range(self.log_n):
            m = 1 << s
            blocks = a.reshape(n // (2 * m), 2, m, NLIMBS)
            lo, hi = blocks[:, 0], blocks[:, 1]
            t = mont_mul(hi, tws[s], ctx)
            a = torch.stack([add_mod(lo, t, ctx), sub_mod(lo, t, ctx)], dim=1).reshape(n, NLIMBS)
        return a


def get_plan(field: Type[FieldElement], log_n: int, omega: int):
    """The NTT engine for a transform of 2^log_n points: the counterpart of
    `halo2_tpu/ops/ntt.py:103-138` and of the reference's switch between its
    three FFT implementations (`fft.rs`).

    When a mesh is active (`parallel.use_mesh`) and the transform is large
    enough for its four-step split (n >= D^2), the sharded `FourStepNtt`,
    whose sub-transforms take `single_plan`'s engine; otherwise
    `single_plan`'s engine."""
    from ..parallel.context import active_mesh

    mc = active_mesh()
    if mc is not None and mc.can_shard_ntt(log_n):
        from ..parallel.ntt import FourStepNtt

        return FourStepNtt(field, log_n, omega, mc.mesh, mc.axis)
    return single_plan(field, log_n, omega)


def single_plan(field: Type[FieldElement], log_n: int, omega: int):
    """The one-device engine that the environment variable NTT names, read at
    each call.

    - unset, "auto", "cg" or "pallas2": `CgNttPlan` (kernel 1) at every
      size. The JAX package's "auto" takes it only for log n >= 10 on a TPU
      and the radix-2 plan otherwise; every plan computes the same DFT, so
      that choice changes no byte, and the port keeps the plain radix-2 plan
      off the card's main path.
    - "pallas": `MrNttPlan`, the mixed-radix plan (kernel 8).
    - "mxu": `MxuNttPlan`, stage twiddles as exact Toeplitz matrix products.
    - "jnp": `NttPlan`, the plain radix-2 whole-transform reference.

    Any other value raises ValueError: the JAX dispatcher falls back to the
    radix-2 plan, which would hide a misspelt engine."""
    impl = os.environ.get("NTT", "auto")
    if impl in ("auto", "cg", "pallas2"):
        from .ntt_cg import CgNttPlan

        return CgNttPlan(field, log_n, omega)
    if impl == "pallas":
        from .ntt_mr import MrNttPlan

        return MrNttPlan(field, log_n, omega)
    if impl == "mxu":
        from .mxu_mont import MxuNttPlan

        return MxuNttPlan(field, log_n, omega)
    if impl == "jnp":
        return NttPlan(field, log_n, omega)
    raise ValueError(f"NTT={impl!r}: expected one of auto, cg, pallas2, pallas, mxu, jnp")


def ntt_many(plan, a: torch.Tensor) -> torch.Tensor:
    """(B, n, 16) -> (B, n, 16): `plan` down each of the B rows, as one
    batched transform where the plan has one (`CgNttPlan.many`)."""
    many = getattr(plan, "many", None)
    if many is not None:
        return many(a)
    return torch.stack([plan(row) for row in a])


def intt(a: torch.Tensor, field: Type[FieldElement], omega_inv: int, n_inv: int) -> torch.Tensor:
    """Inverse DFT: forward pass with omega_inv, then scale by 1/n."""
    ctx = FieldCtx(field)
    out = get_plan(field, a.shape[-2].bit_length() - 1, omega_inv)(a)
    return mont_mul(out, ctx.const(n_inv, a.device), ctx)


def powers(c: int, n: int, ctx: FieldCtx, device) -> torch.Tensor:
    """[1, c, c^2, ..., c^(n-1)] in Montgomery form, (n, 16), built on the host."""
    p = ctx.p_int
    out, cur = [], 1
    for _ in range(n):
        out.append(cur)
        cur = cur * c % p
    return ctx.consts(out, device)
