"""Sharded quotient (h) evaluation: the extended domain cut into row blocks.

Counterpart of `halo2_tpu/parallel/quotient.py`. The reference walks the
extended domain part by part (`plonk/evaluation.rs:394-975`); here the same
axis is sharded instead: an extended vector is a list of D row blocks,
block i on the mesh's device i. Pointwise steps run on each block where it
lies; a rotation exchanges the rows that cross a block edge; the basis
changes are the four-step sharded NTTs of `parallel.ntt`.

`ShardedQuotient` holds the steps: coefficients -> zeta-coset extension
(sharded NTT), rotation, division by t(X) on the coset, and the inverse
sharded NTT back to coefficients (reference `domain.rs:269-430`).
`compile_gate_program` folds Expression ASTs with powers of y over sharded
columns with the port's field ops (reference `evaluation.rs:442-533`).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Type

import torch

from ..fields import FieldElement
from ..ops.field import NLIMBS, FieldCtx, add_mod, mont_mul, neg_mod
from .context import Mesh
from .ntt import FourStepNtt, gather_rows, scatter_rows

Sharded = List[torch.Tensor]


class ShardedQuotient:
    """Row-sharded extended-domain engine for a fixed (field, j, k, mesh)."""

    def __init__(self, field: Type[FieldElement], j: int, k: int, mesh: Mesh,
                 axis: str = "x"):
        p = field.MODULUS
        self.field = field
        self.ctx = FieldCtx(field)
        self.mesh = mesh
        self.axis = axis
        self.D = mesh.shape[axis]
        self.k = k
        self.n = 1 << k
        self.quotient_poly_degree = j - 1
        extended_k = k
        while (1 << extended_k) < self.n * (j - 1):
            extended_k += 1
        self.extended_k = extended_k
        self.extended_n = 1 << extended_k
        self.block = self.extended_n // self.D
        self.extended_omega = pow(field.ROOT_OF_UNITY, 1 << (field.S - extended_k), p)
        self.omega = pow(self.extended_omega, 1 << (extended_k - k), p)
        self.extended_omega_inv = pow(self.extended_omega, -1, p)
        self.extended_ifft_divisor = pow(1 << extended_k, -1, p)
        self.g_coset = field.ZETA
        self.g_coset_inv = field.ZETA * field.ZETA % p

        self.fwd = FourStepNtt(field, extended_k, self.extended_omega, mesh, axis)
        self.bwd = FourStepNtt(field, extended_k, self.extended_omega_inv, mesh, axis)

        # t(zeta * ext_omega^i)^-1 repeats with period m = extended_n / n
        m = self.extended_n >> k
        orig = pow(field.ZETA, self.n, p)
        step = pow(self.extended_omega, self.n, p)
        self.t_inv = []
        cur = orig
        for _ in range(m):
            self.t_inv.append(pow((cur - 1) % p, -1, p))
            cur = cur * step % p
        self._dev: dict = {}

    def _tables(self, i: int):
        """Shard i's constants on its device: t^-1 over its rows, the inverse
        zeta pattern over its rows, and 1 / extended_n."""
        if i not in self._dev:
            dev = self.mesh.devices[i]
            rows = torch.arange(i * self.block, (i + 1) * self.block, device=dev)
            tinv = self.ctx.consts(self.t_inv, dev)
            zinv = self.ctx.consts([1, self.g_coset_inv, self.g_coset], dev)
            self._dev[i] = (tinv[rows % len(self.t_inv)], zinv[rows % 3],
                            self.ctx.const(self.extended_ifft_divisor, dev))
        return self._dev[i]

    def extend(self, coeffs: torch.Tensor) -> Sharded:
        """(n, 16) coefficients -> the zeta-coset evaluations, row-sharded."""
        dev = coeffs.device
        zeta = self.ctx.consts([1, self.g_coset, self.g_coset_inv], dev)
        v = mont_mul(coeffs, zeta[torch.arange(self.n, device=dev) % 3], self.ctx)
        v = torch.nn.functional.pad(v, (0, 0, 0, self.extended_n - self.n))
        return self.fwd.sharded(scatter_rows(v, self.mesh))

    def rotate(self, ext: Sharded, rotation: int) -> Sharded:
        """Rotation by `rotation` rows of the base domain: out[t] = ext[t + s]
        for s = rotation * extended_n / n, with the rows that cross a block
        edge taken from the neighbouring shard."""
        D, B = self.D, self.block
        s = ((1 << (self.extended_k - self.k)) * rotation) % self.extended_n
        q, r = divmod(s, B)
        out = []
        for i, dev in enumerate(self.mesh.devices):
            a, b = ext[(i + q) % D], ext[(i + q + 1) % D]
            out.append(torch.cat([a[r:].to(dev), b[:r].to(dev)], dim=0))
        return out

    def divide_vanishing(self, ext: Sharded) -> Sharded:
        return [mont_mul(x, self._tables(i)[0], self.ctx) for i, x in enumerate(ext)]

    def to_coeff(self, ext: Sharded, device=None) -> torch.Tensor:
        """Extended evaluations -> quotient coefficients (all extended_n of
        them; the caller truncates to n * quotient_poly_degree), gathered on
        `device` (shard 0's by default)."""
        v = self.bwd.sharded(ext)
        out = []
        for i, x in enumerate(v):
            _, zinv, div = self._tables(i)
            out.append(mont_mul(mont_mul(x, div.expand_as(x), self.ctx), zinv, self.ctx))
        return gather_rows(out, self.mesh.devices[0] if device is None else device)


def compile_gate_program(
    exprs: Sequence, sq: ShardedQuotient, num_fixed: int, num_advice: int,
    num_instance: int,
) -> Callable:
    """Expression ASTs -> one fold over sharded extended columns.

    Returns fn(fixed_ext, advice_ext, instance_ext, challenges, y) -> the
    folded constraint vector h = (...(e_0 y + e_1) y + ...) + e_last,
    row-sharded; each *_ext is a list of sharded columns, challenges and y
    are field elements as ints. The counterpart of the reference's
    straight-line `Calculation` program (`plonk/evaluation.rs:1007-1210`)."""
    ctx = sq.ctx
    devices = sq.mesh.devices
    B = sq.block

    def const(c: int) -> Sharded:
        return [ctx.const(c, dev).expand(B, NLIMBS) for dev in devices]

    def zip_with(fn, a: Sharded, b: Sharded) -> Sharded:
        return [fn(x, y, ctx) for x, y in zip(a, b)]

    def column(cols, q, count):
        if q.column_index >= count:
            raise IndexError(f"column {q.column_index} of {count}")
        return sq.rotate(cols[q.column_index], q.rotation.i)

    def fold_fn(fixed_ext, advice_ext, instance_ext, challenges, y) -> Sharded:
        def build(expr) -> Sharded:
            return expr.evaluate(
                constant=const,
                selector=lambda s: (_ for _ in ()).throw(ValueError("virtual selector")),
                fixed=lambda q: column(fixed_ext, q, num_fixed),
                advice=lambda q: column(advice_ext, q, num_advice),
                instance=lambda q: column(instance_ext, q, num_instance),
                challenge=lambda c: const(challenges[c.index]),
                negated=lambda a: [neg_mod(x, ctx) for x in a],
                sum_=lambda a, b: zip_with(add_mod, a, b),
                product=lambda a, b: zip_with(mont_mul, a, b),
                scaled=lambda a, f: zip_with(mont_mul, a, const(f)),
            )

        y_s = const(y)
        h = None
        for expr in exprs:
            v = build(expr)
            h = v if h is None else zip_with(add_mod, zip_with(mont_mul, h, y_s), v)
        return h

    return fold_fn
