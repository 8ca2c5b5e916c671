"""Device-resident Lagrange column set for one proof.

The prover-side counterpart of the reference's `&[Polynomial<...,
LagrangeCoeff>]` slices threaded through `lookup/prover.rs` and
`permutation/prover.rs`: every advice/fixed/instance column is held ONCE as
an (n, 16) Montgomery FVec on device, and lookup compression / permutation
grand products evaluate expressions directly over these vectors (the
reference's free `evaluate` row loop, `plonk/evaluation.rs` — here a
vectorized device program instead of per-row host bigints).

Counterpart of `halo2_tpu/plonk/columns.py`; columns live on `device`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..poly import FVec
from .expression import ADVICE, FIXED, INSTANCE, Expression


class ProofColumns:
    """Lazy device encodings of one proof's Lagrange columns."""

    def __init__(self, field, n: int, advice_ints: Sequence[Optional[List[int]]],
                 fixed_vecs: Sequence[FVec], instance_ints: Sequence[List[int]],
                 challenges: Sequence[int], device):
        self.field = field
        self.device = device
        self.n = n
        self._advice_ints = advice_ints
        self._fixed = list(fixed_vecs)
        self._instance_ints = instance_ints
        self.challenges = list(challenges)
        self._advice: Dict[int, FVec] = {}
        self._instance: Dict[int, FVec] = {}

    # ---- column access (encode once per column) ----
    def advice(self, i: int) -> FVec:
        if i not in self._advice:
            self._advice[i] = FVec.from_ints(self.field, self._advice_ints[i], self.device)
        return self._advice[i]

    def set_advice(self, i: int, vec: FVec) -> None:
        """Adopt an already-encoded advice column (the witness-commit path
        encodes every column for its batched MSM; reuse that encoding)."""
        self._advice[i] = vec

    def fixed(self, i: int) -> FVec:
        return self._fixed[i]

    def instance(self, i: int) -> FVec:
        if i not in self._instance:
            self._instance[i] = FVec.from_ints(self.field, self._instance_ints[i], self.device)
        return self._instance[i]

    def column(self, column) -> FVec:
        if column.kind == ADVICE:
            return self.advice(column.index)
        if column.kind == FIXED:
            return self.fixed(column.index)
        assert column.kind == INSTANCE
        return self.instance(column.index)

    # ---- expression evaluation over all n rows (device) ----
    def eval_expr(self, expr: Expression) -> FVec:
        F = self.field
        n = self.n

        def const_vec(c: int) -> FVec:
            return FVec.fill(F, n, c, self.device)

        return expr.evaluate(
            constant=lambda c: const_vec(c),
            selector=lambda s: (_ for _ in ()).throw(
                ValueError("virtual selectors are removed during optimization")
            ),
            fixed=lambda q: self.fixed(q.column_index).rotate(q.rotation.i),
            advice=lambda q: self.advice(q.column_index).rotate(q.rotation.i),
            instance=lambda q: self.instance(q.column_index).rotate(q.rotation.i),
            challenge=lambda c: const_vec(self.challenges[c.index]),
            negated=lambda a: -a,
            sum_=lambda a, b: a + b,
            product=lambda a, b: a * b,
            scaled=lambda a, f: a * F(f),
        )
