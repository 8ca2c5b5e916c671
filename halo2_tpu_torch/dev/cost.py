"""Circuit cost model (reference `halo2_proofs/src/dev/cost.rs`).

`CircuitCost.measure(k, circuit)` synthesizes the circuit with a
selector-only assembly, compresses selectors, and derives column/query/
lookup/permutation counts plus the number of distinct multiopen point sets;
`marginal_proof_size()` / `proof_size(instances)` mirror the reference's
contribution accounting (cost.rs:150-343) for the IPA scheme (32-byte
points and scalars).

A copy of `halo2_tpu/dev/cost.py` on the port's front-end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Type

from ..frontend import Value
from ..frontend.floor_planner import synthesize_circuit
from ..plonk.constraint_system import ConstraintSystem, configure_circuit
from ..poly import Rotation


class _SelectorAssembly:
    """Assignment backend that records only selector activations
    (cost.rs:46-148)."""

    def __init__(self, k: int, num_selectors: int):
        self.selectors = [[False] * (1 << k) for _ in range(num_selectors)]

    def enter_region(self, name):
        pass

    def exit_region(self):
        pass

    def annotate_column(self, annotation, column):
        pass

    def enable_selector(self, annotation, selector, row):
        self.selectors[selector.index][row] = True

    def query_instance(self, column, row):
        return Value.unknown()

    def assign_advice(self, annotation, column, row, to):
        pass

    def assign_fixed(self, annotation, column, row, to):
        pass

    def copy(self, *args):
        pass

    def fill_from_row(self, *args):
        pass

    def get_challenge(self, challenge):
        return Value.unknown()

    def push_namespace(self, name):
        pass

    def pop_namespace(self, gadget_name=None):
        pass


@dataclass
class ProofContribution:
    commitments: int
    evaluations: int

    def size(self, point_bytes: int = 32, scalar_bytes: int = 32) -> int:
        return self.commitments * point_bytes + self.evaluations * scalar_bytes

    def __add__(self, other):
        return ProofContribution(
            self.commitments + other.commitments, self.evaluations + other.evaluations
        )

    def __mul__(self, n: int):
        return ProofContribution(self.commitments * n, self.evaluations * n)


class CircuitCost:
    def __init__(self, k, max_deg, advice_columns, instance_queries, advice_queries,
                 fixed_queries, lookups, permutation_cols, point_sets):
        self.k = k
        self.max_deg = max_deg
        self.advice_columns = advice_columns
        self.instance_queries = instance_queries
        self.advice_queries = advice_queries
        self.fixed_queries = fixed_queries
        self.lookups = lookups
        self.permutation_cols = permutation_cols
        self.point_sets = point_sets

    @classmethod
    def measure(cls, k: int, circuit) -> "CircuitCost":
        cs = ConstraintSystem()
        config = configure_circuit(circuit, cs)
        assembly = _SelectorAssembly(k, cs.num_selectors)
        synthesize_circuit(assembly, circuit, config, cs.constants)
        cs.compress_selectors(assembly.selectors)
        assert (1 << k) >= cs.minimum_rows()

        column_queries = {}
        all_queries = (
            [(("a", c.index), r.i) for c, r in cs.advice_queries]
            + [(("i", c.index), r.i) for c, r in cs.instance_queries]
            + [(("f", c.index), r.i) for c, r in cs.fixed_queries]
            + [((c.kind, c.index), 0) for c in cs.permutation.columns]
        )
        for col, rot in all_queries:
            column_queries.setdefault(col, set()).add(rot)
        point_sets = {tuple(sorted(rs)) for rs in column_queries.values()}
        point_sets.add((0, 1))  # lookup product / permutation product
        point_sets.add((-1, 0))  # permuted input
        point_sets.add((0,))  # permuted table
        max_deg = cs.degree()
        permutation_cols = len(cs.permutation.columns)
        if permutation_cols > max_deg - 2:
            point_sets.add((-(cs.blinding_factors() + 1), 0, 1))

        return cls(
            k, max_deg, cs.num_advice_columns, len(cs.instance_queries),
            len(cs.advice_queries), len(cs.fixed_queries), len(cs.lookups),
            permutation_cols, len(point_sets),
        )

    def permutation_chunks(self) -> int:
        chunk = self.max_deg - 2
        return (self.permutation_cols + chunk - 1) // chunk

    def marginal_proof_size(self) -> int:
        chunks = self.permutation_chunks()
        contributions = [
            ProofContribution(0, self.instance_queries),
            ProofContribution(self.advice_columns, self.advice_queries),
            ProofContribution(3 * self.lookups, 5 * self.lookups),
            ProofContribution(chunks, 3 * chunks - 1 if chunks else 0),
        ]
        return sum(c.size() for c in contributions)

    def proof_size(self, instances: int) -> int:
        marginal = self.marginal_proof_size() * instances
        fixed = ProofContribution(0, self.fixed_queries)
        equality = ProofContribution(0, self.permutation_cols)
        vanishing = ProofContribution(self.max_deg, 1)
        multiopen = ProofContribution(1, self.point_sets)
        polycomm = ProofContribution(1 + 2 * self.k, 2)
        return marginal + sum(
            c.size() for c in (fixed, equality, vanishing, multiopen, polycomm)
        )
