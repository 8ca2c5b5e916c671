"""ConstraintSystem: the PLONKish arithmetization builder.

Mirrors `halo2_proofs/src/plonk/circuit.rs:1601-2460`: columns and phases,
gates built through `VirtualCells` queries, lookup arguments, the copy
(permutation) argument, constants, degree/blinding accounting, and boolean
selector compression into packed fixed columns
(`plonk/circuit/compress_selectors.rs:51-352`).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Callable, List, Optional, Sequence, Tuple

from ..poly import Rotation
from . import lookup as lookup_mod
from . import permutation as permutation_mod
from .error import Error, SynthesisError
from .expression import (
    ADVICE,
    FIXED,
    INSTANCE,
    AdviceQuery,
    Challenge,
    ChallengeExpr,
    Column,
    Constant,
    Expression,
    FixedQuery,
    InstanceQuery,
    Negated,
    Product,
    Scaled,
    Selector,
    SelectorExpr,
    Sum,
    TableColumn,
)


@dataclass
class Gate:
    name: str
    constraint_names: List[str]
    polys: List[Expression]
    queried_selectors: List[Selector]
    queried_cells: List[Tuple[Column, Rotation]]


class VirtualCells:
    """Query collector passed to gate/lookup closures
    (reference circuit.rs:2394-2460)."""

    def __init__(self, cs: "ConstraintSystem"):
        self.cs = cs
        self.queried_selectors: List[Selector] = []
        self.queried_cells: List[Tuple[Column, Rotation]] = []

    def query_selector(self, s: Selector) -> Expression:
        self.queried_selectors.append(s)
        return SelectorExpr(s)

    def query_fixed(self, column: Column, at: Rotation = Rotation(0)) -> Expression:
        assert column.kind == FIXED
        self.queried_cells.append((column, at))
        return FixedQuery(self.cs.query_fixed_index(column, at), column.index, at)

    def query_advice(self, column: Column, at: Rotation = Rotation(0)) -> Expression:
        assert column.kind == ADVICE
        self.queried_cells.append((column, at))
        return AdviceQuery(
            self.cs.query_advice_index(column, at), column.index, at, column.phase
        )

    def query_instance(self, column: Column, at: Rotation = Rotation(0)) -> Expression:
        assert column.kind == INSTANCE
        self.queried_cells.append((column, at))
        return InstanceQuery(self.cs.query_instance_index(column, at), column.index, at)

    def query_any(self, column: Column, at: Rotation = Rotation(0)) -> Expression:
        return {
            FIXED: self.query_fixed,
            ADVICE: self.query_advice,
            INSTANCE: self.query_instance,
        }[column.kind](column, at)

    def query_challenge(self, challenge: Challenge) -> Expression:
        return ChallengeExpr(challenge)


class ConstraintSystem:
    def __init__(self):
        self.num_fixed_columns = 0
        self.num_advice_columns = 0
        self.num_instance_columns = 0
        self.num_selectors = 0
        self.num_challenges = 0
        self.advice_column_phase: List[int] = []
        self.challenge_phase: List[int] = []
        self.selector_map: List[Column] = []  # filled by compress_selectors
        self.gates: List[Gate] = []
        self.advice_queries: List[Tuple[Column, Rotation]] = []
        self.num_advice_queries: List[int] = []
        self.instance_queries: List[Tuple[Column, Rotation]] = []
        self.fixed_queries: List[Tuple[Column, Rotation]] = []
        self.permutation = permutation_mod.Argument()
        self.lookups: List[lookup_mod.Argument] = []
        self.constants: List[Column] = []
        self.minimum_degree: Optional[int] = None
        self.general_column_annotations = {}

    # ---------------- column allocation ----------------
    def fixed_column(self) -> Column:
        col = Column(FIXED, self.num_fixed_columns)
        self.num_fixed_columns += 1
        return col

    def advice_column(self) -> Column:
        return self.advice_column_in(0)

    def advice_column_in(self, phase: int) -> Column:
        if phase > 0:
            assert phase - 1 in self.advice_column_phase or phase == 1 or True
        col = Column(ADVICE, self.num_advice_columns, phase)
        self.num_advice_columns += 1
        self.advice_column_phase.append(phase)
        return col

    def instance_column(self) -> Column:
        col = Column(INSTANCE, self.num_instance_columns)
        self.num_instance_columns += 1
        return col

    def selector(self) -> Selector:
        s = Selector(self.num_selectors, simple=True)
        self.num_selectors += 1
        return s

    def complex_selector(self) -> Selector:
        s = Selector(self.num_selectors, simple=False)
        self.num_selectors += 1
        return s

    def lookup_table_column(self) -> TableColumn:
        return TableColumn(self.fixed_column())

    def challenge_usable_after(self, phase: int) -> Challenge:
        """The challenge is squeezed at the END of `phase` (after that
        phase's advice commitments), hence usable in later phases
        (reference circuit.rs:2189)."""
        ch = Challenge(self.num_challenges, phase)
        self.num_challenges += 1
        self.challenge_phase.append(phase)
        return ch

    # ---------------- copy/constant configuration ----------------
    def enable_equality(self, column: Column):
        self.query_any_index(column, Rotation(0))
        self.permutation.add_column(column)

    def enable_constant(self, column: Column):
        assert column.kind == FIXED
        if column not in self.constants:
            self.constants.append(column)
            self.enable_equality(column)

    def set_minimum_degree(self, degree: int):
        self.minimum_degree = degree

    # ---------------- gates / lookups ----------------
    def create_gate(self, name: str, constraints_fn: Callable[[VirtualCells], list]):
        cells = VirtualCells(self)
        constraints = constraints_fn(cells)
        if not isinstance(constraints, list):
            constraints = [constraints]
        named = []
        for c in constraints:
            if isinstance(c, tuple):
                named.append(c)
            else:
                named.append(("", c))
        assert named, "gates must contain at least one constraint"
        self.gates.append(
            Gate(
                name=name,
                constraint_names=[n for n, _ in named],
                polys=[e for _, e in named],
                queried_selectors=cells.queried_selectors,
                queried_cells=cells.queried_cells,
            )
        )

    def lookup(
        self, name: str, table_map_fn: Callable[[VirtualCells], List[Tuple[Expression, TableColumn]]]
    ) -> int:
        """Lookup whose table is TableColumns (reference circuit.rs:1774)."""
        cells = VirtualCells(self)
        mapping = table_map_fn(cells)
        inputs, tables = [], []
        for input_expr, table in mapping:
            _assert_no_simple_selector(input_expr)
            table_expr = cells.query_fixed(table.inner, Rotation(0))
            inputs.append(input_expr)
            tables.append(table_expr)
        index = len(self.lookups)
        self.lookups.append(lookup_mod.Argument(name, inputs, tables))
        return index

    def lookup_any(
        self, name: str, table_map_fn: Callable[[VirtualCells], List[Tuple[Expression, Expression]]]
    ) -> int:
        """Lookup with arbitrary table expressions (reference circuit.rs:1804)."""
        cells = VirtualCells(self)
        mapping = table_map_fn(cells)
        inputs, tables = [], []
        for input_expr, table_expr in mapping:
            _assert_no_simple_selector(input_expr)
            _assert_no_simple_selector(table_expr)
            inputs.append(input_expr)
            tables.append(table_expr)
        index = len(self.lookups)
        self.lookups.append(lookup_mod.Argument(name, inputs, tables))
        return index

    # ---------------- query bookkeeping ----------------
    def query_fixed_index(self, column: Column, at: Rotation) -> int:
        for i, (c, r) in enumerate(self.fixed_queries):
            if (c, r) == (column, at):
                return i
        self.fixed_queries.append((column, at))
        return len(self.fixed_queries) - 1

    def query_advice_index(self, column: Column, at: Rotation) -> int:
        for i, (c, r) in enumerate(self.advice_queries):
            if (c, r) == (column, at):
                return i
        self.advice_queries.append((column, at))
        while len(self.num_advice_queries) <= column.index:
            self.num_advice_queries.append(0)
        self.num_advice_queries[column.index] += 1
        return len(self.advice_queries) - 1

    def query_instance_index(self, column: Column, at: Rotation) -> int:
        for i, (c, r) in enumerate(self.instance_queries):
            if (c, r) == (column, at):
                return i
        self.instance_queries.append((column, at))
        return len(self.instance_queries) - 1

    def query_any_index(self, column: Column, at: Rotation) -> int:
        return {
            FIXED: self.query_fixed_index,
            ADVICE: self.query_advice_index,
            INSTANCE: self.query_instance_index,
        }[column.kind](column, at)

    def get_any_query_index(self, column: Column, at: Rotation) -> int:
        queries = {
            FIXED: self.fixed_queries,
            ADVICE: self.advice_queries,
            INSTANCE: self.instance_queries,
        }[column.kind]
        for i, (c, r) in enumerate(queries):
            if (c, r) == (column, at):
                return i
        raise KeyError((column, at))

    # ---------------- accounting ----------------
    def degree(self) -> int:
        degree = self.permutation.required_degree()
        for lk in self.lookups:
            degree = max(degree, lk.required_degree())
        for gate in self.gates:
            for poly in gate.polys:
                degree = max(degree, poly.degree())
        return max(degree, self.minimum_degree or 1)

    def blinding_factors(self) -> int:
        factors = max(self.num_advice_queries) if self.num_advice_queries else 1
        factors = max(3, factors)
        return factors + 1 + 1  # +1 multiopen eval, +1 off-by-one defense

    def minimum_rows(self) -> int:
        return self.blinding_factors() + 3

    def phases(self) -> List[int]:
        max_phase = max(self.advice_column_phase, default=0)
        return list(range(max_phase + 1))

    # ---------------- selector compression ----------------
    def compress_selectors(self, selectors: List[List[bool]]) -> List[List[int]]:
        """Rewrite boolean selectors into packed fixed columns; returns the
        new fixed-column value vectors (ints 0..), mutating gates/lookups.

        Reference: circuit.rs:1981 + compress_selectors.rs:51-227.
        """
        assert len(selectors) == self.num_selectors
        degrees = [0] * len(selectors)
        for gate in self.gates:
            for expr in gate.polys:
                s = expr.extract_simple_selector()
                if s is not None:
                    degrees[s.index] = max(degrees[s.index], expr.degree())

        max_degree = self.degree()
        new_columns: List[Column] = []

        def allocate_fixed_column() -> Expression:
            column = self.fixed_column()
            new_columns.append(column)
            return FixedQuery(
                self.query_fixed_index(column, Rotation(0)), column.index, Rotation(0)
            )

        descriptions = [
            {"selector": i, "activations": act, "max_degree": degrees[i]}
            for i, act in enumerate(selectors)
        ]
        polys, assignments = _process_selector_compression(
            descriptions, max_degree, allocate_fixed_column
        )

        selector_map: List[Optional[Column]] = [None] * len(assignments)
        replacements: List[Optional[Expression]] = [None] * len(assignments)
        for a in assignments:
            replacements[a["selector"]] = a["expression"]
            selector_map[a["selector"]] = new_columns[a["combination_index"]]
        self.selector_map = selector_map
        self.selector_replacements = replacements

        def replace(expr: Expression, must_be_nonsimple: bool) -> Expression:
            return expr.evaluate(
                constant=lambda c: Constant(c),
                selector=lambda s: _check_nonsimple(s, must_be_nonsimple)
                or replacements[s.index],
                fixed=lambda q: q,
                advice=lambda q: q,
                instance=lambda q: q,
                challenge=lambda c: ChallengeExpr(c),
                negated=lambda a: Negated(a),
                sum_=lambda a, b: Sum(a, b),
                product=lambda a, b: Product(a, b),
                scaled=lambda a, f: Scaled(a, f),
            )

        for gate in self.gates:
            gate.polys = [replace(e, False) for e in gate.polys]
        for lk in self.lookups:
            lk.input_expressions = [replace(e, True) for e in lk.input_expressions]
            lk.table_expressions = [replace(e, True) for e in lk.table_expressions]
        return polys


def configure_circuit(circuit, cs: "ConstraintSystem"):
    """Configure `cs` from a circuit instance or class, honouring the
    `circuit-params` feature (reference plonk/circuit.rs:752-793): a circuit
    class defining `configure_with_params(cls, meta, params)` is configured
    with the instance's `params()` value (default None); otherwise the plain
    `configure(cls, meta)` classmethod runs."""
    cls = circuit if isinstance(circuit, type) else type(circuit)
    if hasattr(cls, "configure_with_params"):
        params = None
        if not isinstance(circuit, type) and hasattr(circuit, "params"):
            params = circuit.params()
        return cls.configure_with_params(cs, params)
    return cls.configure(cs)


def _check_nonsimple(s: Selector, must_be_nonsimple: bool):
    if must_be_nonsimple:
        assert not s.simple, "simple selectors may not appear in lookups"
    return None


def _assert_no_simple_selector(expr: Expression):
    if expr.extract_simple_selector() is not None:
        raise SynthesisError(
            "expression containing simple selector supplied to lookup argument"
        )


def _process_selector_compression(
    selectors: List[dict], max_degree: int, allocate_fixed_column: Callable[[], Expression]
):
    """compress_selectors::process (reference compress_selectors.rs:51-227)."""
    if not selectors:
        return [], []
    n = len(selectors[0]["activations"])
    assert all(len(s["activations"]) == n for s in selectors)

    combination_assignments: List[List[int]] = []
    selector_assignments: List[dict] = []

    remaining = []
    for sel in selectors:
        if sel["max_degree"] == 0:
            # complex selector or not used in any gate: its own fixed column
            expression = allocate_fixed_column()
            combination_assignments.append([1 if b else 0 for b in sel["activations"]])
            selector_assignments.append(
                {
                    "selector": sel["selector"],
                    "combination_index": len(combination_assignments) - 1,
                    "expression": expression,
                }
            )
        else:
            remaining.append(sel)
    selectors = remaining

    # exclusion matrix: selectors enabled on a common row cannot combine
    exclusion = [[False] * i for i in range(len(selectors))]
    for i, sel in enumerate(selectors):
        for j in range(i):
            if any(l and r for l, r in zip(sel["activations"], selectors[j]["activations"])):
                exclusion[i][j] = True

    added = [False] * len(selectors)
    for i, sel in enumerate(selectors):
        if added[i]:
            continue
        added[i] = True
        assert sel["max_degree"] <= max_degree
        d = sel["max_degree"] - 1
        combination = [sel]
        combination_added = [i]
        for j in range(i + 1, len(selectors)):
            if d + len(combination) == max_degree:
                break
            if added[j]:
                continue
            if any(exclusion[j][k] for k in combination_added):
                continue
            new_d = max(d, selectors[j]["max_degree"] - 1)
            if new_d + len(combination) + 1 > max_degree:
                continue
            d = new_d
            combination.append(selectors[j])
            combination_added.append(j)
            added[j] = True

        combination_assignment = [0] * n
        combination_len = len(combination)
        combination_index = len(combination_assignments)
        query = allocate_fixed_column()

        assigned_root = 1
        for sel_c in combination:
            # q * Prod[root != assigned_root](root - q)
            expression: Expression = query
            root = 1
            for _ in range(combination_len):
                if root != assigned_root:
                    expression = Product(expression, Sum(Constant(root), Negated(query)))
                root += 1
            for idx, active in enumerate(sel_c["activations"]):
                if active:
                    combination_assignment[idx] = assigned_root
            selector_assignments.append(
                {
                    "selector": sel_c["selector"],
                    "combination_index": combination_index,
                    "expression": expression,
                }
            )
            assigned_root += 1
        combination_assignments.append(combination_assignment)

    return combination_assignments, selector_assignments
