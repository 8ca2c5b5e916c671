"""MockProver: in-memory constraint checker with rich failure diagnostics.

Mirrors `halo2_proofs/src/dev.rs` (`MockProver`, `CellValue`, `VerifyFailure`):
synthesizes the circuit capturing every cell, selector, and copy constraint,
then directly evaluates every gate row (with lazy, poison-propagating
semantics for blinding rows), brute-forces lookup membership, and walks
permutation cycles - full constraint checking with zero commitment cost.

A copy of `halo2_tpu/dev/mock_prover.py` on the port's front-end, with one
port inside it: the vectorised check (`_verify_vectorized`) evaluates every
gate and lookup expression over all rows as limb tensors (`FVec`) on the
prover's device, which `run` resolves as the params do (CUDA unless the
caller names the CPU). The row loop and the failure rendering are host code
and render the same text as the JAX package's.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple, Type

import torch

from ..fields import FieldElement
from ..frontend import Value
from ..frontend.floor_planner import synthesize_circuit
from ..plonk.assigned import Assigned
from ..plonk.constraint_system import ConstraintSystem, Gate, configure_circuit
from ..plonk.error import InstanceTooLarge, NotEnoughRowsAvailable, SynthesisError
from ..plonk.expression import ADVICE, FIXED, INSTANCE, Column, Selector
from ..plonk import permutation as permutation_mod
from ..poly import Rotation

# Cell values (reference dev.rs CellValue)
UNASSIGNED = ("unassigned",)


def _poison(row: int):
    return ("poison", row)


def _is_poison(v) -> bool:
    return isinstance(v, tuple) and v and v[0] == "poison"


@dataclass
class RegionInfo:
    index: int
    name: str
    enabled_selectors: Dict[Selector, List[int]] = field(default_factory=dict)
    cells: Set[Tuple[Column, int]] = field(default_factory=set)
    rows: Optional[Tuple[int, int]] = None  # (start, end) inclusive
    # str(column) -> annotation from Region::name_column (metadata.rs)
    column_annotations: Dict[str, str] = field(default_factory=dict)

    def track_row(self, row: int):
        if self.rows is None:
            self.rows = (row, row)
        else:
            self.rows = (min(self.rows[0], row), max(self.rows[1], row))


@dataclass
class FailureLocation:
    """Reference dev/failure.rs FailureLocation::{InRegion, OutsideRegion}."""

    kind: str  # "in_region" | "outside_region"
    region_index: Optional[int] = None
    region_name: Optional[str] = None
    offset: Optional[int] = None
    row: Optional[int] = None

    annotations: Optional[Dict[str, str]] = None  # region column annotations

    @staticmethod
    def find(regions, row: int) -> "FailureLocation":
        for region in regions:
            if region.rows is not None and region.rows[0] <= row <= region.rows[1]:
                return FailureLocation(
                    "in_region", region.index, region.name, row - region.rows[0],
                    annotations=dict(region.column_annotations),
                )
        return FailureLocation("outside_region", row=row)

    def __str__(self):
        if self.kind == "in_region":
            return f"in Region {self.region_index} ('{self.region_name}') at offset {self.offset}"
        return f"outside any region, on row {self.row}"


@dataclass
class VerifyFailure:
    kind: str  # cell_not_assigned | constraint | constraint_poisoned | lookup | permutation
    detail: str
    location: Optional[FailureLocation] = None
    # (column repr, rotation, value repr) per queried cell of the failing gate
    cell_values: Optional[List[Tuple[str, int, str]]] = None

    def _render_cell_table(self) -> str:
        """Aligned cell-layout table (reference dev/failure.rs:125-188 +
        failure/emitter.rs render): one row per rotation offset, one column
        per queried column, values filled in; '<--' marks the gate row.
        Columns carry their `Region::name_column` annotations when the
        failing row lies in an annotated region (metadata.rs)."""
        ann = (self.location.annotations or {}) if self.location else {}
        columns = sorted({c for c, _r, _v in self.cell_values})
        rotations = sorted({r for _c, r, _v in self.cell_values})
        values = {(c, r): v for c, r, v in self.cell_values}
        labels = [
            f"{c} ('{ann[c]}')" if c in ann else c for c in columns
        ]
        headers = ["Offset"] + labels
        rows = [
            [str(r)] + [values.get((c, r), "") for c in columns]
            for r in rotations
        ]
        widths = [
            max(len(headers[i]), *(len(row[i]) for row in rows))
            for i in range(len(headers))
        ]

        def fmt(cells):
            return "  | " + " | ".join(c.ljust(w) for c, w in zip(cells, widths)) + " |"

        out = [fmt(headers)]
        out.append("  |" + "|".join("-" * (w + 2) for w in widths) + "|")
        for r, row in zip(rotations, rows):
            out.append(fmt(row) + (" <--" if r == 0 else ""))
        return "\n".join(out)

    def __str__(self):
        s = f"{self.kind}: {self.detail}"
        if self.location is not None:
            s += f" [{self.location}]"
        if self.cell_values:
            s += "\n  Cell layout at the failing row:\n"
            s += self._render_cell_table()
        return s


class MockProver:
    """Runs a circuit against a complete in-memory backend."""

    def __init__(self, field_cls: Type[FieldElement], k: int, cs: ConstraintSystem,
                 device: torch.device):
        self.field = field_cls
        self.device = device
        self.p = field_cls.MODULUS
        self.k = k
        self.n = 1 << k
        self.cs = cs
        self.current_phase = 0
        self.challenges: Dict[int, int] = {}
        self.regions: List[RegionInfo] = []
        self._current_region: Optional[RegionInfo] = None
        self.fixed: List[List[Any]] = []
        self.advice: List[List[Any]] = []
        self.instance: List[List[Tuple[str, int]]] = []
        self.selectors: List[List[bool]] = []
        self.permutation: Optional[permutation_mod.Assembly] = None
        self.usable_rows = 0

    # ------------------------------------------------------------------
    @classmethod
    def run(
        cls,
        k: int,
        circuit,
        instances: List[List[int]],
        field_cls: Type[FieldElement] = None,
        device=None,
    ) -> "MockProver":
        """Synthesize `circuit` at 2^k rows; the vectorised check runs on
        `device` (CUDA unless the caller names another; a CUDA device that
        is not available raises)."""
        from ..fields import Fp
        from ..poly.ipa import resolve_device

        field_cls = field_cls or Fp
        device = resolve_device(device)
        n = 1 << k
        cs = ConstraintSystem()
        config = configure_circuit(circuit, cs)
        if n < cs.minimum_rows():
            raise NotEnoughRowsAvailable(k)
        if len(instances) != cs.num_instance_columns:
            raise SynthesisError("invalid number of instance columns")

        blinding = cs.blinding_factors()
        usable_rows = n - (blinding + 1)
        prover = cls(field_cls, k, cs, device)
        prover.usable_rows = usable_rows
        for inst in instances:
            if len(inst) > usable_rows:
                raise InstanceTooLarge()
        prover.instance = [
            [("assigned", v % field_cls.MODULUS) for v in inst]
            + [("padding", 0)] * (n - len(inst))
            for inst in instances
        ]
        prover.fixed = [[UNASSIGNED] * n for _ in range(cs.num_fixed_columns)]
        prover.advice = [
            [UNASSIGNED] * usable_rows + [_poison(r) for r in range(usable_rows, n)]
            for _ in range(cs.num_advice_columns)
        ]
        prover.selectors = [[False] * n for _ in range(cs.num_selectors)]
        prover.permutation = permutation_mod.Assembly(cs.permutation, n)

        rng = random.Random(0xC0FFEE)
        for phase in cs.phases():
            prover.current_phase = phase
            prover.regions = []  # regions are re-tracked each phase pass
            synthesize_circuit(prover, circuit, config, cs.constants)
            for idx, ch_phase in enumerate(cs.challenge_phase):
                if ch_phase == phase and idx not in prover.challenges:
                    prover.challenges[idx] = rng.randrange(field_cls.MODULUS)
        # also sample any phase-0-usable challenges not yet sampled
        for idx, ch_phase in enumerate(cs.challenge_phase):
            prover.challenges.setdefault(idx, rng.randrange(field_cls.MODULUS))
        return prover

    # ---------------- Assignment backend interface ----------------
    def enter_region(self, name):
        self._current_region = RegionInfo(len(self.regions), str(name))

    def exit_region(self):
        self.regions.append(self._current_region)
        self._current_region = None

    def annotate_column(self, annotation, column):
        """Record a region-scoped column annotation (reference dev.rs
        annotate_column -> metadata.rs Region column_annotations); the
        failure emitter labels cell-table columns with these names."""
        if self._current_region is not None:
            name = annotation() if callable(annotation) else annotation
            self._current_region.column_annotations[str(column)] = str(name)

    def enable_selector(self, annotation, selector: Selector, row: int):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        if self._current_region is not None:
            self._current_region.enabled_selectors.setdefault(selector, []).append(row)
            self._current_region.track_row(row)
        self.selectors[selector.index][row] = True

    def query_instance(self, column: Column, row: int) -> Value:
        assert column.kind == INSTANCE
        if row >= self.n:
            raise NotEnoughRowsAvailable(self.k)
        kind, v = self.instance[column.index][row]
        return Value.known(v)

    def assign_advice(self, annotation, column: Column, row: int, to):
        if self.current_phase != column.phase:
            return  # wrong phase: ignored (reference WitnessCollection behavior)
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        if self._current_region is not None:
            self._current_region.cells.add((column, row))
            self._current_region.track_row(row)
        v = to()
        if isinstance(v, Value) and not v.is_none():
            a = v.force_value()
            if isinstance(a, Assigned):
                self.advice[column.index][row] = ("assigned", a.evaluate(self.p))
            else:
                self.advice[column.index][row] = ("assigned", int(a) % self.p)

    def assign_fixed(self, annotation, column: Column, row: int, to):
        if self.current_phase != 0:
            return
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        if self._current_region is not None:
            self._current_region.cells.add((column, row))
            self._current_region.track_row(row)
        v = to()
        if isinstance(v, Value) and not v.is_none():
            a = v.force_value()
            if isinstance(a, Assigned):
                self.fixed[column.index][row] = ("assigned", a.evaluate(self.p))
            else:
                self.fixed[column.index][row] = ("assigned", int(a) % self.p)

    def copy(self, left_column: Column, left_row: int, right_column: Column, right_row: int):
        if self.current_phase != 0:
            return
        self.permutation.copy(left_column, left_row, right_column, right_row)

    def fill_from_row(self, column: Column, from_row: int, to: Value):
        if self.current_phase != 0:
            return
        if isinstance(to, Value) and not to.is_none():
            a = to.force_value()
            v = a.evaluate(self.p) if isinstance(a, Assigned) else int(a) % self.p
            for row in range(from_row, self.usable_rows):
                self.fixed[column.index][row] = ("assigned", v)

    def get_challenge(self, challenge) -> Value:
        if challenge.index in self.challenges and challenge.phase <= self.current_phase:
            return Value.known(self.challenges[challenge.index])
        return Value.unknown()

    def push_namespace(self, name):
        pass

    def pop_namespace(self, gadget_name=None):
        pass

    # ---------------- verification ----------------
    def _cell_value(self, kind: str, col: int, row: int):
        """Returns ('real', int) or ('poison',) for gate evaluation."""
        row %= self.n
        if kind == FIXED:
            v = self.fixed[col][row]
        elif kind == ADVICE:
            v = self.advice[col][row]
        else:
            iv = self.instance[col][row]
            return ("real", iv[1])
        if v is UNASSIGNED:
            return ("real", 0)  # unassigned treated as zero in gate eval
        if _is_poison(v):
            return ("poison",)
        return ("real", v[1])

    def _eval_expr(self, expr, row: int):
        p = self.p

        def lazy_product(a, b):
            # reference dev.rs Value::mul: Real(0) on EITHER side annihilates
            # Poison (zeroed selectors/fixed disable gates on poisoned rows)
            if (a[0] == "real" and a[1] == 0) or (b[0] == "real" and b[1] == 0):
                return ("real", 0)
            if a[0] == "poison" or b[0] == "poison":
                return ("poison",)
            return ("real", a[1] * b[1] % p)

        return expr.evaluate(
            constant=lambda c: ("real", c % p),
            selector=lambda s: ("real", 1 if self.selectors[s.index][row] else 0),
            fixed=lambda q: self._cell_value(FIXED, q.column_index, row + q.rotation.i),
            advice=lambda q: self._cell_value(ADVICE, q.column_index, row + q.rotation.i),
            instance=lambda q: self._cell_value(INSTANCE, q.column_index, row + q.rotation.i),
            challenge=lambda c: ("real", self.challenges.get(c.index, 0)),
            negated=lambda a: a if a[0] == "poison" else ("real", (-a[1]) % p),
            sum_=lambda a, b: ("poison",)
            if a[0] == "poison" or b[0] == "poison"
            else ("real", (a[1] + b[1]) % p),
            product=lazy_product,
            scaled=lambda a, f: (
                ("real", 0) if f % p == 0
                else a if a[0] == "poison"
                else ("real", a[1] * f % p)
            ),
        )

    def verify(self, vectorized: Optional[bool] = None) -> List[VerifyFailure]:
        """Full constraint check. `vectorized=True` (auto for large n)
        evaluates each gate/lookup expression over all rows at once as limb
        tensors on the prover's device (the data-parallel analogue of
        `verify_at_rows_par`, dev.rs:1180+); the row-loop path keeps the
        reference's exact lazy poison semantics."""
        if vectorized is None:
            vectorized = self.n >= 8192
        if vectorized:
            return self._verify_vectorized()
        return self._verify_rows()

    def _verify_vectorized(self) -> List[VerifyFailure]:
        import numpy as np

        from ..poly import FVec

        failures: List[VerifyFailure] = []
        p = self.p
        n = self.n
        dev = self.device

        # CellNotAssigned scan (region-based; cheap)
        failures.extend(self._check_cells_assigned())

        # materialize columns as ints + poison masks
        def col_ints(store):
            vals = np.zeros(n, dtype=object)
            poison = np.zeros(n, dtype=bool)
            for row, v in enumerate(store):
                if v is UNASSIGNED:
                    pass
                elif _is_poison(v):
                    poison[row] = True
                else:
                    vals[row] = v[1]
            return vals, poison

        fixed_cols, advice_cols, inst_cols = [], [], []
        fixed_poison, advice_poison = [], []
        for store in self.fixed:
            v, m = col_ints(store)
            fixed_cols.append(v)
            fixed_poison.append(m)
        for store in self.advice:
            v, m = col_ints(store)
            advice_cols.append(v)
            advice_poison.append(m)
        for store in self.instance:
            inst_cols.append(np.array([iv[1] for iv in store], dtype=object))

        fvec_cache: Dict[Tuple[str, int, int], FVec] = {}

        def fv(kind: str, idx: int, rot: int) -> FVec:
            key = (kind, idx, rot)
            if key not in fvec_cache:
                src = {"f": fixed_cols, "a": advice_cols, "i": inst_cols}[kind][idx]
                base_key = (kind, idx, 0)
                if base_key not in fvec_cache:
                    fvec_cache[base_key] = FVec.from_ints(self.field, [int(x) for x in src], dev)
                fvec_cache[key] = fvec_cache[base_key].rotate(rot % n)
            return fvec_cache[key]

        sel_cache: Dict[int, FVec] = {}

        def sel_fv(idx: int) -> FVec:
            if idx not in sel_cache:
                sel_cache[idx] = FVec.from_ints(
                    self.field, [1 if b else 0 for b in self.selectors[idx]], dev
                )
            return sel_cache[idx]

        def eval_fvec(expr) -> FVec:
            return expr.evaluate(
                constant=lambda c: FVec.fill(self.field, n, c % p, dev),
                selector=lambda s: sel_fv(s.index),
                fixed=lambda q: fv("f", q.column_index, q.rotation.i),
                advice=lambda q: fv("a", q.column_index, q.rotation.i),
                instance=lambda q: fv("i", q.column_index, q.rotation.i),
                challenge=lambda c: FVec.fill(
                    self.field, n, self.challenges.get(c.index, 0), dev
                ),
                negated=lambda a: -a,
                sum_=lambda a, b: a + b,
                product=lambda a, b: a * b,
                scaled=lambda a, f: a * FVec.fill(self.field, n, f % p, dev),
            )

        # poison mask per gate: any queried non-instance cell poisoned
        def gate_poison_mask(gate) -> "np.ndarray":
            mask = np.zeros(n, dtype=bool)
            for column, rotation in gate.queried_cells:
                if column.kind == FIXED:
                    m = fixed_poison[column.index]
                elif column.kind == ADVICE:
                    m = advice_poison[column.index]
                else:
                    continue
                mask |= np.roll(m, -rotation.i)
            return mask

        for gate_idx, gate in enumerate(self.cs.gates):
            pmask = gate_poison_mask(gate)
            for poly_idx, poly in enumerate(gate.polys):
                out = np.array(eval_fvec(poly).to_ints(), dtype=object)
                bad_rows = np.nonzero((out != 0) & ~pmask)[0]
                for row in bad_rows[:20]:
                    row = int(row)
                    failures.append(
                        VerifyFailure(
                            "constraint",
                            f"{self._constraint_meta(gate_idx, gate, poly_idx)}"
                            " is not satisfied",
                            location=FailureLocation.find(self.regions, row),
                            cell_values=self._gate_cell_values(gate, row),
                        )
                    )

        # lookups over usable rows
        for lk_idx, lk in enumerate(self.cs.lookups):
            table_cols = [eval_fvec(te).to_ints() for te in lk.table_expressions]
            input_cols = [eval_fvec(ie).to_ints() for ie in lk.input_expressions]
            u = self.usable_rows
            table = set(zip(*(tc[:u] for tc in table_cols)))
            inputs = list(zip(*(ic[:u] for ic in input_cols)))
            for row, entry in enumerate(inputs):
                if entry not in table:
                    failures.append(
                        VerifyFailure(
                            "lookup",
                            f"lookup {lk_idx} '{lk.name}' input {entry} at row {row} "
                            "not in table",
                            location=FailureLocation.find(self.regions, row),
                        )
                    )
                    if sum(1 for f in failures if f.kind == "lookup") > 20:
                        break

        failures.extend(self._check_permutation())
        return failures

    def _constraint_meta(self, gate_idx: int, gate, poly_idx: int):
        """metadata.Constraint handle for a gate polynomial (metadata.rs)."""
        from . import metadata

        return metadata.Constraint(
            metadata.Gate(gate_idx, gate.name),
            poly_idx,
            gate.constraint_names[poly_idx],
        )

    def _gate_cell_values(self, gate, row: int):
        """(column repr, rotation, value repr) for every cell the gate
        queries at `row` (reference failure.rs ConstraintNotSatisfied
        cell_values)."""
        cell_values = []
        for column, rotation in gate.queried_cells:
            crow = (row + rotation.i) % self.n
            if column.kind == INSTANCE:
                val = str(self.instance[column.index][crow][1])
            else:
                store = self.fixed if column.kind == FIXED else self.advice
                cv = store[column.index][crow]
                val = (
                    "unassigned" if cv is UNASSIGNED
                    else ("poison" if _is_poison(cv) else f"0x{cv[1]:x}")
                )
            cell_values.append((str(column), rotation.i, str(val)))
        return cell_values

    def _check_cells_assigned(self) -> List[VerifyFailure]:
        from . import metadata

        failures: List[VerifyFailure] = []
        for region in self.regions:
            for selector, rows in region.enabled_selectors.items():
                for gate_idx, gate in enumerate(self.cs.gates):
                    if selector not in gate.queried_selectors:
                        continue
                    for row in rows:
                        for column, rotation in gate.queried_cells:
                            cell_row = (row + rotation.i) % self.n
                            if column.kind == INSTANCE:
                                continue
                            if (column, cell_row) in region.cells:
                                continue
                            store = self.fixed if column.kind == FIXED else self.advice
                            if store[column.index][cell_row] is UNASSIGNED:
                                offset = (
                                    cell_row - region.rows[0]
                                    if region.rows else cell_row
                                )
                                gm = metadata.Gate(gate_idx, gate.name)
                                failures.append(
                                    VerifyFailure(
                                        "cell_not_assigned",
                                        f"Region {region.index} ('{region.name}')"
                                        f" uses {gm} at offset {offset}, but"
                                        f" does not assign {column}",
                                    )
                                )
        return failures

    def _check_permutation(self) -> List[VerifyFailure]:
        failures: List[VerifyFailure] = []
        cols = self.cs.permutation.columns
        for i, column in enumerate(cols):
            for row in range(self.n):
                ci, ri = self.permutation.mapping[i][row]
                if (i, row) == (ci, ri):
                    continue
                a = self._perm_value(column, row)
                b = self._perm_value(cols[ci], ri)
                if a != b:
                    failures.append(
                        VerifyFailure(
                            "permutation",
                            f"copy constraint {column} row {row} != {cols[ci]} row {ri}"
                            f" ({a} vs {b})",
                        )
                    )
        return failures

    def _verify_rows(self) -> List[VerifyFailure]:
        failures: List[VerifyFailure] = []
        p = self.p

        # 1. CellNotAssigned (dev.rs:744-784)
        failures.extend(self._check_cells_assigned())

        # 2. Gate constraints at every row (poison semantics)
        for gate_idx, gate in enumerate(self.cs.gates):
            for poly_idx, poly in enumerate(gate.polys):
                for row in range(self.n):
                    v = self._eval_expr(poly, row)
                    if v[0] == "poison":
                        failures.append(
                            VerifyFailure(
                                "constraint_poisoned",
                                f"{self._constraint_meta(gate_idx, gate, poly_idx)}"
                                f" is poisoned at row {row}",
                            )
                        )
                    elif v[1] != 0:
                        failures.append(
                            VerifyFailure(
                                "constraint",
                                f"{self._constraint_meta(gate_idx, gate, poly_idx)}"
                                " is not satisfied",
                                location=FailureLocation.find(self.regions, row),
                                cell_values=self._gate_cell_values(gate, row),
                            )
                        )

        # 3. Lookups: brute-force membership over usable rows
        for lk_idx, lk in enumerate(self.cs.lookups):
            table: Set[Tuple[int, ...]] = set()
            for row in range(self.usable_rows):
                entry = tuple(
                    self._eval_expr(te, row)[1] if self._eval_expr(te, row)[0] == "real" else None
                    for te in lk.table_expressions
                )
                table.add(entry)
            for row in range(self.usable_rows):
                inputs = tuple(
                    self._eval_expr(ie, row)[1] if self._eval_expr(ie, row)[0] == "real" else None
                    for ie in lk.input_expressions
                )
                if inputs not in table:
                    failures.append(
                        VerifyFailure(
                            "lookup",
                            f"lookup {lk_idx} '{lk.name}' input {inputs} at row {row} not in table",
                            location=FailureLocation.find(self.regions, row),
                        )
                    )

        # 4. Permutation cycle value equality
        failures.extend(self._check_permutation())
        return failures

    def _perm_value(self, column: Column, row: int):
        if column.kind == INSTANCE:
            return self.instance[column.index][row][1]
        store = self.fixed if column.kind == FIXED else self.advice
        v = store[column.index][row]
        if v is UNASSIGNED:
            return 0
        if _is_poison(v):
            return ("poison", row)
        return v[1]

    def verify_par(self) -> List[VerifyFailure]:
        """Reference verify_par (dev.rs): the vectorized path is our
        data-parallel analogue of the rayon row-parallel verify."""
        return self.verify(vectorized=True)

    def verify_at_rows(self, gate_rows, lookup_rows) -> List[VerifyFailure]:
        """Reference verify_at_rows(_par) (dev.rs:1180+): restrict gate and
        lookup checking to the given row iterables."""
        gate_rows = set(gate_rows)
        lookup_rows = set(lookup_rows)
        out = []
        for f in self.verify(vectorized=False):
            if f.kind in ("constraint", "constraint_poisoned"):
                row = None
                if f.location is not None:
                    row = (
                        f.location.row
                        if f.location.row is not None
                        else (f.location.offset or 0)
                    )
                # fall back to parsing the detail when no location row
                if "at row " in f.detail:
                    row = int(f.detail.rsplit("at row ", 1)[1].split()[0])
                if row is not None and row not in gate_rows:
                    continue
            elif f.kind == "lookup":
                if "at row " in f.detail:
                    row = int(f.detail.rsplit("at row ", 1)[1].split()[0])
                    if row not in lookup_rows:
                        continue
            out.append(f)
        return out

    verify_at_rows_par = verify_at_rows

    def assert_satisfied_par(self):
        failures = self.verify_par()
        if failures:
            msg = "\n".join(str(f) for f in failures[:20])
            raise AssertionError(f"circuit is not satisfied:\n{msg}")

    def assert_satisfied(self):
        failures = self.verify()
        if failures:
            msg = "\n".join(str(f) for f in failures[:20])
            raise AssertionError(f"circuit is not satisfied:\n{msg}")
