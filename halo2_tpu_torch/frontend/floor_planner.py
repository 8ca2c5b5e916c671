"""Floor planners: region placement over the column grid.

`SimpleFloorPlanner` mirrors the reference single-pass layouter
(`halo2_proofs/src/circuit/floor_planner/single_pass.rs`): each region is
first dry-run against a `RegionShape` to measure its column set and row
count, then placed at the earliest row at which none of its columns are in
use; constants are assigned sequentially in the first constants column.
Placement determines absolute rows and therefore the permutation sigma
polynomials - parity with the reference here is required for identical
verifying keys.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ..plonk.assigned import Assigned
from ..plonk.error import Error, NotEnoughColumnsForConstants, SynthesisError
from ..plonk.expression import ADVICE, FIXED, INSTANCE, Column, Selector, TableColumn
from . import Cell, Layouter, Region, Table, Value

# RegionColumn: either a concrete Column or a Selector (layouter.rs RegionColumn)
RegionColumn = Tuple[str, Any]


def _rc_column(column: Column) -> RegionColumn:
    return ("column", column)


def _rc_selector(selector: Selector) -> RegionColumn:
    return ("selector", selector)


class RegionShape:
    """Dry-run shape collector (reference circuit/layouter.rs RegionShape)."""

    def __init__(self, region_index: int):
        self.region_index = region_index
        self.columns: Set[RegionColumn] = set()
        self.row_count = 0

    # RegionLayouter interface
    def enable_selector(self, annotation, selector: Selector, offset: int):
        self.columns.add(_rc_selector(selector))
        self.row_count = max(self.row_count, offset + 1)

    def name_column(self, annotation, column: Column):
        pass

    def assign_advice(self, annotation, column: Column, offset: int, to) -> Cell:
        self.columns.add(_rc_column(column))
        self.row_count = max(self.row_count, offset + 1)
        return Cell(self.region_index, offset, column)

    def assign_advice_from_constant(self, annotation, column: Column, offset: int, constant) -> Cell:
        return self.assign_advice(annotation, column, offset, None)

    def assign_advice_from_instance(self, annotation, instance, row, advice, offset):
        self.columns.add(_rc_column(advice))
        self.row_count = max(self.row_count, offset + 1)
        return Cell(self.region_index, offset, advice), Value.unknown()

    def instance_value(self, instance: Column, row: int) -> Value:
        return Value.unknown()

    def assign_fixed(self, annotation, column: Column, offset: int, to) -> Cell:
        self.columns.add(_rc_column(column))
        self.row_count = max(self.row_count, offset + 1)
        return Cell(self.region_index, offset, column)

    def constrain_constant(self, cell: Cell, constant):
        pass

    def constrain_equal(self, left: Cell, right: Cell):
        pass


class _SingleChipRegion:
    """Real assignment pass region (single_pass.rs SingleChipLayouterRegion)."""

    def __init__(self, layouter: "SingleChipLayouter", region_index: int):
        self.layouter = layouter
        self.region_index = region_index
        self.constants: List[Tuple[Assigned, Cell]] = []

    def enable_selector(self, annotation, selector: Selector, offset: int):
        self.layouter.cs.enable_selector(
            annotation, selector, self.layouter.regions[self.region_index] + offset
        )

    def name_column(self, annotation, column: Column):
        self.layouter.cs.annotate_column(annotation, column)

    def assign_advice(self, annotation, column: Column, offset: int, to) -> Cell:
        self.layouter.cs.assign_advice(
            annotation, column, self.layouter.regions[self.region_index] + offset, to
        )
        return Cell(self.region_index, offset, column)

    def assign_advice_from_constant(self, annotation, column, offset, constant) -> Cell:
        cell = self.assign_advice(annotation, column, offset, lambda: Value.known(constant))
        self.constrain_constant(cell, constant)
        return cell

    def assign_advice_from_instance(self, annotation, instance, row, advice, offset):
        value = self.layouter.cs.query_instance(instance, row)
        cell = self.assign_advice(annotation, advice, offset, lambda: value.to_field())
        self.layouter.cs.copy(
            cell.column,
            self.layouter.regions[cell.region_index] + cell.row_offset,
            instance,
            row,
        )
        return cell, value

    def instance_value(self, instance: Column, row: int) -> Value:
        return self.layouter.cs.query_instance(instance, row)

    def assign_fixed(self, annotation, column: Column, offset: int, to) -> Cell:
        self.layouter.cs.assign_fixed(
            annotation, column, self.layouter.regions[self.region_index] + offset, to
        )
        return Cell(self.region_index, offset, column)

    def constrain_constant(self, cell: Cell, constant: Assigned):
        self.constants.append((constant, cell))

    def constrain_equal(self, left: Cell, right: Cell):
        self.layouter.cs.copy(
            left.column,
            self.layouter.regions[left.region_index] + left.row_offset,
            right.column,
            self.layouter.regions[right.region_index] + right.row_offset,
        )


class _SimpleTableLayouter:
    """Table assignment with default-value fill (single_pass.rs SimpleTableLayouter)."""

    def __init__(self, cs, used_columns: List[TableColumn]):
        self.cs = cs
        self.used_columns = used_columns
        # column -> (default value (first-row), assigned bool list)
        self.default_and_assigned: Dict[TableColumn, Tuple[Optional[Value], List[bool]]] = {}

    def assign_cell(self, annotation, column: TableColumn, offset: int, to):
        if column in self.used_columns:
            raise SynthesisError("table column already used")
        entry = self.default_and_assigned.setdefault(column, (None, []))

        value_holder = []

        def capture():
            v = to()
            value_holder.append(v)
            return v

        self.cs.assign_fixed(annotation, column.inner, offset, capture)
        default, assigned = entry
        if default is None and offset == 0:
            # backends may skip evaluating the closure (e.g. the prover's
            # WitnessCollection); record an unknown default in that case
            default = value_holder[0] if value_holder else Value.unknown()
        while len(assigned) <= offset:
            assigned.append(False)
        assigned[offset] = True
        self.default_and_assigned[column] = (default, assigned)


class SingleChipLayouter(Layouter):
    def __init__(self, cs, constants: List[Column]):
        self.cs = cs  # Assignment backend
        self.constants = constants
        self.regions: List[int] = []  # start row per region
        self.columns: Dict[RegionColumn, int] = {}  # first empty row per column
        self.table_columns: List[TableColumn] = []

    def assign_region(self, name: str, fn: Callable[[Region], Any]):
        region_index = len(self.regions)
        # shape pass
        shape = RegionShape(region_index)
        result = fn(Region(shape))

        # place at earliest row where none of the columns are used
        region_start = 0
        for column in shape.columns:
            region_start = max(region_start, self.columns.get(column, 0))
        self.regions.append(region_start)
        for column in shape.columns:
            self.columns[column] = region_start + shape.row_count

        # assignment pass
        self.cs.enter_region(name)
        region = _SingleChipRegion(self, region_index)
        result = fn(Region(region))
        constants_to_assign = region.constants
        self.cs.exit_region()

        # assign constants in the first constants column
        if not self.constants:
            if constants_to_assign:
                raise NotEnoughColumnsForConstants()
        else:
            constants_column = self.constants[0]
            key = _rc_column(constants_column)
            next_constant_row = self.columns.get(key, 0)
            for constant, advice in constants_to_assign:
                self.cs.assign_fixed(
                    f"Constant({constant!r})",
                    constants_column,
                    next_constant_row,
                    lambda c=constant: Value.known(c),
                )
                self.cs.copy(
                    constants_column,
                    next_constant_row,
                    advice.column,
                    self.regions[advice.region_index] + advice.row_offset,
                )
                next_constant_row += 1
            self.columns[key] = next_constant_row
        return result

    def assign_table(self, name: str, fn: Callable[[Table], None]):
        self.cs.enter_region(name)
        table = _SimpleTableLayouter(self.cs, self.table_columns)
        fn(Table(table))
        default_and_assigned = table.default_and_assigned
        self.cs.exit_region()

        # all table columns must have equal assigned length
        lengths = set()
        for default, assigned in default_and_assigned.values():
            if not all(assigned):
                raise SynthesisError("table column has unassigned gaps")
            lengths.add(len(assigned))
        if len(lengths) != 1:
            raise SynthesisError("table columns have inconsistent lengths")
        first_unused = lengths.pop()

        for column in default_and_assigned:
            self.table_columns.append(column)
        for column, (default, _) in default_and_assigned.items():
            if default is None:
                raise SynthesisError("table column missing default (no offset-0 cell)")
            self.cs.fill_from_row(column.inner, first_unused, default)

    def constrain_instance(self, cell: Cell, instance: Column, row: int):
        self.cs.copy(
            cell.column, self.regions[cell.region_index] + cell.row_offset, instance, row
        )

    def get_challenge(self, challenge):
        return self.cs.get_challenge(challenge)

    def get_root(self):
        return self

    def push_namespace(self, name: str):
        self.cs.push_namespace(name)

    def pop_namespace(self, gadget_name=None):
        self.cs.pop_namespace(gadget_name)


class SimpleFloorPlanner:
    """Single-pass floor planner (reference single_pass.rs:25-36)."""

    @staticmethod
    def synthesize(cs, circuit, config, constants: List[Column]):
        layouter = SingleChipLayouter(cs, constants)
        return circuit.synthesize(config, layouter)


def planner_of(circuit):
    """The circuit's floor planner (Circuit::FloorPlanner); defaults to
    SimpleFloorPlanner."""
    return getattr(type(circuit), "floor_planner", None) or SimpleFloorPlanner


def synthesize_circuit(cs, circuit, config, constants: List[Column]):
    return planner_of(circuit).synthesize(cs, circuit, config, constants)


# ---------------------------------------------------------------------------
# V1 floor planner (reference circuit/floor_planner/v1.rs + v1/strategy.rs)
# ---------------------------------------------------------------------------


def _rc_sort_key(rc: RegionColumn):
    """Consensus-critical ordering: Instance < Advice(by phase) < Fixed,
    then index; columns before selectors (reference plonk/circuit.rs:243-259,
    layouter.rs RegionColumn Ord)."""
    kind, inner = rc
    if kind == "column":
        order = {INSTANCE: (0, 0), ADVICE: (1, getattr(inner, "phase", 0)), FIXED: (2, 0)}[
            inner.kind
        ]
        return (0, order[0], order[1], inner.index)
    return (1, 0, 0, inner.index)


class Allocations:
    """Disjoint allocated [start, start+length) intervals in one column
    (v1/strategy.rs:44-99)."""

    def __init__(self):
        self.items: List[Tuple[int, int]] = []  # sorted (start, length)

    def unbounded_interval_start(self) -> int:
        if not self.items:
            return 0
        s, l = self.items[-1]
        return s + l

    def free_intervals(self, start: int, end: Optional[int]):
        """Yield (space_start, space_end_or_None) for unallocated gaps
        intersecting [start, end)."""
        row = start
        for (s, l) in self.items:
            if end is not None and s >= end:
                return
            if row < s:
                yield (row, s)
            row = max(row, s + l)
        if end is None or row < end:
            yield (row, end)

    def insert(self, start: int, length: int):
        self.items.append((start, length))
        self.items.sort()


def _first_fit_region(column_allocations, region_columns, region_length, start, slack):
    """v1/strategy.rs:107-160: find the first row at which the region fits
    in all its columns simultaneously."""
    if not region_columns:
        return start
    c = region_columns[0]
    rest = region_columns[1:]
    end = (start + region_length + slack) if slack is not None else None
    alloc = column_allocations.setdefault(c, Allocations())
    for (s_start, s_end) in list(alloc.free_intervals(start, end)):
        s_slack = None if s_end is None else (s_end - s_start) - region_length
        if slack is not None and s_slack is not None:
            assert s_slack <= slack
        if s_slack is None or s_slack >= 0:
            row = _first_fit_region(
                column_allocations, rest, region_length, s_start, s_slack
            )
            if row is not None:
                column_allocations[c].insert(row, region_length)
                return row
    return None


def slot_in_biggest_advice_first(region_shapes: List[RegionShape]):
    """v1/strategy.rs:197-225: sort regions by advice area (descending),
    first-fit each, then restore original region order."""

    def advice_area(shape: RegionShape) -> int:
        advice_cols = sum(
            1
            for (kind, inner) in shape.columns
            if kind == "column" and inner.kind == ADVICE
        )
        return advice_cols * shape.row_count

    order = sorted(range(len(region_shapes)), key=lambda i: advice_area(region_shapes[i]))
    order.reverse()
    column_allocations: Dict[RegionColumn, Allocations] = {}
    starts = [0] * len(region_shapes)
    for i in order:
        shape = region_shapes[i]
        cols = sorted(shape.columns, key=_rc_sort_key)
        start = _first_fit_region(column_allocations, cols, shape.row_count, 0, None)
        assert start is not None
        starts[i] = start
    return starts, column_allocations


class _V1Layouter(SingleChipLayouter):
    """Assignment-pass layouter with pre-planned region starts."""

    def __init__(self, cs, constants, planned_starts):
        super().__init__(cs, constants)
        self._planned = planned_starts
        self._next_region = 0
        self.collected_constants: List[Tuple[Assigned, Cell]] = []

    def assign_region(self, name: str, fn: Callable[[Region], Any]):
        region_index = self._next_region
        self._next_region += 1
        self.regions.append(self._planned[region_index])

        self.cs.enter_region(name)
        region = _SingleChipRegion(self, region_index)
        result = fn(Region(region))
        self.collected_constants.extend(region.constants)
        self.cs.exit_region()
        return result


class _MeasureLayouter(Layouter):
    """Measurement pass: collect RegionShapes via without_witnesses synth."""

    def __init__(self, cs):
        self.cs = cs
        self.shapes: List[RegionShape] = []

    def assign_region(self, name, fn):
        shape = RegionShape(len(self.shapes))
        result = fn(Region(shape))
        self.shapes.append(shape)
        return result

    def assign_table(self, name, fn):
        pass  # tables are placed by the assignment pass

    def constrain_instance(self, cell, instance, row):
        pass

    def get_challenge(self, challenge):
        return Value.unknown()

    def get_root(self):
        return self

    def push_namespace(self, name):
        pass

    def pop_namespace(self, gadget_name=None):
        pass


class V1FloorPlanner:
    """Dual-pass floor planner (reference floor_planner/v1.rs:28-140):
    measure all regions via `without_witnesses`, plan with
    slot_in_biggest_advice_first, then synthesize with planned starts and
    place constants in the free space of the constants columns."""

    @staticmethod
    def synthesize(cs, circuit, config, constants: List[Column]):
        measure = _MeasureLayouter(cs)
        circuit.without_witnesses().synthesize(config, measure)

        starts, column_allocations = slot_in_biggest_advice_first(measure.shapes)
        first_unassigned_row = max(
            (a.unbounded_interval_start() for a in column_allocations.values()),
            default=0,
        )

        layouter = _V1Layouter(cs, constants, starts)
        result = circuit.synthesize(config, layouter)

        # place constants in free intervals of the constants columns
        positions = []
        for c in constants:
            alloc = column_allocations.get(_rc_column(c), Allocations())
            for (s, e) in alloc.free_intervals(0, first_unassigned_row):
                positions.extend((c, row) for row in range(s, e))
        if len(positions) < len(layouter.collected_constants):
            raise NotEnoughColumnsForConstants()
        for (fixed_column, fixed_row), (value, advice) in zip(
            positions, layouter.collected_constants
        ):
            cs.assign_fixed(
                f"Constant({value!r})", fixed_column, fixed_row,
                lambda v=value: Value.known(v),
            )
            cs.copy(
                fixed_column,
                fixed_row,
                advice.column,
                layouter.regions[advice.region_index] + advice.row_offset,
            )
        return result
