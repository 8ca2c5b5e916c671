"""Circuit construction front-end.

Mirrors `halo2_proofs/src/circuit.rs`: `Value` (option-like witness wrapper,
circuit/value.rs:16-210), `Cell`/`AssignedCell` (:88-176), `Region`/`Table`
(:180-404), `Layouter`/`NamespacedLayouter` (:411-579), and the `Chip` trait
(:27-48). Witness synthesis is host-side Python; values land in columns that
are batched to device tensors at commit time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Union

from ..fields import FieldElement
from ..plonk.assigned import Assigned
from ..plonk.error import Error, SynthesisError
from ..plonk.expression import ADVICE, FIXED, INSTANCE, Challenge, Column, Selector, TableColumn


class Value:
    """A witness value that may be unknown (keygen) or known (proving).

    Unlike Option, there is deliberately no `unwrap`: values propagate
    through `map`/`zip`/arithmetic so that keygen and proving share one
    synthesis code path (reference circuit/value.rs design note).
    """

    __slots__ = ("_inner",)

    def __init__(self):
        self._inner = _UNKNOWN

    @staticmethod
    def unknown() -> "Value":
        v = object.__new__(Value)
        v._inner = _UNKNOWN
        return v

    @staticmethod
    def known(inner) -> "Value":
        v = object.__new__(Value)
        v._inner = inner
        return v

    def is_none(self) -> bool:
        return self._inner is _UNKNOWN

    def assertion_map(self):  # pragma: no cover - debugging helper
        return self._inner

    def map(self, f: Callable) -> "Value":
        if self.is_none():
            return self
        return Value.known(f(self._inner))

    def and_then(self, f: Callable) -> "Value":
        if self.is_none():
            return self
        out = f(self._inner)
        assert isinstance(out, Value)
        return out

    def zip(self, other: "Value") -> "Value":
        if self.is_none() or other.is_none():
            return Value.unknown()
        return Value.known((self._inner, other._inner))

    def error_if_known_and(self, pred: Callable[[Any], bool]):
        if not self.is_none() and pred(self._inner):
            raise SynthesisError("Value failed assertion")

    # arithmetic sugar (delegates to inner values)
    def _bin(self, other, op) -> "Value":
        if not isinstance(other, Value):
            other = Value.known(other)
        if self.is_none() or other.is_none():
            return Value.unknown()
        return Value.known(op(self._inner, other._inner))

    def __add__(self, other):
        return self._bin(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._bin(other, lambda a, b: a - b)

    def __mul__(self, other):
        return self._bin(other, lambda a, b: a * b)

    def __neg__(self):
        return self.map(lambda a: -a)

    def invert(self) -> "Value":
        """Deferred inversion (produces Assigned rationals)."""
        return self.map(lambda a: _to_assigned(a).invert())

    def to_field(self) -> "Value":
        return self.map(_to_assigned)

    def force_value(self):
        """Host-side extraction for tests; raises if unknown."""
        if self.is_none():
            raise SynthesisError("value is unknown")
        return self._inner

    def __repr__(self):
        return "Value::unknown()" if self.is_none() else f"Value({self._inner!r})"


_UNKNOWN = object()


def _to_assigned(v) -> Assigned:
    if isinstance(v, Assigned):
        return v
    if isinstance(v, FieldElement):
        return Assigned(v.v, 1)
    if isinstance(v, int):
        return Assigned(v, 1)
    raise TypeError(f"cannot convert {type(v)} to Assigned")


@dataclass(frozen=True)
class Cell:
    """A pointer to a cell within a region (reference circuit.rs:88-97)."""

    region_index: int
    row_offset: int
    column: Column


class AssignedCell:
    """A value together with its assigned cell (reference circuit.rs:99-176)."""

    __slots__ = ("_value", "_cell")

    def __init__(self, value: Value, cell: Cell):
        self._value = value
        self._cell = cell

    def cell(self) -> Cell:
        return self._cell

    def value(self) -> Value:
        return self._value

    def value_field(self) -> Value:
        return self._value.to_field()

    def copy_advice(self, region: "Region", column: Column, offset: int, annotation: str = "") -> "AssignedCell":
        """Assign into (column, offset) and copy-constrain to this cell."""
        out = region.assign_advice(column, offset, self._value, annotation)
        region.constrain_equal(self._cell, out.cell())
        return out


class Region:
    """User-facing region handle (reference circuit.rs:180-366)."""

    def __init__(self, layouter):
        self._layouter = layouter  # a RegionLayouter

    def enable_selector(self, selector: Selector, offset: int, annotation: str = ""):
        self._layouter.enable_selector(annotation, selector, offset)

    def name_column(self, column: Column, annotation: str = ""):
        self._layouter.name_column(annotation, column)

    def assign_advice(self, column: Column, offset: int, to, annotation: str = "") -> AssignedCell:
        to_fn = _as_value_fn(to)
        value_holder = []

        def capture():
            v = to_fn().map(_to_assigned)
            value_holder.append(v)
            return v

        cell = self._layouter.assign_advice(annotation, column, offset, capture)
        value = value_holder[0] if value_holder else Value.unknown()
        return AssignedCell(value, cell)

    def assign_advice_from_constant(
        self, column: Column, offset: int, constant, annotation: str = ""
    ) -> AssignedCell:
        c = _to_assigned(constant)
        cell = self._layouter.assign_advice_from_constant(annotation, column, offset, c)
        return AssignedCell(Value.known(c), cell)

    def assign_advice_from_instance(
        self, instance: Column, row: int, advice: Column, offset: int, annotation: str = ""
    ) -> AssignedCell:
        cell, value = self._layouter.assign_advice_from_instance(
            annotation, instance, row, advice, offset
        )
        return AssignedCell(value.map(_to_assigned), cell)

    def instance_value(self, instance: Column, row: int) -> Value:
        return self._layouter.instance_value(instance, row)

    def assign_fixed(self, column: Column, offset: int, to, annotation: str = "") -> AssignedCell:
        to_fn = _as_value_fn(to)
        value_holder = []

        def capture():
            v = to_fn().map(_to_assigned)
            value_holder.append(v)
            return v

        cell = self._layouter.assign_fixed(annotation, column, offset, capture)
        value = value_holder[0] if value_holder else Value.unknown()
        return AssignedCell(value, cell)

    def constrain_constant(self, cell: Cell, constant):
        self._layouter.constrain_constant(cell, _to_assigned(constant))

    def constrain_equal(self, left: Cell, right: Cell):
        self._layouter.constrain_equal(left, right)


class Table:
    """Lookup-table assignment handle (reference circuit.rs:370-404)."""

    def __init__(self, layouter):
        self._layouter = layouter  # a TableLayouter

    def assign_cell(self, column: TableColumn, offset: int, to, annotation: str = ""):
        to_fn = _as_value_fn(to)
        self._layouter.assign_cell(annotation, column, offset, lambda: to_fn().map(_to_assigned))


def _as_value_fn(to) -> Callable[[], Value]:
    if callable(to) and not isinstance(to, (Value, FieldElement, Assigned, int)):
        return lambda: _as_value(to())
    return lambda: _as_value(to)


def _as_value(v) -> Value:
    if isinstance(v, Value):
        return v
    return Value.known(v)


class Layouter:
    """Abstract layouter (reference circuit.rs:411-490)."""

    def assign_region(self, name: str, fn: Callable[[Region], Any]):
        raise NotImplementedError

    def assign_table(self, name: str, fn: Callable[[Table], None]):
        raise NotImplementedError

    def constrain_instance(self, cell: Cell, instance: Column, row: int):
        raise NotImplementedError

    def get_challenge(self, challenge: Challenge) -> Value:
        raise NotImplementedError

    def get_root(self):
        raise NotImplementedError

    def push_namespace(self, name: str):
        raise NotImplementedError

    def pop_namespace(self, gadget_name: Optional[str] = None):
        raise NotImplementedError

    def namespace(self, name: str) -> "NamespacedLayouter":
        self.get_root().push_namespace(name)
        return NamespacedLayouter(self.get_root())


class NamespacedLayouter(Layouter):
    """Pops its namespace when used as a context manager."""

    def __init__(self, root: Layouter):
        self._root = root

    def assign_region(self, name, fn):
        return self._root.assign_region(name, fn)

    def assign_table(self, name, fn):
        return self._root.assign_table(name, fn)

    def constrain_instance(self, cell, instance, row):
        return self._root.constrain_instance(cell, instance, row)

    def get_challenge(self, challenge):
        return self._root.get_challenge(challenge)

    def get_root(self):
        return self._root

    def push_namespace(self, name):
        raise RuntimeError("only the root's namespaces can be used")

    def pop_namespace(self, gadget_name=None):
        raise RuntimeError("only the root's namespaces can be used")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._root.pop_namespace(None)
        return False


class Chip:
    """Base chip trait (reference circuit.rs:27-48)."""

    def config(self):
        raise NotImplementedError

    def loaded(self):
        raise NotImplementedError


class Circuit:
    """User circuit interface (reference plonk/circuit.rs:752-793).

    Subclasses implement `without_witnesses`, `configure` (staticmethod or
    classmethod taking a ConstraintSystem), and `synthesize(config, layouter)`.
    """

    floor_planner = None  # default set to SimpleFloorPlanner below

    def without_witnesses(self) -> "Circuit":
        raise NotImplementedError

    def params(self):
        """circuit-params feature (circuit.rs:758-766): instance-level
        configuration value passed to `configure_with_params`. Only
        consulted when the subclass defines `configure_with_params`."""
        return None

    @classmethod
    def configure(cls, meta) -> Any:
        raise NotImplementedError

    def synthesize(self, config, layouter: Layouter):
        raise NotImplementedError
