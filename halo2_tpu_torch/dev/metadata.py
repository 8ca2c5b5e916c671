"""Metadata wrappers for failure diagnostics.

Mirrors the reference's `halo2_proofs/src/dev/metadata.rs` (313 LoC): thin
typed handles that Display exactly like the Rust ones, so MockProver
failure output carries the same information content — gate/constraint
identity, region identity with column annotations, and virtual cells.

A copy of `halo2_tpu/dev/metadata.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass(frozen=True)
class Column:
    """metadata.rs `Column` — Display `Column('Advice', 0)`."""

    kind: str  # "Advice" | "Fixed" | "Instance"
    index: int

    def __str__(self):
        return f"Column('{self.kind}', {self.index})"


@dataclass(frozen=True)
class VirtualCell:
    """metadata.rs `VirtualCell` — a column queried at a rotation."""

    column: Column
    rotation: int
    annotation: str = ""

    def __str__(self):
        name = f"{self.annotation}=" if self.annotation else ""
        return f"{name}{self.column}@{self.rotation}"


@dataclass(frozen=True)
class Gate:
    """metadata.rs `Gate` — Display `Gate 0 ('name')`."""

    index: int
    name: str

    def __str__(self):
        return f"Gate {self.index} ('{self.name}')"


@dataclass(frozen=True)
class Constraint:
    """metadata.rs `Constraint` — a polynomial within a gate."""

    gate: Gate
    index: int
    name: str

    def __str__(self):
        name = f" ('{self.name}')" if self.name else ""
        return f"Constraint {self.index}{name} in {self.gate}"


@dataclass
class Region:
    """metadata.rs `Region` — index, name, and column annotations
    (collected from `Region::name_column` calls during synthesis)."""

    index: int
    name: str
    column_annotations: Dict[Column, str] = field(default_factory=dict)

    def annotation(self, column: Column) -> Optional[str]:
        return self.column_annotations.get(column)

    def __str__(self):
        return f"Region {self.index} ('{self.name}')"
