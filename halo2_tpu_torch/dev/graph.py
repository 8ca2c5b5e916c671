"""Circuit visualization tooling (reference `halo2_proofs/src/dev/graph.rs`
and `dev/graph/layout.rs`, feature `dev-graph`).

`circuit_dot_graph` renders the namespace/region tree as Graphviz DOT from a
namespace-collecting Assignment backend; `CircuitLayout.render` draws the
column/row grid with region boxes and assigned cells via matplotlib
(standing in for the reference's plotters backend).

A copy of `halo2_tpu/dev/graph.py` on the port's front-end.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..frontend import Value
from ..frontend.floor_planner import synthesize_circuit
from ..plonk.constraint_system import ConstraintSystem, configure_circuit
from ..plonk.expression import ADVICE, FIXED, INSTANCE


class _GraphBackend:
    """Assignment backend recording the namespace tree and region/cell
    layout (reference dev/graph.rs Graph + dev/graph/layout.rs)."""

    def __init__(self):
        self.nodes: List[Tuple[int, str]] = []  # (parent, name)
        self.stack: List[int] = []
        self.regions: List[dict] = []  # {name, cells: [(col_kind, col_idx, row)]}
        self._current: Optional[dict] = None

    # namespaces
    def push_namespace(self, name):
        parent = self.stack[-1] if self.stack else -1
        self.nodes.append((parent, str(name)))
        self.stack.append(len(self.nodes) - 1)

    def pop_namespace(self, gadget_name=None):
        if self.stack:
            self.stack.pop()

    # regions
    def enter_region(self, name):
        self._current = {"name": str(name), "cells": []}

    def exit_region(self):
        if self._current is not None:
            self.regions.append(self._current)
        self._current = None

    def _record(self, column, row):
        if self._current is not None:
            self._current["cells"].append((column.kind, column.index, row))

    def enable_selector(self, annotation, selector, row):
        pass

    def annotate_column(self, annotation, column):
        pass

    def query_instance(self, column, row):
        return Value.unknown()

    def assign_advice(self, annotation, column, row, to):
        self._record(column, row)

    def assign_fixed(self, annotation, column, row, to):
        self._record(column, row)

    def copy(self, *args):
        pass

    def fill_from_row(self, *args):
        pass

    def get_challenge(self, challenge):
        return Value.unknown()


def _collect(circuit) -> Tuple[ConstraintSystem, _GraphBackend]:
    cs = ConstraintSystem()
    config = configure_circuit(circuit, cs)
    backend = _GraphBackend()
    synthesize_circuit(backend, circuit.without_witnesses(), config, cs.constants)
    return cs, backend


def circuit_dot_graph(circuit) -> str:
    """Graphviz DOT of the namespace/region structure (dev/graph.rs)."""
    _, backend = _collect(circuit)
    lines = ["digraph Circuit {", '  root [label="(root)"];']
    for i, (parent, name) in enumerate(backend.nodes):
        lines.append(f'  n{i} [label="{name}"];')
        src = "root" if parent < 0 else f"n{parent}"
        lines.append(f"  {src} -> n{i};")
    for r, region in enumerate(backend.regions):
        lines.append(f'  r{r} [label="{region["name"]}", shape=box];')
        lines.append(f"  root -> r{r};")
    lines.append("}")
    return "\n".join(lines)


@dataclass
class CircuitLayout:
    """Region/cell grid renderer (dev/graph/layout.rs:42).

    `render(k, circuit, path)` writes a PNG/SVG with instance, advice, and
    fixed column bands, per-region bounding boxes, and assigned cells."""

    show_labels: bool = True

    def render(self, k: int, circuit, path: str):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.patches import Rectangle

        cs, backend = _collect(circuit)
        n = 1 << k

        # column order: instance | advice | fixed (layout.rs column layout)
        def col_x(kind, index):
            if kind == INSTANCE:
                return index
            if kind == ADVICE:
                return cs.num_instance_columns + index
            return cs.num_instance_columns + cs.num_advice_columns + index

        total_cols = (
            cs.num_instance_columns + cs.num_advice_columns + cs.num_fixed_columns
        )
        fig, ax = plt.subplots(figsize=(max(4, total_cols), 8))
        ax.add_patch(
            Rectangle((0, 0), cs.num_instance_columns, n, color="#ffffff", ec="none")
        )
        ax.add_patch(
            Rectangle(
                (cs.num_instance_columns, 0), cs.num_advice_columns, n,
                color="#fff3f3", ec="none",
            )
        )
        ax.add_patch(
            Rectangle(
                (cs.num_instance_columns + cs.num_advice_columns, 0),
                cs.num_fixed_columns, n, color="#f3f3ff", ec="none",
            )
        )

        palette = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b"]
        for r, region in enumerate(backend.regions):
            if not region["cells"]:
                continue
            xs = [col_x(kk, ii) for (kk, ii, _) in region["cells"]]
            ys = [row for (_, _, row) in region["cells"]]
            color = palette[r % len(palette)]
            ax.add_patch(
                Rectangle(
                    (min(xs), min(ys)), max(xs) - min(xs) + 1, max(ys) - min(ys) + 1,
                    fill=False, ec=color, lw=1.5,
                )
            )
            for (kk, ii, row) in region["cells"]:
                ax.add_patch(
                    Rectangle((col_x(kk, ii), row), 1, 1, color=color, alpha=0.45)
                )
            if self.show_labels:
                ax.text(min(xs), min(ys) - 0.2, region["name"], fontsize=7, color=color)

        ax.set_xlim(0, max(total_cols, 1))
        ax.set_ylim(n, 0)
        ax.set_xlabel("columns (instance | advice | fixed)")
        ax.set_ylabel("rows")
        ax.set_title(f"Circuit layout (k={k})")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
