"""Gate printer (reference `halo2_proofs/src/dev/gates.rs`).

`CircuitGates.collect(circuit_cls)` runs `configure` and renders every
custom-gate constraint as a string (S/F/A/I column notation), with totals
of negations/additions/multiplications - the reference's queried-cell
census for circuit developers.

A copy of `halo2_tpu/dev/gates.py` on the port's IR.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Type

from ..plonk.constraint_system import ConstraintSystem, configure_circuit


@dataclass
class GateInfo:
    name: str
    constraint_names: List[str]
    expressions: List[str]
    queried_selectors: List[str] = field(default_factory=list)
    queried_cells: List[str] = field(default_factory=list)


class CircuitGates:
    def __init__(self, gates: List[GateInfo], negations: int, additions: int,
                 multiplications: int):
        self.gates = gates
        self.total_negations = negations
        self.total_additions = additions
        self.total_multiplications = multiplications

    @classmethod
    def collect(cls, circuit_cls) -> "CircuitGates":
        cs = ConstraintSystem()
        configure_circuit(circuit_cls, cs)

        counts = {"neg": 0, "add": 0, "mul": 0}

        def render(expr) -> str:
            return expr.evaluate(
                constant=lambda c: f"0x{c:x}" if c > 9 else str(c),
                selector=lambda s: f"S{s.index}",
                fixed=lambda q: f"F{q.column_index}@{q.rotation.i}",
                advice=lambda q: (
                    f"A{q.column_index}@{q.rotation.i}"
                    if getattr(q, "phase", 0) == 0
                    else f"A{q.column_index}({q.phase})@{q.rotation.i}"
                ),
                instance=lambda q: f"I{q.column_index}@{q.rotation.i}",
                challenge=lambda c: f"C{c.index}({c.phase})",
                negated=lambda a: _count(counts, "neg") or f"(-{a})",
                sum_=lambda a, b: _count(counts, "add") or f"({a} + {b})",
                product=lambda a, b: _count(counts, "mul") or f"({a} * {b})",
                scaled=lambda a, f_: _count(counts, "mul") or f"{a} * 0x{f_:x}",
            )

        gates = []
        for gate in cs.gates:
            gates.append(
                GateInfo(
                    gate.name,
                    list(gate.constraint_names),
                    [render(p) for p in gate.polys],
                )
            )
        return cls(gates, counts["neg"], counts["add"], counts["mul"])

    def __str__(self) -> str:
        lines = []
        for gate in self.gates:
            lines.append(f"{gate.name}:")
            for cname, expr in zip(gate.constraint_names, gate.expressions):
                if cname:
                    lines.append(f"- {cname}:")
                lines.append(f"  {expr}")
        lines.append(f"Total gates: {len(self.gates)}")
        lines.append(
            f"Total custom constraint polynomials: {sum(len(g.expressions) for g in self.gates)}"
        )
        lines.append(f"Total negations: {self.total_negations}")
        lines.append(f"Total additions: {self.total_additions}")
        lines.append(f"Total multiplications: {self.total_multiplications}")
        return "\n".join(lines) + "\n"


def _count(counts, key):
    counts[key] += 1
    return None
