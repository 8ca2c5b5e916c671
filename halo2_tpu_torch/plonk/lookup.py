"""Lookup argument descriptor (reference `halo2_proofs/src/plonk/lookup.rs`).

The prover/verifier halves live in `lookup_prover.py` / inside the verifier;
this module is the IR-side Argument with its degree accounting.
"""

from __future__ import annotations

from typing import List


class Argument:
    def __init__(self, name: str, input_expressions: List, table_expressions: List):
        assert len(input_expressions) == len(table_expressions)
        self.name = name
        self.input_expressions = input_expressions
        self.table_expressions = table_expressions

    def required_degree(self) -> int:
        """max(4, 2 + input_degree + table_degree) (lookup.rs:37-83)."""
        input_degree = max([e.degree() for e in self.input_expressions] + [1])
        table_degree = max([e.degree() for e in self.table_expressions] + [1])
        return max(4, 2 + input_degree + table_degree)
