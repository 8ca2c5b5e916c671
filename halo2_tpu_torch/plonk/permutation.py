"""Copy-constraint (permutation) argument descriptor and keygen assembly.

Mirrors `halo2_proofs/src/plonk/permutation.rs` (Argument, required_degree=3)
and `permutation/keygen.rs` (cycle-merging Assembly building the sigma
polynomials as delta^i * omega^j values).
"""

from __future__ import annotations

from typing import List, Tuple, Type

from ..fields import FieldElement
from .error import ColumnNotInPermutation
from .expression import Column


class Argument:
    def __init__(self, columns: List[Column] = None):
        self.columns: List[Column] = list(columns or [])

    def required_degree(self) -> int:
        # permutation.rs:38-71: degree-3 constraints regardless of columns
        return 3

    def add_column(self, column: Column):
        if column not in self.columns:
            self.columns.append(column)

    def get_columns(self) -> List[Column]:
        return list(self.columns)


class Assembly:
    """Union of copy cycles over (column, row) cells
    (reference permutation/keygen.rs:16-103: mapping/aux/sizes arrays)."""

    def __init__(self, argument: Argument, n: int):
        self.argument = argument
        self.n = n
        cols = len(argument.columns)
        # mapping[i][j] = image of cell (i, j) under the permutation
        self.mapping = [[(i, j) for j in range(n)] for i in range(cols)]
        # aux = representative of each cycle; sizes for union-by-size
        self.aux = [[(i, j) for j in range(n)] for i in range(cols)]
        self.sizes = [[1] * n for _ in range(cols)]
        self.col_index = {c: i for i, c in enumerate(argument.columns)}

    def copy(self, left_column: Column, left_row: int, right_column: Column, right_row: int):
        try:
            lc = self.col_index[left_column]
            rc = self.col_index[right_column]
        except KeyError as e:
            raise ColumnNotInPermutation(f"{e} not enabled for equality") from e
        if not (left_row < self.n and right_row < self.n):
            from .error import BoundsFailure

            raise BoundsFailure("copy row out of bounds")
        # aux is maintained exact (every cell points at its cycle rep)
        left_cycle = self.aux[lc][left_row]
        right_cycle = self.aux[rc][right_row]
        if left_cycle == right_cycle:
            return
        if self.sizes[left_cycle[0]][left_cycle[1]] < self.sizes[right_cycle[0]][right_cycle[1]]:
            left_cycle, right_cycle = right_cycle, left_cycle
        self.sizes[left_cycle[0]][left_cycle[1]] += self.sizes[right_cycle[0]][right_cycle[1]]
        # relabel the right cycle's aux pointers to the left representative
        cur = right_cycle
        while True:
            self.aux[cur[0]][cur[1]] = left_cycle
            cur = self.mapping[cur[0]][cur[1]]
            if cur == right_cycle:
                break
        # splice cycles by swapping the mapping successors of the two
        # *joined cells* (reference keygen.rs copy())
        tmp = self.mapping[lc][left_row]
        self.mapping[lc][left_row] = self.mapping[rc][right_row]
        self.mapping[rc][right_row] = tmp

    def sigma_values(self, field: Type[FieldElement], omega: int) -> List[List[int]]:
        """sigma_i(omega^j) = delta^(c) * omega^(r) where mapping(i,j)=(c,r)
        (reference permutation/keygen.rs:105-229)."""
        p = field.MODULUS
        delta = field.DELTA
        n = self.n
        omega_powers = [1] * n
        for j in range(1, n):
            omega_powers[j] = omega_powers[j - 1] * omega % p
        out = []
        deltaomega = [list(omega_powers)]
        for _ in range(1, len(self.argument.columns)):
            deltaomega.append([v * delta % p for v in deltaomega[-1]])
        for i in range(len(self.argument.columns)):
            col = []
            for j in range(n):
                c, r = self.mapping[i][j]
                col.append(deltaomega[c][r])
            out.append(col)
        return out
