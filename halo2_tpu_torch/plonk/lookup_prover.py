"""Lookup argument prover (reference `halo2_proofs/src/plonk/lookup/prover.rs`).

commit_permuted: theta-compress input/table expressions, sort/permute the
pair (permute_expression_pair: sorted inputs; table counts via map; repeats
filled with leftovers), commit A' and S'. commit_product: grand product Z
with batch-inverted denominators. evaluate: five transcript evals.

Counterpart of `halo2_tpu/plonk/lookup_prover.py`: compression evaluates
expression ASTs over device-resident Lagrange columns (`plonk/columns.py`),
and the grand product z replaces the reference's per-row loops
(`lookup/prover.rs:168-330`) as the JAX package's one jitted program
(`_lookup_z_fn`) did: on the card it is part of kernel G's one call for
every z column of a proof (`ops/grand_product.py` `z_columns`, made by
`plonk/prover.py` from each lookup's `product_inputs`: the rows' terms, the
inversion, the prefix product and the blinding rows in two scan launches
that read the four columns in place), on the CPU its plain version. The sort/count
`permute_expression_pair` stays on the host (one readback of the two
compressed columns).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from ..ops.grand_product import LookupColumns
from ..ops.polyeval import batch_eval
from ..poly import LAGRANGE, FVec, Polynomial, Rotation
from ..poly.commitment import Blind, ProverQuery
from .columns import ProofColumns
from .error import ConstraintSystemFailure


@dataclass
class PermutedLookup:
    compressed_input: FVec
    permuted_input: FVec
    permuted_input_poly: Polynomial
    permuted_input_blind: Blind
    compressed_table: FVec
    permuted_table: FVec
    permuted_table_poly: Polynomial
    permuted_table_blind: Blind


@dataclass
class CommittedLookup:
    permuted_input_poly: Polynomial
    permuted_input_blind: Blind
    permuted_table_poly: Polynomial
    permuted_table_blind: Blind
    product_poly: Polynomial
    product_blind: Blind


def commit_permuted(
    argument,
    pk,
    params,
    domain,
    theta: int,
    cols: ProofColumns,
    rng,
    transcript,
) -> PermutedLookup:
    F = params.curve.SCALAR
    n = params.n

    def compress(expressions) -> FVec:
        acc = None
        for expr in expressions:
            vals = cols.eval_expr(expr)
            acc = vals if acc is None else acc * F(theta) + vals
        assert acc is not None
        return acc

    compressed_input = compress(argument.input_expressions)
    compressed_table = compress(argument.table_expressions)
    permuted_input, permuted_table = permute_expression_pair(
        pk, params, rng, compressed_input, compressed_table
    )

    pi_blind = Blind(F.random(rng).v)
    pt_blind = Blind(F.random(rng).v)
    pi_c, pt_c = params.commit_many(
        [permuted_input, permuted_table], [pi_blind, pt_blind],
        lagrange=True, mont=True,
    )
    pi_poly = domain.lagrange_to_coeff(Polynomial(LAGRANGE, permuted_input))
    pt_poly = domain.lagrange_to_coeff(Polynomial(LAGRANGE, permuted_table))
    transcript.write_point(pi_c)
    transcript.write_point(pt_c)
    return PermutedLookup(
        compressed_input, permuted_input, pi_poly, pi_blind,
        compressed_table, permuted_table, pt_poly, pt_blind,
    )


def permute_expression_pair(pk, params, rng, input_vec: FVec, table_vec: FVec):
    """Sort inputs; align table values (reference lookup/prover.rs:392-460).

    Host count-and-fill over ONE readback of the two compressed device
    columns; the blinded results are re-encoded once. Returns FVec pair.
    """
    F = params.curve.SCALAR
    blinding = pk.vk.cs.blinding_factors()
    usable_rows = params.n - (blinding + 1)
    input_expression = input_vec.to_ints()
    table_expression = table_vec.to_ints()

    permuted_input = sorted(input_expression[:usable_rows])
    leftover: Dict[int, int] = {}
    for v in table_expression[:usable_rows]:
        leftover[v] = leftover.get(v, 0) + 1
    permuted_table = [0] * usable_rows
    repeated_rows = []
    for row, v in enumerate(permuted_input):
        if row == 0 or v != permuted_input[row - 1]:
            permuted_table[row] = v
            if leftover.get(v, 0) > 0:
                leftover[v] -= 1
            else:
                raise ConstraintSystemFailure(f"lookup input {v} not in table")
        else:
            repeated_rows.append(row)
    # fill repeats with leftovers (BTreeMap iteration = sorted by key)
    for coeff in sorted(leftover.keys()):
        for _ in range(leftover[coeff]):
            permuted_table[repeated_rows.pop()] = coeff
    assert not repeated_rows

    permuted_input += [F.random(rng).v for _ in range(blinding + 1)]
    permuted_table += [F.random(rng).v for _ in range(blinding + 1)]
    dev = params.device
    return FVec.from_ints(F, permuted_input, dev), FVec.from_ints(F, permuted_table, dev)


def product_inputs(permuted: PermutedLookup, pk, params, rng) -> Tuple[LookupColumns, Blind]:
    """The lookup's z column as kernel G's input, and its blind: its random
    rows, then its blind, drawn from rng in the reference's order."""
    F = params.curve.SCALAR
    blinding = pk.vk.cs.blinding_factors()
    rand_rows = FVec.from_ints(F, [F.random(rng).v for _ in range(blinding)], params.device).vals
    columns = LookupColumns(permuted.compressed_input.vals, permuted.compressed_table.vals,
                            permuted.permuted_input.vals, permuted.permuted_table.vals, rand_rows)
    return columns, Blind(F.random(rng).v)


def commit_product(
    permuted: PermutedLookup, z: torch.Tensor, product_blind: Blind, params, domain, transcript
) -> CommittedLookup:
    """Commits the lookup's z column and writes the commitment to the
    transcript."""
    F = params.curve.SCALAR
    zv = FVec(F, z)
    (product_commitment,) = params.commit_many(
        [zv], [product_blind], lagrange=True, mont=True
    )
    z_poly = domain.lagrange_to_coeff(Polynomial(LAGRANGE, zv))
    transcript.write_point(product_commitment)
    return CommittedLookup(
        permuted.permuted_input_poly, permuted.permuted_input_blind,
        permuted.permuted_table_poly, permuted.permuted_table_blind,
        z_poly, product_blind,
    )


@dataclass
class EvaluatedLookup:
    constructed: CommittedLookup


def evaluate_lookup(committed: CommittedLookup, pk, x: int, transcript) -> EvaluatedLookup:
    """z/a'/s' evals at x, wx, w^-1 x in one batched device kernel
    (reference lookup/prover.rs:365-390)."""
    domain = pk.vk.domain
    F = pk.vk.curve.SCALAR
    x_inv = domain.rotate_omega(x, Rotation(-1))
    x_next = domain.rotate_omega(x, Rotation(1))
    prod = committed.product_poly.vec.vals
    pin = committed.permuted_input_poly.vec.vals
    ptab = committed.permuted_table_poly.vec.vals
    stack = torch.stack([prod, prod, pin, pin, ptab])
    for v in batch_eval(F, stack, [x, x_next, x, x_inv, x]):
        transcript.write_scalar(F(v))
    return EvaluatedLookup(committed)


def open_lookup(evaluated: EvaluatedLookup, pk, x: int) -> List[ProverQuery]:
    domain = pk.vk.domain
    x_inv = domain.rotate_omega(x, Rotation(-1))
    x_next = domain.rotate_omega(x, Rotation(1))
    c = evaluated.constructed
    return [
        ProverQuery(x, c.product_poly, c.product_blind),
        ProverQuery(x, c.permuted_input_poly, c.permuted_input_blind),
        ProverQuery(x, c.permuted_table_poly, c.permuted_table_blind),
        ProverQuery(x_inv, c.permuted_input_poly, c.permuted_input_blind),
        ProverQuery(x_next, c.product_poly, c.product_blind),
    ]
