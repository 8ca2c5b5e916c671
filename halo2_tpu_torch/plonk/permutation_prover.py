"""Permutation argument prover
(reference `halo2_proofs/src/plonk/permutation/prover.rs`).

Columns are chunked by (cs_degree - 2); each chunk gets a running-product z
with cross-chunk continuation via last_z; z polys are blinded, committed, and
evaluated at x, omega*x (and omega^last*x for non-final sets).

Counterpart of `halo2_tpu/plonk/permutation_prover.py`: the per-chunk grand
product (the reference's row-parallel running products,
`permutation/prover.rs:44-160`), which the JAX package jits as one program
a chunk (`_perm_z_fn`), is part of kernel G's one call for every z column of
a proof on the card (`ops/grand_product.py` `z_columns`, made by
`plonk/prover.py` from each circuit's `permutation_chunks`: the chunks'
columns and sigma columns read in place, chained by last_z on the card),
its plain version on the CPU. omega^i is a table made once per proving key
on the params' device (kernel D's `point_powers` on the card) and kept
beside the sigma columns. The only host work per chunk is the rng draws
for the blinding rows (transcript-exact ChaCha order preserved).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

from ..ops import field as fo
from ..ops.grand_product import Chunk
from ..ops.polyeval import batch_eval, point_powers
from ..poly import LAGRANGE, FVec, Polynomial, Rotation
from ..poly.commitment import Blind, ProverQuery
from .columns import ProofColumns


@dataclass
class CommittedSet:
    poly: Polynomial  # coeff basis
    blind: Blind


@dataclass
class CommittedPermutation:
    sets: List[CommittedSet]


def omega_powers(params, pk) -> torch.Tensor:
    """omega^i (n, 16) on the params' device, made once per proving key."""
    omega_pw = pk.permutation.__dict__.get("_omega_dev")
    if omega_pw is None:
        ctx = fo.FieldCtx(pk.vk.curve.SCALAR)
        omega_pw = pk.permutation._omega_dev = point_powers(ctx, pk.vk.domain.omega, params.n, params.device)
    return omega_pw


def permutation_chunks(params, pk, cols: ProofColumns, beta: int, rng) -> Tuple[List[Chunk], List[Blind]]:
    """One circuit's permutation chunks as kernel G's inputs, and their
    blinds: the columns are chunked by (cs_degree - 2), and for each chunk
    its random rows, then its blind, are drawn from rng in the reference's
    order."""
    F = pk.vk.curve.SCALAR
    p = F.MODULUS
    cs = pk.vk.cs
    assert pk.vk.cs_degree >= 3
    chunk_len = pk.vk.cs_degree - 2
    blinding = cs.blinding_factors()
    columns = cs.permutation.columns
    dev = params.device

    # device sigma columns, made once per pk (deterministic keygen data)
    sigma_dev = pk.permutation.__dict__.get("_sigma_dev")
    if sigma_dev is None:
        sigma_dev = [
            FVec.from_ints(F, s, dev).vals for s in pk.permutation.permutations
        ]
        pk.permutation._sigma_dev = sigma_dev

    chunks, blinds = [], []
    for chunk_start in range(0, len(columns), chunk_len):
        chunk_cols = columns[chunk_start : chunk_start + chunk_len]
        dpows = [beta * pow(F.DELTA, chunk_start + j, p) % p for j in range(len(chunk_cols))]
        rand_rows = FVec.from_ints(F, [F.random(rng).v for _ in range(blinding)], dev).vals
        chunks.append(Chunk([cols.column(c).vals for c in chunk_cols],
                            sigma_dev[chunk_start : chunk_start + chunk_len], dpows, rand_rows))
        blinds.append(Blind(F.random(rng).v))
    return chunks, blinds


def commit_permutation(params, pk, zs: List[torch.Tensor], blinds: List[Blind], transcript) -> CommittedPermutation:
    """Commits one circuit's chunk z columns (one batched commit) and
    writes the commitments to the transcript."""
    F = pk.vk.curve.SCALAR
    domain = pk.vk.domain
    zvs = [FVec(F, z) for z in zs]
    commitments = params.commit_many(zvs, blinds, lagrange=True, mont=True) if zvs else []
    sets = []
    for zv, blind, commitment in zip(zvs, blinds, commitments):
        z_poly = domain.lagrange_to_coeff(Polynomial(LAGRANGE, zv))
        transcript.write_point(commitment)
        sets.append(CommittedSet(z_poly, blind))
    return CommittedPermutation(sets)


def evaluate_permutation(committed: CommittedPermutation, pk, x: int, transcript):
    """z evals at x, wx (+ w^last x for continuation sets) in one batched
    device evaluation (reference permutation/prover.rs evaluate)."""
    domain = pk.vk.domain
    F = pk.vk.curve.SCALAR
    blinding = pk.vk.cs.blinding_factors()
    x_next = domain.rotate_omega(x, Rotation(1))
    x_last = domain.rotate_omega(x, Rotation(-(blinding + 1)))
    stack, points = [], []
    for i, s in enumerate(committed.sets):
        vals = s.poly.vec.vals
        stack.extend([vals, vals])
        points.extend([x, x_next])
        if i + 1 < len(committed.sets):
            stack.append(vals)
            points.append(x_last)
    if stack:
        for v in batch_eval(F, torch.stack(stack), points):
            transcript.write_scalar(F(v))
    return committed


def open_permutation(committed: CommittedPermutation, pk, x: int) -> List[ProverQuery]:
    domain = pk.vk.domain
    blinding = pk.vk.cs.blinding_factors()
    x_next = domain.rotate_omega(x, Rotation(1))
    x_last = domain.rotate_omega(x, Rotation(-(blinding + 1)))
    queries = []
    for s in committed.sets:
        queries.append(ProverQuery(x, s.poly, s.blind))
        queries.append(ProverQuery(x_next, s.poly, s.blind))
    for s in committed.sets[:-1][::-1]:
        queries.append(ProverQuery(x_last, s.poly, s.blind))
    return queries


def evaluate_permutation_common(pk, x: int, transcript) -> List[int]:
    """pk.permutation.evaluate: sigma poly evals at x (prover side),
    batched on device."""
    F = pk.vk.curve.SCALAR
    if not pk.permutation.polys:
        return []
    stack = torch.stack([poly.vec.vals for poly in pk.permutation.polys])
    evals = batch_eval(F, stack, [x] * len(pk.permutation.polys))
    for v in evals:
        transcript.write_scalar(F(v))
    return evals


def open_permutation_common(pk, x: int) -> List[ProverQuery]:
    return [ProverQuery(x, poly, Blind()) for poly in pk.permutation.polys]
