"""Permutation argument prover
(reference `halo2_proofs/src/plonk/permutation/prover.rs`).

Columns are chunked by (cs_degree - 2); each chunk gets a running-product z
with cross-chunk continuation via last_z; z polys are blinded, committed, and
evaluated at x, omega*x (and omega^last*x for non-final sets).

Counterpart of `halo2_tpu/plonk/permutation_prover.py`: the per-chunk grand
product (the reference's row-parallel running products,
`permutation/prover.rs:44-160`) is tensor code on the params' device:
fraction products, Montgomery-trick batch inversion and a log-depth prefix
product (`ops/scan.py`). The only host work per chunk is the rng draws for
the blinding rows (transcript-exact ChaCha order preserved).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from ..ops import field as fo
from ..ops.polyeval import batch_eval
from ..ops.ntt import powers
from ..ops.scan import batch_invert, exclusive_prefix_product
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


def _perm_z(field, blinding: int, cols, sigmas, omega_pw, beta_c, gamma_c, dpows, init,
            rand_rows):
    """One permutation chunk's blinded z column.

    cols/sigmas (ncols, n, 16) mont; omega_pw (n, 16); dpows (ncols, 16)
    holding beta*delta^(chunk_base+j); beta_c/gamma_c (16,); init (16,) =
    last_z; rand_rows (blinding, 16). Returns (z (n,16), last_z (16,)).
    """
    ctx = fo.FieldCtx(field)
    n = cols.shape[1]
    # denominator product: prod_j (v_j + beta*sigma_j + gamma)
    modified = None
    for j in range(cols.shape[0]):
        term = fo.add_mod(fo.add_mod(cols[j], fo.mont_mul(sigmas[j], beta_c, ctx), ctx),
                          gamma_c, ctx)
        modified = term if modified is None else fo.mont_mul(modified, term, ctx)
    modified = batch_invert(modified, ctx)
    # numerator product: prod_j (v_j + beta*delta^(base+j)*omega^i + gamma)
    for j in range(cols.shape[0]):
        term = fo.add_mod(fo.add_mod(cols[j], fo.mont_mul(omega_pw, dpows[j], ctx), ctx),
                          gamma_c, ctx)
        modified = fo.mont_mul(modified, term, ctx)
    z = exclusive_prefix_product(modified, ctx, init=init)
    last_z = z[n - (blinding + 1)]
    z = torch.cat([z[: n - blinding], rand_rows], dim=0)
    return z, last_z


def commit_permutation(
    params,
    pk,
    cols: ProofColumns,
    beta: int,
    gamma: int,
    rng,
    transcript,
) -> CommittedPermutation:
    domain = pk.vk.domain
    F = pk.vk.curve.SCALAR
    p = F.MODULUS
    n = params.n
    cs = pk.vk.cs
    assert pk.vk.cs_degree >= 3
    chunk_len = pk.vk.cs_degree - 2
    blinding = cs.blinding_factors()
    columns = cs.permutation.columns
    delta = F.DELTA
    ctx = fo.FieldCtx(F)
    dev = params.device

    # device sigma columns, uploaded once per pk (deterministic keygen data)
    sigma_dev = pk.permutation.__dict__.get("_sigma_dev")
    if sigma_dev is None:
        sigma_dev = [
            FVec.from_ints(F, s, dev).vals for s in pk.permutation.permutations
        ]
        pk.permutation._sigma_dev = sigma_dev
    omega_pw = powers(domain.omega, n, ctx, dev)

    last_z_dev = ctx.const(1, dev)
    sets = []
    chunks = []  # defer transcript writes until all commits are launched
    for chunk_start in range(0, len(columns), chunk_len):
        chunk_cols = columns[chunk_start : chunk_start + chunk_len]
        col_stack = torch.stack([cols.column(c).vals for c in chunk_cols])
        sig_stack = torch.stack(sigma_dev[chunk_start : chunk_start + chunk_len])
        dpows = ctx.consts(
            [beta * pow(delta, chunk_start + j, p) % p for j in range(len(chunk_cols))], dev
        )
        rand_rows = FVec.from_ints(F, [F.random(rng).v for _ in range(blinding)], dev).vals
        z, last_z_dev = _perm_z(
            F, blinding, col_stack, sig_stack, omega_pw, ctx.const(beta, dev),
            ctx.const(gamma, dev), dpows, last_z_dev, rand_rows,
        )
        blind = Blind(F.random(rng).v)
        chunks.append((FVec(F, z), blind))

    commitments = params.commit_many(
        [zv for zv, _ in chunks], [b for _, b in chunks], lagrange=True, mont=True
    ) if chunks else []
    for (zv, blind), commitment in zip(chunks, commitments):
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
