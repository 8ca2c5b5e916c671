"""Vanishing argument (reference `halo2_proofs/src/plonk/vanishing/`).

Prover: commit a random blinder polynomial (per-chunk ChaCha20 seeding like
vanishing/prover.rs:39-88); after h(X): divide by t(X), iFFT, split into
n-sized pieces, commit each; collapse pieces by x^n Horner for the opening.
Verifier: reconstruct expected h(x) = sum y^i expr_i / (x^n - 1).

Counterpart of `halo2_tpu/plonk/vanishing.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from ..ops.polyeval import horner_fold_mont
from ..poly import COEFF, FVec, Polynomial, eval_polynomial_host
from ..poly.commitment import Blind, ProverQuery, VerifierQuery
from ..utils.chacha import ChaCha20Rng
from ..utils.measure import span


@dataclass
class Committed:
    random_poly: List[int]  # coeff ints
    random_blind: Blind


@dataclass
class Constructed:
    h_pieces: List[Polynomial]
    h_blinds: List[Blind]
    committed: Committed


@dataclass
class Evaluated:
    h_poly: Polynomial
    h_blind: int
    committed: Committed


def commit_random(params, domain, rng, transcript) -> Committed:
    """Random degree n-1 polynomial (ChaCha20 per-chunk as the reference;
    with one chunk the stream matches a single ChaCha20Rng)."""
    F = params.curve.SCALAR
    n = params.n
    seed = rng.fill_bytes(32) if hasattr(rng, "fill_bytes") else bytes(32)
    sub = ChaCha20Rng(seed)
    with span("vanishing: random draw"):
        rand_vec = [F.random(sub).v for _ in range(n)]
    random_blind = Blind(F.random(rng).v)
    c = params.commit(rand_vec, random_blind)
    transcript.write_point(c)
    return Committed(rand_vec, random_blind)


def construct(committed: Committed, params, domain, h_poly: Polynomial, rng, transcript) -> Constructed:
    F = params.curve.SCALAR
    h_poly = domain.divide_by_vanishing_poly(h_poly)
    h_coeffs = domain.extended_to_coeff(h_poly)  # FVec, len n*quotient_degree
    n = params.n
    # split into n-sized pieces as device slices (no host round trip)
    pieces = [
        Polynomial(COEFF, h_coeffs.slice(i, i + n))
        for i in range(0, len(h_coeffs), n)
    ]
    blinds = [Blind(F.random(rng).v) for _ in pieces]
    # one batched device MSM for all pieces (prover.rs:92-144's per-piece
    # commits; group elements identical)
    commitments = params.commit_many(
        torch.stack([piece.vec.vals for piece in pieces]), blinds, lagrange=False
    )
    for c in commitments:
        transcript.write_point(c)
    return Constructed(pieces, blinds, committed)


def evaluate(constructed: Constructed, x: int, xn: int, domain, transcript) -> Evaluated:
    """Collapse h pieces by x^n Horner on device (reference
    vanishing/prover.rs:147-174): on the card one launch of kernel H, which
    reads the pieces in place, the last one first."""
    F = domain.field
    p = F.MODULUS
    pieces = [piece.vec.vals for piece in reversed(constructed.h_pieces)]
    h_poly = Polynomial(COEFF, FVec(F, horner_fold_mont(F, pieces, xn)))
    h_blind = 0
    for blind in reversed(constructed.h_blinds):
        h_blind = (h_blind * xn + blind.value) % p

    random_eval = eval_polynomial_host(constructed.committed.random_poly, x, p)
    transcript.write_scalar(F(random_eval))
    return Evaluated(h_poly, h_blind, constructed.committed)


def open_vanishing(evaluated: Evaluated, field, x: int) -> List[ProverQuery]:
    return [
        ProverQuery(x, evaluated.h_poly, Blind(evaluated.h_blind)),
        ProverQuery(x, evaluated.committed.random_poly, evaluated.committed.random_blind),
    ]


# ---------------------------------------------------------------------------
# Verifier half (vanishing/verifier.rs)
# ---------------------------------------------------------------------------


@dataclass
class VerifierCommitted:
    random_poly_commitment: object


@dataclass
class VerifierConstructed:
    random_poly_commitment: object
    h_commitments: List[object]


@dataclass
class VerifierPartiallyEvaluated:
    random_poly_commitment: object
    h_commitments: List[object]
    random_eval: int


@dataclass
class VerifierEvaluated:
    expected_h_eval: int
    h_commitment: object  # MSM
    random_poly_commitment: object
    random_eval: int


def read_commitments_before_y(transcript) -> VerifierCommitted:
    return VerifierCommitted(transcript.read_point())


def read_commitments_after_y(committed: VerifierCommitted, vk, transcript) -> VerifierConstructed:
    h_commitments = [
        transcript.read_point() for _ in range(vk.domain.get_quotient_poly_degree())
    ]
    return VerifierConstructed(committed.random_poly_commitment, h_commitments)


def evaluate_after_x(constructed: VerifierConstructed, transcript) -> VerifierPartiallyEvaluated:
    return VerifierPartiallyEvaluated(
        constructed.random_poly_commitment,
        constructed.h_commitments,
        int(transcript.read_scalar()),
    )


def verify(
    partial: VerifierPartiallyEvaluated, params, expressions: List[int], y: int, xn: int
) -> VerifierEvaluated:
    q = params.curve.SCALAR.MODULUS
    expected = 0
    for v in expressions:
        expected = (expected * y + v) % q
    expected = expected * pow((xn - 1) % q, -1, q) % q

    h_commitment = params.empty_msm()
    for commitment in reversed(partial.h_commitments):
        h_commitment.scale(xn)
        h_commitment.append_term(1, commitment)
    return VerifierEvaluated(
        expected, h_commitment, partial.random_poly_commitment, partial.random_eval
    )


def verifier_queries(evaluated: VerifierEvaluated, x: int) -> List[VerifierQuery]:
    return [
        VerifierQuery.from_msm(evaluated.h_commitment, x, evaluated.expected_h_eval),
        VerifierQuery.from_commitment(evaluated.random_poly_commitment, x, evaluated.random_eval),
    ]
