"""Proof creation (reference `halo2_proofs/src/plonk/prover.rs:44-707`).

The strict Fiat-Shamir sequencing (commit -> squeeze -> commit) is preserved
exactly; bulk math (NTT basis changes, extended-domain constraint folding)
runs on the params' device, transcript hashing stays on the host.

Counterpart of `halo2_tpu/plonk/prover.py`, for the IPA and the KZG
schemes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..frontend import Value
from ..frontend.floor_planner import synthesize_circuit
from ..ops.grand_product import z_columns
from ..poly import LAGRANGE, FVec, Polynomial
from ..poly.commitment import Blind, ProverQuery
from . import lookup_prover, permutation_prover, vanishing
from .assigned import Assigned, batch_invert_assigned
from .constraint_system import ConstraintSystem, configure_circuit
from .error import InstanceTooLarge, InvalidInstances, NotEnoughRowsAvailable
from .evaluation import Evaluator
from .keygen import ProvingKey


class WitnessCollection:
    """Per-phase advice collector (reference prover.rs:157-299)."""

    def __init__(self, field, k: int, current_phase: int, cs: ConstraintSystem,
                 instances: List[List[int]], challenges: Dict[int, int], usable_rows: int):
        self.field = field
        self.k = k
        self.current_phase = current_phase
        self.cs = cs
        self.advice = [
            [Assigned.zero() for _ in range(1 << k)] for _ in range(cs.num_advice_columns)
        ]
        self.instances = instances
        self.challenges = challenges
        self.usable_rows = usable_rows

    def enter_region(self, name):
        pass

    def exit_region(self):
        pass

    def annotate_column(self, annotation, column):
        pass

    def enable_selector(self, annotation, selector, row):
        pass  # selectors are compressed into fixed columns at keygen

    def query_instance(self, column, row: int) -> Value:
        if row >= (1 << self.k):
            raise NotEnoughRowsAvailable(self.k)
        return Value.known(self.instances[column.index][row])

    def assign_advice(self, annotation, column, row: int, to):
        if column.phase != self.current_phase:
            return
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        v = to()
        if isinstance(v, Value) and not v.is_none():
            a = v.force_value()
            self.advice[column.index][row] = a if isinstance(a, Assigned) else Assigned(int(a))

    def assign_fixed(self, annotation, column, row, to):
        pass

    def copy(self, *args):
        pass

    def fill_from_row(self, *args):
        pass

    def get_challenge(self, challenge) -> Value:
        if challenge.index in self.challenges:
            return Value.known(self.challenges[challenge.index])
        return Value.unknown()

    def push_namespace(self, name):
        pass

    def pop_namespace(self, gadget_name=None):
        pass


def _dispatch_scheme(params, multiopen: Optional[str]):
    """(query_instance, prove_fn, verify_fn) for the params' scheme.

    IPA commits instances (ipa/multiopen/prover.rs:25); KZG hashes them as
    scalars (gwc/prover.rs:36, shplonk/prover.rs:112) and opens with
    SHPLONK unless `multiopen` names GWC."""
    from ..poly.ipa import ParamsIPA, multiopen_prove, multiopen_verify
    from ..poly.kzg import MULTIOPEN, ParamsKZG

    if isinstance(params, ParamsIPA):
        return True, multiopen_prove, multiopen_verify
    if isinstance(params, ParamsKZG):
        prove, verify = MULTIOPEN[multiopen or "shplonk"]
        return False, prove, verify
    raise NotImplementedError(f"params type {type(params).__name__} is not ported")


def create_proof(params, pk: ProvingKey, circuits: List, instances: List[List[List[int]]],
                 rng, transcript, multiopen: Optional[str] = None):
    """Writes the proof into `transcript`; returns None (proof = transcript bytes)."""
    vk = pk.vk
    cs = vk.cs
    domain = vk.domain
    curve = params.curve
    F = curve.SCALAR
    p = F.MODULUS
    n = params.n
    query_instance, multiopen_prove_fn, _ = _dispatch_scheme(params, multiopen)
    dev = params.device

    from ..utils.measure import report_totals, reset_totals, span

    reset_totals()

    for inst in instances:
        if len(inst) != cs.num_instance_columns:
            raise InvalidInstances()

    vk.hash_into(transcript)

    # ---- instances (prover.rs:94-149) ----
    stage = span("instances"); stage.__enter__()
    instance_values_all: List[List[List[int]]] = []
    instance_polys_all: List[List[Polynomial]] = []
    for inst in instances:
        values_cols = []
        for values in inst:
            if len(values) > n - (cs.blinding_factors() + 1):
                raise InstanceTooLarge()
            col = [v % p for v in values] + [0] * (n - len(values))
            if not query_instance:
                for v in values:
                    transcript.common_scalar(F(v))
            values_cols.append(col)
        if query_instance:
            for col in values_cols:
                c = params.commit_lagrange(col, Blind())
                transcript.common_point(c)
        polys = [
            domain.lagrange_to_coeff(Polynomial(LAGRANGE, FVec.from_ints(F, col, dev)))
            for col in values_cols
        ]
        instance_values_all.append(values_cols)
        instance_polys_all.append(polys)

    stage.__exit__(None, None, None)
    # ---- advice, phase by phase (prover.rs:300-426) ----
    stage = span("advice witness + commit"); stage.__enter__()
    config_cs = ConstraintSystem()
    config = configure_circuit(circuits[0], config_cs)

    advice_values_all: List[List[Optional[List[int]]]] = [
        [None] * cs.num_advice_columns for _ in circuits
    ]
    advice_fvecs_all: List[List[Optional[FVec]]] = [
        [None] * cs.num_advice_columns for _ in circuits
    ]
    advice_blinds_all: List[List[Blind]] = [
        [Blind() for _ in range(cs.num_advice_columns)] for _ in circuits
    ]
    challenges: Dict[int, int] = {}
    unusable_rows_start = n - (cs.blinding_factors() + 1)

    for current_phase in cs.phases():
        column_indices = [
            i for i, phase in enumerate(cs.advice_column_phase) if phase == current_phase
        ]
        for circuit_idx, circuit in enumerate(circuits):
            witness = WitnessCollection(
                F, params.k, current_phase, cs,
                instance_values_all[circuit_idx], challenges, unusable_rows_start,
            )
            synthesize_circuit(witness, circuit, config, cs.constants)
            cols = batch_invert_assigned(
                p, [witness.advice[i] for i in column_indices]
            )
            # blinding rows + blinds
            blinds = []
            for col in cols:
                for row in range(unusable_rows_start, n):
                    col[row] = F.random(rng).v
            for col in cols:
                blinds.append(Blind(F.random(rng).v))
            # encode each column ONCE as device Montgomery limbs; the same
            # FVec feeds the batched commit MSM, the lookup/permutation
            # device provers, and the coeff-basis NTT below
            fvecs = [FVec.from_ints(F, col, dev) for col in cols]
            # one batched bucket MSM for the whole phase
            commitments = params.commit_many(fvecs, blinds, lagrange=True) if fvecs else []
            for c in commitments:
                transcript.write_point(c)
            for idx, col, fv, blind in zip(column_indices, cols, fvecs, blinds):
                advice_values_all[circuit_idx][idx] = col
                advice_fvecs_all[circuit_idx][idx] = fv
                advice_blinds_all[circuit_idx][idx] = blind
        for index, phase in enumerate(cs.challenge_phase):
            if phase == current_phase:
                assert index not in challenges
                challenges[index] = int(transcript.squeeze_challenge())

    challenges = [challenges[i] for i in range(cs.num_challenges)]

    # device-resident Lagrange column sets, one per proof (plonk/columns.py)
    from .columns import ProofColumns

    cols_all = []
    for i in range(len(circuits)):
        pc = ProofColumns(
            F, n, advice_values_all[i], [fp.vec for fp in pk.fixed_values],
            instance_values_all[i], challenges, dev,
        )
        for idx, fv in enumerate(advice_fvecs_all[i]):
            if fv is not None:
                pc.set_advice(idx, fv)
        cols_all.append(pc)

    stage.__exit__(None, None, None)
    # ---- lookups: permuted commitments (prover.rs:429-458) ----
    stage = span("lookups + permutations commit"); stage.__enter__()
    theta = int(transcript.squeeze_challenge())
    lookups_permuted = [
        [
            lookup_prover.commit_permuted(
                argument, pk, params, domain, theta, cols_all[i], rng, transcript,
            )
            for argument in cs.lookups
        ]
        for i in range(len(circuits))
    ]

    # ---- permutations (prover.rs:467-486) ----
    beta = int(transcript.squeeze_challenge())
    gamma = int(transcript.squeeze_challenge())
    # every z column of the call at once (kernel G on the card), after the
    # rng draws of each circuit's chunks, then of each circuit's lookups
    chunks = [
        permutation_prover.permutation_chunks(params, pk, cols_all[i], beta, rng)
        for i in range(len(circuits))
    ]
    lookup_inputs = [
        [lookup_prover.product_inputs(perm, pk, params, rng) for perm in proof_lookups]
        for proof_lookups in lookups_permuted
    ]
    lookup_zs, chunk_zs, _ = z_columns(
        F, cs.blinding_factors(), beta, gamma,
        [columns for proof in lookup_inputs for columns, _ in proof],
        [proof_chunks for proof_chunks, _ in chunks],
        omega_pw=permutation_prover.omega_powers(params, pk) if cs.permutation.columns else None,
    )
    permutations = [
        permutation_prover.commit_permutation(params, pk, zs, blinds, transcript)
        for zs, (_, blinds) in zip(chunk_zs, chunks)
    ]
    lookup_zs = iter(lookup_zs)
    lookups_committed = [
        [
            lookup_prover.commit_product(perm, next(lookup_zs), blind, params, domain, transcript)
            for perm, (_, blind) in zip(proof_lookups, proof_inputs)
        ]
        for proof_lookups, proof_inputs in zip(lookups_permuted, lookup_inputs)
    ]

    vanishing_committed = vanishing.commit_random(params, domain, rng, transcript)

    y = int(transcript.squeeze_challenge())

    # advice to coeff basis (reusing the phase-commit device encodings)
    advice_polys_all = [
        [
            domain.lagrange_to_coeff(Polynomial(LAGRANGE, fv))
            for fv in advice_fvecs_all[i]
        ]
        for i in range(len(circuits))
    ]

    stage.__exit__(None, None, None)
    # ---- h(X) (prover.rs:529-548) ----
    stage = span("evaluate_h + vanishing"); stage.__enter__()
    ev = Evaluator(pk)
    h_poly = ev.evaluate_h(
        advice_polys_all, instance_polys_all, challenges,
        y, beta, gamma, theta, lookups_committed, permutations,
    )
    vanishing_constructed = vanishing.construct(
        vanishing_committed, params, domain, h_poly, rng, transcript
    )

    stage.__exit__(None, None, None)
    x = int(transcript.squeeze_challenge())
    xn = pow(x, n, p)
    stage = span("evaluations at x"); stage.__enter__()

    # batch every instance/advice/fixed query into ONE device evaluation
    # kernel (powers ladder + tree sum, ops/polyeval.py) instead of the
    # reference's per-query parallel Horner (arithmetic.rs:243-268)
    from ..ops.polyeval import batch_eval

    eval_stack = []
    eval_points = []
    if query_instance:
        for polys in instance_polys_all:
            for column, at in cs.instance_queries:
                eval_stack.append(polys[column.index].vec.vals)
                eval_points.append(domain.rotate_omega(x, at))
    for proof_idx in range(len(circuits)):
        for column, at in cs.advice_queries:
            eval_stack.append(advice_polys_all[proof_idx][column.index].vec.vals)
            eval_points.append(domain.rotate_omega(x, at))
    for column, at in cs.fixed_queries:
        eval_stack.append(pk.fixed_polys[column.index].vec.vals)
        eval_points.append(domain.rotate_omega(x, at))
    if eval_stack:
        for v in batch_eval(F, torch.stack(eval_stack), eval_points):
            transcript.write_scalar(F(v))

    vanishing_evaluated = vanishing.evaluate(vanishing_constructed, x, xn, domain, transcript)

    permutation_prover.evaluate_permutation_common(pk, x, transcript)

    permutations_evaluated = [
        permutation_prover.evaluate_permutation(perm, pk, x, transcript)
        for perm in permutations
    ]
    lookups_evaluated = [
        [lookup_prover.evaluate_lookup(lk, pk, x, transcript) for lk in proof_lookups]
        for proof_lookups in lookups_committed
    ]

    stage.__exit__(None, None, None)
    # ---- multiopen queries (prover.rs:643-695) ----
    stage = span("multiopen"); stage.__enter__()
    queries: List[ProverQuery] = []
    for proof_idx in range(len(circuits)):
        if query_instance:
            for column, at in cs.instance_queries:
                queries.append(
                    ProverQuery(
                        domain.rotate_omega(x, at),
                        instance_polys_all[proof_idx][column.index],
                        Blind(),
                    )
                )
        for column, at in cs.advice_queries:
            queries.append(
                ProverQuery(
                    domain.rotate_omega(x, at),
                    advice_polys_all[proof_idx][column.index],
                    advice_blinds_all[proof_idx][column.index],
                )
            )
        queries.extend(
            permutation_prover.open_permutation(permutations_evaluated[proof_idx], pk, x)
        )
        for lk in lookups_evaluated[proof_idx]:
            queries.extend(lookup_prover.open_lookup(lk, pk, x))
    for column, at in cs.fixed_queries:
        queries.append(
            ProverQuery(domain.rotate_omega(x, at), pk.fixed_polys[column.index], Blind())
        )
    queries.extend(permutation_prover.open_permutation_common(pk, x))
    queries.extend(vanishing.open_vanishing(vanishing_evaluated, F, x))

    multiopen_prove_fn(params, rng, transcript, queries)
    stage.__exit__(None, None, None)
    report_totals()
