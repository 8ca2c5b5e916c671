"""Proof verification (reference `halo2_proofs/src/plonk/verifier.rs`,
`permutation/verifier.rs`, `lookup/verifier.rs`).

Transcript-driven: read commitments/evals in the prover's exact order,
recompute the expected h(x) by folding every gate/permutation/lookup
expression with y-Horner, divide by (x^n - 1), and hand all verifier queries
to the multiopen verifier under a verification strategy.

Counterpart of `halo2_tpu/plonk/verifier.py`; its MSMs run on the params'
device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..poly import Rotation
from ..poly.commitment import VerifierQuery, compute_inner_product
from . import vanishing
from .error import InstanceTooLarge, InvalidInstances, OpeningError
from .expression import ADVICE, FIXED
from .keygen import VerifyingKey


@dataclass
class PermutationEvaluatedSet:
    commitment: object
    eval: int
    next_eval: int
    last_eval: Optional[int]


@dataclass
class LookupEvaluated:
    permuted_input_commitment: object
    permuted_table_commitment: object
    product_commitment: object
    product_eval: int
    product_next_eval: int
    permuted_input_eval: int
    permuted_input_inv_eval: int
    permuted_table_eval: int


def verify_proof(params, vk: VerifyingKey, instances: List[List[List[int]]], transcript,
                 strategy: str = "single", multiopen: str = None):
    """Returns the accumulated MSM guard result; raises on failure."""
    from .prover import _dispatch_scheme

    cs = vk.cs
    domain = vk.domain
    curve = params.curve
    F = curve.SCALAR
    p = F.MODULUS
    n = params.n
    query_instance, _, multiopen_verify_fn = _dispatch_scheme(params, multiopen)

    for inst in instances:
        if len(inst) != cs.num_instance_columns:
            raise InvalidInstances()

    num_proofs = len(instances)

    instance_commitments = []
    if query_instance:
        from ..poly.commitment import Blind

        for inst in instances:
            cols = []
            for values in inst:
                if len(values) > n - (cs.blinding_factors() + 1):
                    raise InstanceTooLarge()
                col = [v % p for v in values] + [0] * (n - len(values))
                cols.append(params.commit_lagrange(col, Blind()))
            instance_commitments.append(cols)
    else:
        instance_commitments = [[] for _ in instances]

    vk.hash_into(transcript)

    if query_instance:
        for cols in instance_commitments:
            for c in cols:
                transcript.common_point(c)
    else:
        for inst in instances:
            for values in inst:
                for v in values:
                    transcript.common_scalar(F(v))

    # advice commitments + phase challenges
    advice_commitments = [[None] * cs.num_advice_columns for _ in range(num_proofs)]
    challenges = [0] * cs.num_challenges
    for current_phase in cs.phases():
        for proof_idx in range(num_proofs):
            for col_idx, phase in enumerate(cs.advice_column_phase):
                if phase == current_phase:
                    advice_commitments[proof_idx][col_idx] = transcript.read_point()
        for idx, phase in enumerate(cs.challenge_phase):
            if phase == current_phase:
                challenges[idx] = int(transcript.squeeze_challenge())

    theta = int(transcript.squeeze_challenge())

    # lookups: permuted commitments
    lookups_permuted = [
        [(transcript.read_point(), transcript.read_point()) for _ in cs.lookups]
        for _ in range(num_proofs)
    ]

    beta = int(transcript.squeeze_challenge())
    gamma = int(transcript.squeeze_challenge())

    # permutation product commitments (chunked)
    chunk_len = vk.cs_degree - 2
    num_sets = (len(cs.permutation.columns) + chunk_len - 1) // chunk_len
    permutations_committed = [
        [transcript.read_point() for _ in range(num_sets)] for _ in range(num_proofs)
    ]

    lookups_committed = [
        [(pi, pt, transcript.read_point()) for (pi, pt) in proof_lookups]
        for proof_lookups in lookups_permuted
    ]

    vanishing_committed = vanishing.read_commitments_before_y(transcript)
    y = int(transcript.squeeze_challenge())
    vanishing_constructed = vanishing.read_commitments_after_y(vanishing_committed, vk, transcript)

    x = int(transcript.squeeze_challenge())
    xn = pow(x, n, p)

    if query_instance:
        instance_evals = [
            [int(transcript.read_scalar()) for _ in cs.instance_queries]
            for _ in range(num_proofs)
        ]
    else:
        min_rot = min([r.i for _, r in cs.instance_queries] + [0])
        max_rot = max([r.i for _, r in cs.instance_queries] + [0])
        max_len = max((len(v) for inst in instances for v in inst), default=0)
        l_i_s = domain.l_i_range(x, xn, range(-max_rot, max_len + abs(min_rot)))
        instance_evals = []
        for inst in instances:
            evals = []
            for column, rotation in cs.instance_queries:
                values = inst[column.index]
                offset = max_rot - rotation.i
                evals.append(
                    compute_inner_product(values, l_i_s[offset : offset + len(values)], p)
                )
            instance_evals.append(evals)

    advice_evals = [
        [int(transcript.read_scalar()) for _ in cs.advice_queries]
        for _ in range(num_proofs)
    ]
    fixed_evals = [int(transcript.read_scalar()) for _ in cs.fixed_queries]

    vanishing_partial = vanishing.evaluate_after_x(vanishing_constructed, transcript)

    permutations_common = [int(transcript.read_scalar()) for _ in vk.permutation.commitments]

    permutations_evaluated = []
    for proof_idx in range(num_proofs):
        sets = []
        coms = permutations_committed[proof_idx]
        for i, com in enumerate(coms):
            ev = int(transcript.read_scalar())
            nxt = int(transcript.read_scalar())
            last = int(transcript.read_scalar()) if i + 1 < len(coms) else None
            sets.append(PermutationEvaluatedSet(com, ev, nxt, last))
        permutations_evaluated.append(sets)

    lookups_evaluated = []
    for proof_lookups in lookups_committed:
        evs = []
        for (pi, pt, prod) in proof_lookups:
            product_eval = int(transcript.read_scalar())
            product_next_eval = int(transcript.read_scalar())
            permuted_input_eval = int(transcript.read_scalar())
            permuted_input_inv_eval = int(transcript.read_scalar())
            permuted_table_eval = int(transcript.read_scalar())
            evs.append(
                LookupEvaluated(
                    pi, pt, prod, product_eval, product_next_eval,
                    permuted_input_eval, permuted_input_inv_eval, permuted_table_eval,
                )
            )
        lookups_evaluated.append(evs)

    # ---- expected h(x) ----
    blinding = cs.blinding_factors()
    l_evals = domain.l_i_range(x, xn, range(-(blinding + 1), 1))
    assert len(l_evals) == 2 + blinding
    l_last = l_evals[0]
    l_blind = sum(l_evals[1 : 1 + blinding]) % p
    l_0 = l_evals[1 + blinding]

    expressions: List[int] = []
    for proof_idx in range(num_proofs):
        ae = advice_evals[proof_idx]
        ie = instance_evals[proof_idx]

        def eval_expr(expr) -> int:
            return expr.evaluate(
                constant=lambda c: c % p,
                selector=lambda s: (_ for _ in ()).throw(
                    ValueError("virtual selectors are removed during optimization")
                ),
                fixed=lambda q: fixed_evals[q.query_index],
                advice=lambda q: ae[q.query_index],
                instance=lambda q: ie[q.query_index],
                challenge=lambda c: challenges[c.index],
                negated=lambda a: (-a) % p,
                sum_=lambda a, b: (a + b) % p,
                product=lambda a, b: (a * b) % p,
                scaled=lambda a, f: (a * f) % p,
            )

        for gate in cs.gates:
            for poly in gate.polys:
                expressions.append(eval_expr(poly))

        # permutation expressions (permutation/verifier.rs:115-196)
        sets = permutations_evaluated[proof_idx]
        if sets:
            expressions.append(l_0 * (1 - sets[0].eval) % p)
            expressions.append(
                (sets[-1].eval * sets[-1].eval - sets[-1].eval) % p * l_last % p
            )
            for i in range(1, len(sets)):
                expressions.append((sets[i].eval - sets[i - 1].last_eval) % p * l_0 % p)
            columns = cs.permutation.columns
            for chunk_index, s in enumerate(sets):
                cols = columns[chunk_index * chunk_len : (chunk_index + 1) * chunk_len]
                perm_evals = permutations_common[
                    chunk_index * chunk_len : (chunk_index + 1) * chunk_len
                ]
                left = s.next_eval
                for column, perm_eval in zip(cols, perm_evals):
                    ev = _any_eval(vk, column, ae, fixed_evals, ie)
                    left = left * ((ev + beta * perm_eval + gamma) % p) % p
                right = s.eval
                current_delta = beta * x % p * pow(
                    F.DELTA, chunk_index * chunk_len, p
                ) % p
                for column in cols:
                    ev = _any_eval(vk, column, ae, fixed_evals, ie)
                    right = right * ((ev + current_delta + gamma) % p) % p
                    current_delta = current_delta * F.DELTA % p
                expressions.append((left - right) * (1 - (l_last + l_blind)) % p)

        # lookup expressions (lookup/verifier.rs:95-167)
        active_rows = (1 - (l_last + l_blind)) % p
        for lk, argument in zip(lookups_evaluated[proof_idx], cs.lookups):
            expressions.append(l_0 * (1 - lk.product_eval) % p)
            expressions.append(
                l_last * ((lk.product_eval * lk.product_eval - lk.product_eval) % p) % p
            )
            left = (
                lk.product_next_eval
                * ((lk.permuted_input_eval + beta) % p)
                % p
                * ((lk.permuted_table_eval + gamma) % p)
                % p
            )

            def compress(exprs):
                acc = 0
                for e in exprs:
                    acc = (acc * theta + eval_expr(e)) % p
                return acc

            right = (
                lk.product_eval
                * ((compress(argument.input_expressions) + beta) % p)
                % p
                * ((compress(argument.table_expressions) + gamma) % p)
                % p
            )
            expressions.append((left - right) * active_rows % p)
            expressions.append(
                l_0 * (lk.permuted_input_eval - lk.permuted_table_eval) % p
            )
            expressions.append(
                (lk.permuted_input_eval - lk.permuted_table_eval)
                * (lk.permuted_input_eval - lk.permuted_input_inv_eval)
                % p
                * active_rows
                % p
            )

    vanishing_evaluated = vanishing.verify(vanishing_partial, params, expressions, y, xn)

    # ---- verifier queries ----
    queries: List[VerifierQuery] = []
    x_next = domain.rotate_omega(x, Rotation(1))
    x_last = domain.rotate_omega(x, Rotation(-(blinding + 1)))
    x_inv = domain.rotate_omega(x, Rotation(-1))
    for proof_idx in range(num_proofs):
        if query_instance:
            for qi, (column, at) in enumerate(cs.instance_queries):
                queries.append(
                    VerifierQuery.from_commitment(
                        instance_commitments[proof_idx][column.index],
                        domain.rotate_omega(x, at),
                        instance_evals[proof_idx][qi],
                    )
                )
        for qi, (column, at) in enumerate(cs.advice_queries):
            queries.append(
                VerifierQuery.from_commitment(
                    advice_commitments[proof_idx][column.index],
                    domain.rotate_omega(x, at),
                    advice_evals[proof_idx][qi],
                )
            )
        sets = permutations_evaluated[proof_idx]
        for s in sets:
            queries.append(VerifierQuery.from_commitment(s.commitment, x, s.eval))
            queries.append(VerifierQuery.from_commitment(s.commitment, x_next, s.next_eval))
        for s in sets[:-1][::-1]:
            queries.append(VerifierQuery.from_commitment(s.commitment, x_last, s.last_eval))
        for lk in lookups_evaluated[proof_idx]:
            queries.append(VerifierQuery.from_commitment(lk.product_commitment, x, lk.product_eval))
            queries.append(
                VerifierQuery.from_commitment(lk.permuted_input_commitment, x, lk.permuted_input_eval)
            )
            queries.append(
                VerifierQuery.from_commitment(lk.permuted_table_commitment, x, lk.permuted_table_eval)
            )
            queries.append(
                VerifierQuery.from_commitment(
                    lk.permuted_input_commitment, x_inv, lk.permuted_input_inv_eval
                )
            )
            queries.append(
                VerifierQuery.from_commitment(lk.product_commitment, x_next, lk.product_next_eval)
            )
    for qi, (column, at) in enumerate(cs.fixed_queries):
        queries.append(
            VerifierQuery.from_commitment(
                vk.fixed_commitments[column.index], domain.rotate_omega(x, at), fixed_evals[qi]
            )
        )
    for commitment, ev in zip(vk.permutation.commitments, permutations_common):
        queries.append(VerifierQuery.from_commitment(commitment, x, ev))
    queries.extend(vanishing.verifier_queries(vanishing_evaluated, x))

    # ---- multiopen verification under strategy ----
    msm = params.accumulator() if hasattr(params, "accumulator") else params.empty_msm()
    guard = multiopen_verify_fn(params, transcript, queries, msm)
    if strategy == "single":
        final = guard.use_challenges()
        if not final.check():
            raise OpeningError("proof MSM check failed")
        return True
    return guard


def _any_eval(vk, column, advice_evals, fixed_evals, instance_evals) -> int:
    idx = vk.cs.get_any_query_index(column, Rotation(0))
    if column.kind == ADVICE:
        return advice_evals[idx]
    if column.kind == FIXED:
        return fixed_evals[idx]
    return instance_evals[idx]
