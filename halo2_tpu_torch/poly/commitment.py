"""Commitment-scheme shared machinery.

Mirrors `halo2_proofs/src/poly/{commitment.rs,query.rs}`: `Blind` (default =
ONE), prover/verifier queries, and `construct_intermediate_sets` - the
query-grouping algorithm shared by the IPA and KZG multiopen protocols
(reference `poly/ipa/multiopen.rs:38-180`, same structure in SHPLONK).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..curves import Point


@dataclass
class Blind:
    """Blinding factor; defaults to ONE (reference commitment.rs Blind)."""

    value: int = 1

    def __mul__(self, other: int) -> "Blind":
        return Blind(self.value * other)

    def __add__(self, other: "Blind") -> "Blind":
        return Blind(self.value + other.value)


@dataclass
class ProverQuery:
    point: int  # evaluation point (scalar int)
    poly: Any  # Polynomial (coeff basis)
    blind: Blind


@dataclass
class VerifierQuery:
    point: int
    commitment: Any  # Point ("commitment") or MSM ("msm")
    kind: str  # "commitment" | "msm"
    eval: int

    @staticmethod
    def from_commitment(commitment: Point, point: int, eval_: int) -> "VerifierQuery":
        return VerifierQuery(point, commitment, "commitment", eval_)

    @staticmethod
    def from_msm(msm, point: int, eval_: int) -> "VerifierQuery":
        return VerifierQuery(point, msm, "msm", eval_)


@dataclass
class CommitmentData:
    commitment: Any  # opaque handle (prover: (poly,blind) pair id; verifier: point/msm)
    set_index: int
    point_indices: List[int]
    evals: List[Any]


def construct_intermediate_sets(queries: Sequence, get_point, get_commitment_key, get_eval):
    """Group queries by commitment and by point set.

    Returns (commitment_data_list, point_sets) exactly as the reference
    (ipa/multiopen.rs:63-180): point indices are assigned in sorted-point
    order (BTreeMap iteration); point sets are deduplicated in first-seen
    order of their sorted index sets... (reference uses BTreeMap on the
    ordered index set, so set indices follow the ordered-set ordering).
    """
    # point -> point_index (insertion keyed by sorted order at the end)
    point_index_map: Dict[int, int] = {}
    commitment_map: List[CommitmentData] = []
    keys: List[Any] = []

    for q in queries:
        pt = get_point(q)
        if pt not in point_index_map:
            point_index_map[pt] = len(point_index_map)
        idx = point_index_map[pt]
        key = get_commitment_key(q)
        if key in keys:
            commitment_map[keys.index(key)].point_indices.append(idx)
        else:
            keys.append(key)
            commitment_map.append(CommitmentData(key, 0, [idx], []))

    # Point indices are assigned in query order (reference uses BTreeMap's
    # entry().or_insert()); point-index *sets* get set indices in first-seen
    # commitment order. Sets themselves are ordered tuples (BTreeSet iteration).
    inverse_point_index = {v: k for k, v in point_index_map.items()}

    commitment_sets: List[Tuple[int, ...]] = [
        tuple(sorted(set(cd.point_indices))) for cd in commitment_map
    ]
    point_idx_sets: Dict[Tuple[int, ...], int] = {}
    for s in commitment_sets:
        if s not in point_idx_sets:
            point_idx_sets[s] = len(point_idx_sets)

    for cd, s in zip(commitment_map, commitment_sets):
        cd.set_index = point_idx_sets[s]
        cd.evals = [0] * len(s)

    for q in queries:
        key = get_commitment_key(q)
        i = keys.index(key)
        s = commitment_sets[i]
        pos = s.index(point_index_map[get_point(q)])
        commitment_map[i].evals[pos] = get_eval(q)

    point_sets: List[List[int]] = [[] for _ in range(len(point_idx_sets))]
    for s, set_idx in point_idx_sets.items():
        point_sets[set_idx] = [inverse_point_index[i] for i in s]

    return commitment_map, point_sets


def kate_division(coeffs: List[int], b: int, p: int) -> List[int]:
    """Divide poly by (X - b), discarding remainder
    (reference arithmetic.rs:287-306)."""
    n = len(coeffs)
    out = [0] * (n - 1)
    acc = 0
    for i in range(n - 1, 0, -1):
        acc = (coeffs[i] + acc * b) % p
        out[i - 1] = acc
    return out


def compute_inner_product(a: Sequence[int], b: Sequence[int], p: int) -> int:
    acc = 0
    for x, y in zip(a, b):
        acc += x * y
    return acc % p
