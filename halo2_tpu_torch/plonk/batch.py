"""Batch proof verification for the IPA scheme
(reference `halo2_proofs/src/plonk/verifier/batch.rs`, feature `batch`).

Each proof's accumulated MSM (the GuardIPA with challenges folded in) is
randomly scaled and summed into one final MSM, checked with a single
multiexp: the g-scalar vectors of all proofs add into one vector, so the
batch costs one device MSM over the params' bases (`ops/msm.py` `msm`).

A copy of `halo2_tpu/plonk/batch.py` over the port's verifier.
"""

from __future__ import annotations

from typing import List, Tuple

from ..transcript import Blake2bRead, TranscriptError
from .error import Error as PlonkError
from .verifier import verify_proof


class BatchVerifier:
    """Accumulates (instances, proof) items; `finalize` checks them all."""

    def __init__(self):
        self.items: List[Tuple[list, bytes]] = []

    def add_proof(self, instances: List[List[List[int]]], proof: bytes):
        self.items.append((instances, proof))

    def finalize(self, params, vk, rng) -> bool:
        """Returns False if *some* proof was invalid (batch.rs:92-137)."""
        from ..poly.ipa import ParamsIPA

        assert isinstance(params, ParamsIPA), "BatchVerifier is IPA-only"
        F = params.curve.SCALAR
        acc = params.empty_msm()
        for instances, proof in self.items:
            transcript = Blake2bRead(params.curve, proof)
            try:
                guard = verify_proof(params, vk, instances, transcript, strategy="batch")
            except (TranscriptError, PlonkError):
                # malformed/invalid proof bytes -> batch is invalid
                # (batch.rs:107-118 logs and returns false); framework bugs
                # (TypeError, ValueError, ...) propagate instead of being
                # silently reported as "proof invalid".
                return False
            msm = guard.use_challenges()
            acc.scale(F.random(rng).v)
            acc.add_msm(msm)
        return acc.check()
