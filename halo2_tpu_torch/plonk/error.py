"""Proof-system errors (reference `halo2_proofs/src/plonk/error.rs:11-41`)."""

from __future__ import annotations


class Error(Exception):
    pass


class SynthesisError(Error):
    pass


class InvalidInstances(Error):
    pass


class ConstraintSystemFailure(Error):
    pass


class BoundsFailure(Error):
    pass


class OpeningError(Error):
    """The multi-open verification failed."""


class TranscriptIoError(Error):
    pass


class NotEnoughRowsAvailable(Error):
    def __init__(self, current_k: int):
        super().__init__(f"k = {current_k} is too small for the given circuit")
        self.current_k = current_k


class InstanceTooLarge(Error):
    pass


class NotEnoughColumnsForConstants(Error):
    pass


class ColumnNotInPermutation(Error):
    pass
