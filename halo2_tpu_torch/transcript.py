"""Fiat-Shamir transcripts, byte-exact with the reference.

Implements the Blake2b transcript (personalization "Halo2-Transcript",
64-byte digests) and the EVM-compatible Keccak256 transcript with the
lo/hi split challenge squeeze, including the domain-separation prefixes
CHALLENGE=0 / POINT=1 / SCALAR=2 and the "growing state" design where
squeezes clone the running hash state.

Reference: `halo2_proofs/src/transcript.rs` (prefixes :14-38, Blake2b init
:123-133, squeeze :219-225/:392-397, Keccak lo/hi squeeze :252-275,
Challenge255 via from_uniform_bytes :486-519).

The transcript is the proof serialization boundary: `write_point` emits the
compressed encoding to the proof while absorbing the *uncompressed* affine
coordinates into the hash state; `write_scalar` emits/absorbs the 32-byte
canonical repr. Points at infinity cannot be absorbed (same error as the
reference).
"""

from __future__ import annotations

import hashlib
import io
from typing import Type

from .curves import Curve, Point
from .fields import FieldElement
from .utils.keccak import Keccak256

BLAKE2B_PREFIX_CHALLENGE = b"\x00"
BLAKE2B_PREFIX_POINT = b"\x01"
BLAKE2B_PREFIX_SCALAR = b"\x02"

KECCAK256_PREFIX_CHALLENGE = b"\x00"
KECCAK256_PREFIX_CHALLENGE_LO = b"\x0a"
KECCAK256_PREFIX_CHALLENGE_HI = b"\x0b"
KECCAK256_PREFIX_POINT = b"\x01"
KECCAK256_PREFIX_SCALAR = b"\x02"


class TranscriptError(Exception):
    pass


def challenge255(curve: Type[Curve], raw64: bytes) -> FieldElement:
    """Challenge255::new - reduce 64 uniform bytes into the scalar field."""
    return curve.SCALAR.from_uniform_bytes(raw64)


class _Blake2bState:
    def __init__(self):
        self._h = hashlib.blake2b(digest_size=64, person=b"Halo2-Transcript")

    def update(self, data: bytes):
        self._h.update(data)

    def finalize_cloned(self) -> bytes:
        return self._h.copy().digest()


class _KeccakState:
    def __init__(self):
        self._h = Keccak256()
        self._h.update(b"Halo2-Transcript")

    def update(self, data: bytes):
        self._h.update(data)

    def squeeze_lo_hi(self) -> bytes:
        lo = self._h.copy().update(KECCAK256_PREFIX_CHALLENGE_LO).digest()
        hi = self._h.copy().update(KECCAK256_PREFIX_CHALLENGE_HI).digest()
        return lo + hi


class _TranscriptBase:
    """Common absorb/squeeze logic over a hash state."""

    def __init__(self, curve: Type[Curve]):
        self.curve = curve

    # -- hashing primitives, specialized per hash --
    def _absorb(self, data: bytes):
        raise NotImplementedError

    def _squeeze64(self) -> bytes:
        raise NotImplementedError

    def _prefix(self, kind: str) -> bytes:
        raise NotImplementedError

    # -- Transcript trait --
    def squeeze_challenge(self) -> FieldElement:
        self._absorb(self._prefix("challenge"))
        return challenge255(self.curve, self._squeeze64())

    # squeeze_challenge_scalar is identical at the value level
    squeeze_challenge_scalar = squeeze_challenge

    def common_point(self, point: Point):
        self._absorb(self._prefix("point"))
        if point.is_identity():
            raise TranscriptError("cannot write points at infinity to the transcript")
        self._absorb(point.x.to_repr())
        self._absorb(point.y.to_repr())

    def common_scalar(self, scalar: FieldElement):
        self._absorb(self._prefix("scalar"))
        self._absorb(scalar.to_repr())


class _Blake2bMixin:
    def _mk_state(self):
        self._state = _Blake2bState()

    def _absorb(self, data: bytes):
        self._state.update(data)

    def _squeeze64(self) -> bytes:
        self._state.update(b"")  # no-op; prefix already absorbed
        return self._state.finalize_cloned()

    def _prefix(self, kind: str) -> bytes:
        return {
            "challenge": BLAKE2B_PREFIX_CHALLENGE,
            "point": BLAKE2B_PREFIX_POINT,
            "scalar": BLAKE2B_PREFIX_SCALAR,
        }[kind]


class _KeccakMixin:
    def _mk_state(self):
        self._state = _KeccakState()

    def _absorb(self, data: bytes):
        self._state.update(data)

    def _squeeze64(self) -> bytes:
        return self._state.squeeze_lo_hi()

    def _prefix(self, kind: str) -> bytes:
        return {
            "challenge": KECCAK256_PREFIX_CHALLENGE,
            "point": KECCAK256_PREFIX_POINT,
            "scalar": KECCAK256_PREFIX_SCALAR,
        }[kind]


class _WriteMixin:
    """Prover side: writes to an in-memory proof buffer."""

    def _mk_writer(self):
        self._writer = io.BytesIO()

    def write_point(self, point: Point):
        self.common_point(point)
        self._writer.write(point.to_bytes())

    def write_scalar(self, scalar: FieldElement):
        self.common_scalar(scalar)
        self._writer.write(scalar.to_repr())

    def finalize(self) -> bytes:
        return self._writer.getvalue()


class _ReadMixin:
    """Verifier side: reads from the proof byte stream."""

    def _mk_reader(self, data: bytes):
        self._reader = io.BytesIO(data)

    def read_point(self) -> Point:
        b = self._reader.read(32)
        if len(b) != 32:
            raise TranscriptError("unexpected end of proof")
        try:
            point = self.curve.from_bytes(b)
        except ValueError as e:
            raise TranscriptError(f"invalid point encoding in proof: {e}") from e
        self.common_point(point)
        return point

    def read_scalar(self) -> FieldElement:
        b = self._reader.read(32)
        if len(b) != 32:
            raise TranscriptError("unexpected end of proof")
        try:
            scalar = self.curve.SCALAR.from_repr(b)
        except ValueError as e:
            raise TranscriptError(f"invalid field element encoding in proof: {e}") from e
        self.common_scalar(scalar)
        return scalar

    def read_n_points(self, n: int):
        return [self.read_point() for _ in range(n)]

    def read_n_scalars(self, n: int):
        return [self.read_scalar() for _ in range(n)]


class Blake2bWrite(_Blake2bMixin, _WriteMixin, _TranscriptBase):
    def __init__(self, curve: Type[Curve]):
        super().__init__(curve)
        self._mk_state()
        self._mk_writer()


class Blake2bRead(_Blake2bMixin, _ReadMixin, _TranscriptBase):
    def __init__(self, curve: Type[Curve], proof: bytes):
        super().__init__(curve)
        self._mk_state()
        self._mk_reader(proof)


class Keccak256Write(_KeccakMixin, _WriteMixin, _TranscriptBase):
    def __init__(self, curve: Type[Curve]):
        super().__init__(curve)
        self._mk_state()
        self._mk_writer()


class Keccak256Read(_KeccakMixin, _ReadMixin, _TranscriptBase):
    def __init__(self, curve: Type[Curve], proof: bytes):
        super().__init__(curve)
        self._mk_state()
        self._mk_reader(proof)
