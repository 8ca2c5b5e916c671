"""Keccak-256 (original Keccak padding 0x01, as used by Ethereum and the
Rust `sha3::Keccak256` type that the reference's EVM-compatible transcript
relies on - reference `halo2_proofs/src/transcript.rs:4,111,301`).

Note this is *not* SHA3-256 (which pads with 0x06); Python's hashlib only
ships the SHA3 variants, so the sponge is implemented here. Host-side only:
transcript hashing is a serial byte-stream state machine (SURVEY.md "hard
parts" #4) and never belongs on the TPU.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1

_ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

# rotation offsets r[x][y]
_ROTATIONS = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)


def _rotl(v: int, n: int) -> int:
    n &= 63
    return ((v << n) | (v >> (64 - n))) & _MASK


def keccak_f1600(state: list) -> None:
    """In-place Keccak-f[1600] permutation over 25 lanes (x + 5*y order)."""
    a = state
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            dx = d[x]
            for y in range(0, 25, 5):
                a[x + y] ^= dx
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], _ROTATIONS[x][y])
        # chi
        for y in range(0, 25, 5):
            row = b[y : y + 5]
            for x in range(5):
                a[x + y] = row[x] ^ ((~row[(x + 1) % 5]) & row[(x + 2) % 5] & _MASK)
        # iota
        a[0] ^= rc


class Keccak256:
    """Incremental Keccak-256 sponge with `update`/`copy`/`digest`.

    Rate 136 bytes, capacity 512 bits, pad byte 0x01 (original Keccak).
    """

    RATE = 136

    def __init__(self):
        self._state = [0] * 25
        self._buf = bytearray()

    def update(self, data: bytes) -> "Keccak256":
        self._buf += data
        while len(self._buf) >= self.RATE:
            block = self._buf[: self.RATE]
            del self._buf[: self.RATE]
            self._absorb(bytes(block))
        return self

    def _absorb(self, block: bytes) -> None:
        for i in range(self.RATE // 8):
            self._state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        keccak_f1600(self._state)

    def copy(self) -> "Keccak256":
        k = Keccak256()
        k._state = list(self._state)
        k._buf = bytearray(self._buf)
        return k

    def digest(self) -> bytes:
        k = self.copy()
        pad = bytearray(k.RATE - len(k._buf))
        block = bytes(k._buf) + bytes(pad)
        block = bytearray(block)
        block[len(k._buf)] ^= 0x01
        block[-1] ^= 0x80
        k._buf = bytearray()
        k._absorb(bytes(block))
        out = b"".join(k._state[i].to_bytes(8, "little") for i in range(4))
        return out[:32]


def keccak256(data: bytes) -> bytes:
    return Keccak256().update(data).digest()
