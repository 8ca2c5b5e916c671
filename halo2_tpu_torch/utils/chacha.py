"""ChaCha20 RNG byte-compatible with Rust's `rand_chacha::ChaCha20Rng`.

The reference prover consumes randomness through `rand_core::RngCore`
(blinding factors and the vanishing argument's random polynomial -
reference `halo2_proofs/src/plonk/prover.rs`, `plonk/vanishing/prover.rs`).
To make proofs reproducible across the Rust reference and this framework,
this module reimplements the exact `ChaCha20Rng` word stream and the
`rand_core::BlockRng` consumption semantics (`next_u32` / `next_u64` /
`fill_bytes`).

Stream layout: 32-byte seed = key; stream id (nonce) = 0; 64-bit block
counter starting at 0; each block yields 16 u32 words consumed in order.
"""

from __future__ import annotations

import struct

_MASK32 = 0xFFFFFFFF


def _rotl32(v: int, n: int) -> int:
    return ((v << n) | (v >> (32 - n))) & _MASK32


def _quarter(st, a, b, c, d):
    st[a] = (st[a] + st[b]) & _MASK32
    st[d] = _rotl32(st[d] ^ st[a], 16)
    st[c] = (st[c] + st[d]) & _MASK32
    st[b] = _rotl32(st[b] ^ st[c], 12)
    st[a] = (st[a] + st[b]) & _MASK32
    st[d] = _rotl32(st[d] ^ st[a], 8)
    st[c] = (st[c] + st[d]) & _MASK32
    st[b] = _rotl32(st[b] ^ st[c], 7)


def chacha20_block(key_words, counter: int, nonce_words) -> list:
    """One ChaCha20 block (20 rounds) -> 16 output u32 words.

    Uses the djb variant with a 64-bit counter and 64-bit nonce, matching
    rand_chacha (counter in words 12-13, stream id in words 14-15).
    """
    st = [
        0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
        *key_words,
        counter & _MASK32, (counter >> 32) & _MASK32,
        nonce_words[0], nonce_words[1],
    ]
    work = list(st)
    for _ in range(10):
        _quarter(work, 0, 4, 8, 12)
        _quarter(work, 1, 5, 9, 13)
        _quarter(work, 2, 6, 10, 14)
        _quarter(work, 3, 7, 11, 15)
        _quarter(work, 0, 5, 10, 15)
        _quarter(work, 1, 6, 11, 12)
        _quarter(work, 2, 7, 8, 13)
        _quarter(work, 3, 4, 9, 14)
    return [(w + s) & _MASK32 for w, s in zip(work, st)]


class ChaCha20Rng:
    """rand_chacha-compatible deterministic RNG."""

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self._key = list(struct.unpack("<8I", seed))
        self._nonce = [0, 0]
        self._counter = 0
        self._words: list = []
        self._index = 16  # force refill

    @classmethod
    def from_seed(cls, seed: bytes) -> "ChaCha20Rng":
        return cls(seed)

    def set_stream(self, stream: int) -> None:
        self._nonce = [stream & _MASK32, (stream >> 32) & _MASK32]
        self._words, self._index = [], 16

    def _refill(self):
        self._words = chacha20_block(self._key, self._counter, self._nonce)
        self._counter += 1
        self._index = 0

    def next_u32(self) -> int:
        if self._index >= 16:
            self._refill()
        w = self._words[self._index]
        self._index += 1
        return w

    def next_u64(self) -> int:
        # rand_core BlockRng: reads two consecutive u32 (lo, hi); if only one
        # word remains in the block, it reads lo from this block and hi from
        # the next.
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    def fill_bytes(self, n: int) -> bytes:
        """Return n bytes (rand_core fill_via_u32_chunks semantics: whole
        words consumed little-endian; a trailing partial word is consumed)."""
        out = bytearray()
        while len(out) < n:
            if self._index >= 16:
                self._refill()
            w = self._words[self._index]
            self._index += 1
            out += w.to_bytes(4, "little")
        return bytes(out[:n])
