"""Poseidon host primitives: Grain LFSR constants, Cauchy MDS, permutation,
sponge, and the P128Pow5T3 spec.

Re-implements the behavior of `halo2_gadgets/src/poseidon/primitives{,.rs}`:
  * Grain LFSR in self-shrinking mode with Poseidon's 80-bit seeding layout
    (grain.rs:53-81), MSB-first field element extraction with rejection
    sampling (grain.rs:109-136) and the no-rejection wide-reduction variant
    (grain.rs:140-168).
  * Cauchy MDS a_ij = 1/(x_i + y_j) with uniqueness resampling and the
    `secure_mds` skip counter (mds.rs:5-62).
  * The permutation: R_f/2 full rounds, R_p partial rounds (sbox on word 0
    only), R_f/2 full rounds; add-round-constant then sbox then MDS
    (primitives.rs:89-135).
  * Sponge absorb/squeeze and the ConstantLength domain with capacity
    element L * 2^64 (primitives.rs:190-330).

P128Pow5T3: x^5 sbox, T=3, RATE=2, R_F=8, R_P=56 over either Pasta field;
constants generated at import (reference hard-codes the same values in
fp.rs/fq.rs; equality is pinned in tests against fixture values).

A copy of `halo2_tpu/gadgets/poseidon_primitives.py` on the port's fields.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple, Type

from ..fields import FieldElement, Fp, Fq


class Grain:
    """Grain LFSR in self-shrinking mode (grain.rs)."""

    STATE = 80

    def __init__(self, field: Type[FieldElement], sbox_tag: int, t: int, r_f: int, r_p: int):
        self.field = field
        self.num_bits = field.NUM_BITS
        bits = [1] * self.STATE

        def set_bits(offset: int, length: int, value: int):
            for i in range(length):
                bits[offset + length - 1 - i] = (value >> i) & 1

        set_bits(0, 2, 1)  # FieldType::PrimeOrder
        set_bits(2, 4, sbox_tag)
        set_bits(6, 12, self.num_bits)
        set_bits(18, 12, t)
        set_bits(30, 10, r_f)
        set_bits(40, 10, r_p)
        self.state = bits
        self.next_bit = self.STATE
        for _ in range(20):
            self._load_next_8_bits()
            self.next_bit = self.STATE

    def _load_next_8_bits(self):
        s = self.state
        new_bits = [
            s[i + 62] ^ s[i + 51] ^ s[i + 38] ^ s[i + 23] ^ s[i + 13] ^ s[i]
            for i in range(8)
        ]
        # rotate left by 8, then write new bits at the tail
        self.state = s[8:] + new_bits
        self.next_bit -= 8

    def _get_next_bit(self) -> int:
        if self.next_bit == self.STATE:
            self._load_next_8_bits()
        ret = self.state[self.next_bit]
        self.next_bit += 1
        return ret

    def next_shrunk_bit(self) -> int:
        """Self-shrinking: 1 -> output next bit; 0 -> discard next bit."""
        while not self._get_next_bit():
            self._get_next_bit()
        return self._get_next_bit()

    def _next_bits_msb(self) -> int:
        """NUM_BITS shrunk bits interpreted MSB-first (grain.rs:118-130)."""
        v = 0
        for _ in range(self.num_bits):
            v = (v << 1) | self.next_shrunk_bit()
        return v

    def next_field_element(self) -> int:
        """With rejection sampling (round constants)."""
        while True:
            v = self._next_bits_msb()
            if v < self.field.MODULUS:
                return v

    def next_field_element_without_rejection(self) -> int:
        """Wide reduction (MDS sampling): bits placed in a 64-byte buffer at
        the same bit positions as the repr, then reduced mod p."""
        return self._next_bits_msb() % self.field.MODULUS


def generate_mds(grain: Grain, t: int, select: int) -> Tuple[List[List[int]], List[List[int]]]:
    """Cauchy MDS + inverse (mds.rs:5-123)."""
    p = grain.field.MODULUS
    while True:
        while True:
            vals = [grain.next_field_element_without_rejection() for _ in range(2 * t)]
            if len(set(vals)) == len(vals):
                xs, ys = vals[:t], vals[t:]
                break
        if select != 0:
            select -= 1
            continue
        mds = [[pow((xs[i] + ys[j]) % p, -1, p) for j in range(t)] for i in range(t)]
        break

    # inverse via Schechter's Cauchy-inverse with Lagrange products (mds.rs:64-123)
    neg_ys = [(-y) % p for y in ys]

    def l(points: Sequence[int], j: int, x: int) -> int:
        x_j = points[j]
        acc = 1
        for m, x_m in enumerate(points):
            if m == j:
                continue
            acc = acc * (x - x_m) % p * pow((x_j - x_m) % p, -1, p) % p
        return acc

    mds_inv = [
        [
            (xs[j] - neg_ys[i]) % p * l(xs, j, neg_ys[i]) % p * l(neg_ys, i, xs[j]) % p
            for j in range(t)
        ]
        for i in range(t)
    ]
    return mds, mds_inv


@lru_cache(maxsize=None)
def generate_constants(
    field: Type[FieldElement], t: int, rate: int, r_f: int, r_p: int, secure_mds: int = 0
):
    """(round_constants, mds, mds_inv) (primitives.rs:59-87)."""
    grain = Grain(field, sbox_tag=0, t=t, r_f=r_f, r_p=r_p)
    round_constants = [
        [grain.next_field_element() for _ in range(t)] for _ in range(r_f + r_p)
    ]
    mds, mds_inv = generate_mds(grain, t, secure_mds)
    return round_constants, mds, mds_inv


class Spec:
    """A Poseidon specification (primitives.rs Spec trait)."""

    T: int
    RATE: int
    FIELD: Type[FieldElement]

    @classmethod
    def full_rounds(cls) -> int:
        raise NotImplementedError

    @classmethod
    def partial_rounds(cls) -> int:
        raise NotImplementedError

    @classmethod
    def sbox(cls, v: int) -> int:
        raise NotImplementedError

    @classmethod
    def secure_mds(cls) -> int:
        return 0

    @classmethod
    @lru_cache(maxsize=None)
    def constants(cls):
        return generate_constants(
            cls.FIELD, cls.T, cls.RATE, cls.full_rounds(), cls.partial_rounds(),
            cls.secure_mds(),
        )


def _p128_spec(field: Type[FieldElement]):
    class _P128Pow5T3(Spec):
        T = 3
        RATE = 2
        FIELD = field

        @classmethod
        def full_rounds(cls) -> int:
            return 8

        @classmethod
        def partial_rounds(cls) -> int:
            return 56

        @classmethod
        def sbox(cls, v: int) -> int:
            return pow(v, 5, field.MODULUS)

    _P128Pow5T3.__name__ = f"P128Pow5T3_{field.__name__}"
    return _P128Pow5T3


P128Pow5T3Fp = _p128_spec(Fp)  # pallas::Base (reference fp.rs constants)
P128Pow5T3Fq = _p128_spec(Fq)  # vesta::Base (reference fq.rs constants)


def permute(state: List[int], spec: Type[Spec]) -> List[int]:
    """The Poseidon permutation (primitives.rs:89-135)."""
    p = spec.FIELD.MODULUS
    t = spec.T
    round_constants, mds, _ = spec.constants()
    r_f = spec.full_rounds() // 2
    r_p = spec.partial_rounds()

    def apply_mds(st):
        return [sum(mds[i][j] * st[j] for j in range(t)) % p for i in range(t)]

    idx = 0
    for _ in range(r_f):
        state = apply_mds([spec.sbox((w + rc) % p) for w, rc in zip(state, round_constants[idx])])
        idx += 1
    for _ in range(r_p):
        st = [(w + rc) % p for w, rc in zip(state, round_constants[idx])]
        st[0] = spec.sbox(st[0])
        state = apply_mds(st)
        idx += 1
    for _ in range(r_f):
        state = apply_mds([spec.sbox((w + rc) % p) for w, rc in zip(state, round_constants[idx])])
        idx += 1
    return state


class Sponge:
    """Absorb/squeeze sponge (primitives.rs:190-283)."""

    def __init__(self, spec: Type[Spec], initial_capacity_element: int):
        self.spec = spec
        self.p = spec.FIELD.MODULUS
        self.state = [0] * spec.T
        self.state[spec.RATE] = initial_capacity_element % self.p
        self.absorbing: List[int] = []
        self.squeezing: List[int] = []
        self.mode = "absorb"

    def _permute_absorb(self):
        for i, v in enumerate(self.absorbing):
            self.state[i] = (self.state[i] + v) % self.p
        self.state = permute(self.state, self.spec)
        self.absorbing = []

    def absorb(self, value: int):
        assert self.mode == "absorb"
        if len(self.absorbing) == self.spec.RATE:
            self._permute_absorb()
        self.absorbing.append(value % self.p)

    def finish_absorbing(self):
        self._permute_absorb()
        self.mode = "squeeze"
        self.squeezing = list(self.state[: self.spec.RATE])

    def squeeze(self) -> int:
        assert self.mode == "squeeze"
        if not self.squeezing:
            self.state = permute(self.state, self.spec)
            self.squeezing = list(self.state[: self.spec.RATE])
        return self.squeezing.pop(0)


class ConstantLength:
    """ConstantLength<L> domain (primitives.rs:303-331)."""

    def __init__(self, L: int):
        self.L = L

    def name(self) -> str:
        return f"ConstantLength<{self.L}>"

    def initial_capacity_element(self) -> int:
        return self.L << 64

    def padding(self, rate: int) -> List[int]:
        k = (self.L + rate - 1) // rate
        return [0] * (k * rate - self.L)


def poseidon_hash(message: Sequence[int], spec: Type[Spec], domain: ConstantLength) -> int:
    """Hash with constant-length domain (primitives.rs Hash::hash)."""
    assert len(message) == domain.L
    sponge = Sponge(spec, domain.initial_capacity_element())
    for v in list(message) + domain.padding(spec.RATE):
        sponge.absorb(v)
    sponge.finish_absorbing()
    return sponge.squeeze()
