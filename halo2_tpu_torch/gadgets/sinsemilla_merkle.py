"""Merkle tree gadget over Sinsemilla (reference
`halo2_gadgets/src/sinsemilla/merkle.rs` and `merkle/chip.rs`).

`MerkleCRH(l, left, right) = SinsemillaHash(Q, l* || left* || right*)` with
`l* = I2LEBSP_10(l)`, `left*`/`right*` = 255-bit little-endian encodings
(merkle/chip.rs:44-53). As in the reference, `left*`/`right*` are NOT
constrained to be canonical encodings.

Adaptation to this chip's word-wise Sinsemilla hashing (each 10-bit word is
individually witnessed and lookup-constrained, see `sinsemilla.py`): instead
of the reference's piece/z-running-sum decomposition gate
(merkle/chip.rs:101-185), the message words are bound to the `left`/`right`
node cells by
  * a `piece accumulate` telescope gate z_i = z_{i+1}*2^10 + w_i over copied
    word cells (so z_0 = sum w_i 2^{10 i}),
  * a decompose gate checking  w_0 = l,  left = A + b_1*2^250,
    right = b_2 + C*2^5,  w_26 = b_1 + 2^5*b_2,
  * 5-bit lookup short range checks on b_1, b_2.
Same constraint semantics (the straddling word w_26 plays the role of the
reference's b_1||b_2 subpieces).

A copy of `halo2_tpu/gadgets/sinsemilla_merkle.py` on the port's front-end.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..curves import Point
from ..fields import Fp
from ..frontend import AssignedCell, Layouter, Region, Value
from ..plonk.constraint_system import ConstraintSystem
from ..plonk.expression import Constant
from ..poly import Rotation
from .poseidon import _as_int
from .sinsemilla import SinsemillaChip, SinsemillaConfig
from .sinsemilla_primitives import K, HashDomain
from .utilities import CondSwapChip, CondSwapConfig, LookupRangeCheckConfig, i2lebsp

P = Fp.MODULUS

MERKLE_CRH_PERSONALIZATION = "z.cash:Orchard-MerkleCRH"

# Message layout: l (1 word) || left (words 1..=25 + low half of 26) ||
# right (high half of 26 + words 27..=51).
_NUM_WORDS = 52
_LEFT_WORDS = list(range(1, 26))
_STRADDLE_WORD = 26
_RIGHT_WORDS = list(range(27, 52))


def merkle_layer_words(l: int, left: Optional[int], right: Optional[int]
                       ) -> List[Optional[int]]:
    """The 52 K-bit message words of MerkleCRH(l, left, right)."""
    if left is None or right is None:
        return [None] * _NUM_WORDS
    msg = l | (left << K) | (right << (K + 255))
    return [(msg >> (K * i)) & ((1 << K) - 1) for i in range(_NUM_WORDS)]


def merkle_crh_domain() -> HashDomain:
    return HashDomain(MERKLE_CRH_PERSONALIZATION)


def merkle_crh(domain: HashDomain, l: int, left: int, right: int) -> int:
    """Host MerkleCRH (merkle.rs MERKLE_CRH_PERSONALIZATION domain hash)."""
    bits = i2lebsp(l, K) + [bool((left >> i) & 1) for i in range(255)] + [
        bool((right >> i) & 1) for i in range(255)
    ]
    out = domain.hash(bits)
    assert out is not None, "MerkleCRH hit an incomplete-addition failure"
    return out


class MerkleConfig:
    def __init__(self, sinsemilla: SinsemillaConfig, cond_swap: CondSwapConfig,
                 lookup: LookupRangeCheckConfig, advices,
                 q_piece, q_decompose, word_copy, z_col):
        self.sinsemilla = sinsemilla
        self.cond_swap = cond_swap
        self.lookup = lookup
        self.advices = advices
        self.q_piece = q_piece
        self.q_decompose = q_decompose
        self.word_copy = word_copy
        self.z_col = z_col


class MerkleChip:
    """MerkleInstructions::hash_layer + swap (merkle/chip.rs)."""

    def __init__(self, config: MerkleConfig):
        self.config = config
        self.sinsemilla = SinsemillaChip(config.sinsemilla)
        self.cond_swap = CondSwapChip(config.cond_swap, Fp)

    @staticmethod
    def configure(meta: ConstraintSystem, advices,
                  sinsemilla_config: SinsemillaConfig,
                  lookup: LookupRangeCheckConfig) -> MerkleConfig:
        """advices: 5 equality-enabled advice columns (shared with the
        cond-swap chip, as in merkle/chip.rs:89-97)."""
        assert len(advices) == 5
        for col in advices:
            meta.enable_equality(col)
        cond_swap = CondSwapChip.configure(meta, advices)

        q_piece = meta.selector()
        word_copy, z_col = advices[0], advices[1]

        def piece_gate(cells):
            q = cells.query_selector(q_piece)
            w = cells.query_advice(word_copy, Rotation.cur())
            z_cur = cells.query_advice(z_col, Rotation.cur())
            z_next = cells.query_advice(z_col, Rotation.next())
            return [q * (z_cur - z_next * (1 << K) - w)]

        meta.create_gate("piece accumulate", piece_gate)

        q_decompose = meta.selector()

        def decompose_gate(cells):
            q = cells.query_selector(q_decompose)
            z_left = cells.query_advice(advices[0], Rotation.cur())
            z_right = cells.query_advice(advices[1], Rotation.cur())
            b_1 = cells.query_advice(advices[2], Rotation.cur())
            b_2 = cells.query_advice(advices[3], Rotation.cur())
            w_26 = cells.query_advice(advices[4], Rotation.cur())
            left = cells.query_advice(advices[0], Rotation.next())
            right = cells.query_advice(advices[1], Rotation.next())
            return [
                q * (w_26 - (b_1 + b_2 * (1 << 5))),
                q * (z_left + b_1 * Constant(1 << 250) - left),
                q * (b_2 + z_right * (1 << 5) - right),
            ]

        meta.create_gate("Merkle decompose check", decompose_gate)

        return MerkleConfig(
            sinsemilla_config, cond_swap, lookup, list(advices),
            q_piece, q_decompose, word_copy, z_col,
        )

    # -- instruction surface --

    def swap(self, layouter: Layouter, pair: Tuple[AssignedCell, Value],
             swap: Value) -> Tuple[AssignedCell, AssignedCell]:
        return self.cond_swap.swap(layouter, pair, swap)

    def _accumulate_piece(self, layouter: Layouter, word_cells: List[AssignedCell],
                          name: str) -> AssignedCell:
        """z_0 = sum_i words[i] * 2^(K i), words copied in; returns z_0."""
        config = self.config
        n = len(word_cells)
        inv_two_pow_k = pow(1 << K, -1, P)

        def in_region(region: Region):
            zs_vals: List[Optional[int]] = [None] * (n + 1)
            known = all(not w.value().is_none() for w in word_cells)
            if known:
                words = [_as_int(w.value().force_value(), P) for w in word_cells]
                acc = 0
                for i, w in enumerate(words):
                    acc += w << (K * i)
                zs_vals[0] = acc % P
                z = zs_vals[0]
                for i, w in enumerate(words):
                    z = (z - w) * inv_two_pow_k % P
                    zs_vals[i + 1] = z
            z0 = None
            for i in range(n):
                region.enable_selector(config.q_piece, i)
                word_cells[i].copy_advice(region, config.word_copy, i, f"w_{i}")
                zv = Value.known(zs_vals[i]) if known else Value.unknown()
                cell = region.assign_advice(config.z_col, i, zv, f"z_{i}")
                if i == 0:
                    z0 = cell
            zn = Value.known(zs_vals[n]) if known else Value.unknown()
            last = region.assign_advice(config.z_col, n, zn, f"z_{n}")
            region.constrain_constant(last.cell(), 0)
            return z0

        return layouter.assign_region(name, in_region)

    def hash_layer(self, layouter: Layouter, Q: Point, l: int,
                   left: AssignedCell, right: AssignedCell) -> AssignedCell:
        """MerkleCRH(l, left, right) -> x-coordinate cell
        (merkle/chip.rs hash_layer)."""
        config = self.config
        lv, rv = left.value(), right.value()
        if lv.is_none() or rv.is_none():
            words = [None] * _NUM_WORDS
        else:
            words = merkle_layer_words(
                l, _as_int(lv.force_value(), P), _as_int(rv.force_value(), P)
            )

        witnessed = self.sinsemilla.witness_message_words(layouter, words)
        word_cells = [w for w, _ in witnessed]
        point = self.sinsemilla.hash_to_point_from_witnessed(layouter, Q, witnessed)

        z_left = self._accumulate_piece(
            layouter, [word_cells[i] for i in _LEFT_WORDS], "left piece"
        )
        z_right = self._accumulate_piece(
            layouter, [word_cells[i] for i in _RIGHT_WORDS], "right piece"
        )

        # b_1 (5 low bits of w_26, top of left), b_2 (5 high bits, bottom of
        # right); 5-bit lookup short range checks (merkle/chip.rs b_1/b_2).
        w26 = word_cells[_STRADDLE_WORD]
        if w26.value().is_none():
            b1v = b2v = Value.unknown()
        else:
            w26i = _as_int(w26.value().force_value(), P)
            b1v = Value.known(w26i & 0x1F)
            b2v = Value.known(w26i >> 5)
        b_1 = config.lookup.witness_short_check(layouter, b1v, 5)
        b_2 = config.lookup.witness_short_check(layouter, b2v, 5)

        def decompose_region(region: Region):
            region.enable_selector(config.q_decompose, 0)
            z_left.copy_advice(region, config.advices[0], 0, "z_left")
            z_right.copy_advice(region, config.advices[1], 0, "z_right")
            b_1.copy_advice(region, config.advices[2], 0, "b_1")
            b_2.copy_advice(region, config.advices[3], 0, "b_2")
            w26.copy_advice(region, config.advices[4], 0, "w_26")
            left.copy_advice(region, config.advices[0], 1, "left")
            right.copy_advice(region, config.advices[1], 1, "right")
            # l* is the first message word: bind it to the constant layer index
            w0 = word_cells[0].copy_advice(region, config.advices[2], 1, "l")
            region.constrain_constant(w0.cell(), l)

        layouter.assign_region("Merkle decompose", decompose_region)
        return point.x


class MerklePath:
    """Merkle path validity gadget (merkle.rs MerklePath, PAR=1)."""

    def __init__(self, chip: MerkleChip, domain: HashDomain,
                 leaf_pos: Optional[int], path: List[Optional[int]]):
        self.chip = chip
        self.domain = domain
        self.leaf_pos = leaf_pos
        self.path = path

    def calculate_root(self, layouter: Layouter, leaf: AssignedCell) -> AssignedCell:
        depth = len(self.path)
        pos_bits = (
            i2lebsp(self.leaf_pos, depth) if self.leaf_pos is not None
            else [None] * depth
        )
        node = leaf
        for l, (sibling, bit) in enumerate(zip(self.path, pos_bits)):
            sib_v = Value.unknown() if sibling is None else Value.known(sibling)
            bit_v = Value.unknown() if bit is None else Value.known(int(bit))
            left, right = self.chip.swap(layouter, (node, sib_v), bit_v)
            node = self.chip.hash_layer(layouter, self.domain.Q, l, left, right)
        return node
