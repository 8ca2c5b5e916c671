"""In-circuit Sinsemilla chip
(reference `halo2_gadgets/src/sinsemilla/chip.rs`, `chip/generator_table.rs`,
`chip/hash_to_point.rs`).

The generator lookup table holds (idx, x, y) for the 2^K S generators;
looking up a message word m alongside the witnessed (x_s, y_s) coordinates
simultaneously range-constrains m to K bits and binds (x_s, y_s) =
S[m] (generator_table.rs). Each word then folds the accumulator with two
incomplete additions acc' = (acc + S) + acc through the ECC chip's
incomplete-addition gate.

Layout note (documented deviation): the reference fuses the fold into
specialized x_a/lambda running columns (hash_to_point.rs, ~2 rows/word);
here each word costs one lookup row plus two 2-row incomplete additions via
`EccChip.add_incomplete` - same instruction semantics, more rows. Row
optimization is follow-up work.

A copy of `halo2_tpu/gadgets/sinsemilla.py` on the port's front-end.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..curves import Pallas, Point
from ..fields import Fp
from ..frontend import AssignedCell, Layouter, Region, Value
from ..plonk.constraint_system import ConstraintSystem
from ..poly import Rotation
from .ecc import EccChip, EccConfig, NonIdentityEccPoint
from .poseidon import _as_int
from .sinsemilla_primitives import K, lebs2ip_k, pad, sinsemilla_s

P = Fp.MODULUS


class SinsemillaConfig:
    def __init__(self, q_lookup, word_col, x_s_col, y_s_col,
                 table_idx, table_x, table_y, ecc_config: EccConfig):
        self.q_lookup = q_lookup
        self.word_col = word_col
        self.x_s_col = x_s_col
        self.y_s_col = y_s_col
        self.table_idx = table_idx
        self.table_x = table_x
        self.table_y = table_y
        self.ecc = ecc_config


class SinsemillaChip:
    def __init__(self, config: SinsemillaConfig):
        self.config = config
        self.ecc = EccChip(config.ecc)

    @staticmethod
    def configure(meta: ConstraintSystem, advices, ecc_config: EccConfig) -> SinsemillaConfig:
        """advices: 3 advice columns for (word, x_s, y_s)."""
        word_col, x_s_col, y_s_col = advices
        for col in advices:
            meta.enable_equality(col)
        table_idx = meta.lookup_table_column()
        table_x = meta.lookup_table_column()
        table_y = meta.lookup_table_column()
        q_lookup = meta.complex_selector()

        def lookup_map(cells):
            q = cells.query_selector(q_lookup)
            m = cells.query_advice(word_col, Rotation.cur())
            xs = cells.query_advice(x_s_col, Rotation.cur())
            ys = cells.query_advice(y_s_col, Rotation.cur())
            # when q = 0 the default row (0, S[0].x, S[0].y) must be looked
            # up; add the defaults like generator_table.rs:50-75
            s0 = sinsemilla_s()[0]
            one_minus_q = 1 - q
            return [
                (q * m, table_idx),
                (q * xs + one_minus_q * s0.xy[0], table_x),
                (q * ys + one_minus_q * s0.xy[1], table_y),
            ]

        meta.lookup("generator lookup", lookup_map)
        return SinsemillaConfig(
            q_lookup, word_col, x_s_col, y_s_col, table_idx, table_x, table_y,
            ecc_config,
        )

    def load_table(self, layouter: Layouter):
        """Load the 2^K generator table (generator_table.rs load)."""
        S = sinsemilla_s()

        def in_table(table):
            for i, pt in enumerate(S):
                table.assign_cell(self.config.table_idx, i, i, "table_idx")
                table.assign_cell(self.config.table_x, i, pt.xy[0], "table_x")
                table.assign_cell(self.config.table_y, i, pt.xy[1], "table_y")

        layouter.assign_table("sinsemilla generators", in_table)

    def witness_message_words(self, layouter: Layouter, words: List[Optional[int]]
                              ) -> List[Tuple[AssignedCell, NonIdentityEccPoint]]:
        """Witness each K-bit word with its looked-up generator point."""
        config = self.config
        S = sinsemilla_s()

        def in_region(region: Region):
            out = []
            for offset, w in enumerate(words):
                region.enable_selector(config.q_lookup, offset)
                if w is None:
                    wv = xv = yv = Value.unknown()
                else:
                    assert 0 <= w < (1 << K)
                    s = S[w]
                    wv = Value.known(w)
                    xv, yv = Value.known(s.xy[0]), Value.known(s.xy[1])
                m = region.assign_advice(config.word_col, offset, wv, "word")
                x = region.assign_advice(config.x_s_col, offset, xv, "x_s")
                y = region.assign_advice(config.y_s_col, offset, yv, "y_s")
                out.append((m, NonIdentityEccPoint(x, y)))
            return out

        return layouter.assign_region("witness message words", in_region)

    def hash_to_point(self, layouter: Layouter, q_point: Point,
                      words: List[Optional[int]]) -> NonIdentityEccPoint:
        """SinsemillaHashToPoint over witnessed words, starting from the
        fixed domain point Q (hash_to_point.rs)."""
        witnessed = self.witness_message_words(layouter, words)
        return self.hash_to_point_from_witnessed(layouter, q_point, witnessed)

    def hash_to_point_from_witnessed(
        self, layouter: Layouter, q_point: Point,
        witnessed: List[Tuple[AssignedCell, NonIdentityEccPoint]],
    ) -> NonIdentityEccPoint:
        """The accumulator fold over already-witnessed words (used by the
        Merkle chip, which also binds the word cells to node values)."""
        # Q is a public constant of the domain: witness + constrain to constants
        ecc = self.ecc

        def q_region(region: Region):
            region.enable_selector(ecc.config.q_point_non_id, 0)
            x = region.assign_advice(ecc.config.x_p, 0, Value.known(q_point.xy[0]), "Q_x")
            y = region.assign_advice(ecc.config.y_p, 0, Value.known(q_point.xy[1]), "Q_y")
            region.constrain_constant(x.cell(), q_point.xy[0])
            region.constrain_constant(y.cell(), q_point.xy[1])
            return NonIdentityEccPoint(x, y)

        acc = layouter.assign_region("witness Q", q_region)
        for m, s_point in witnessed:
            mid = ecc.add_incomplete(layouter, acc, s_point)
            acc = ecc.add_incomplete(layouter, mid, acc)
        return acc


class CommitDomainGadget:
    """In-circuit SinsemillaCommit / SinsemillaShortCommit
    (sinsemilla.rs CommitDomain gadget, :346-380):
    commit(msg, r) = hash_to_point(msg) + [r]R with R a fixed base."""

    def __init__(self, chip: SinsemillaChip, ecc_gadget_chip, domain):
        """`domain`: a sinsemilla_primitives.CommitDomain; `ecc_gadget_chip`:
        an ecc_api.EccGadgetChip providing mul_fixed + complete add."""
        from .ecc_fixed import NUM_WINDOWS, FixedPointBase

        self.chip = chip
        self.ecc = ecc_gadget_chip
        self.domain = domain
        self.hash_gadget = SinsemillaHashGadget(chip, domain.M)
        self.r_base = FixedPointBase(domain.R, NUM_WINDOWS)

    def commit(self, layouter: Layouter, message_bits: Optional[List[bool]],
               num_words: int, r: "Value"):
        """Returns the commitment point (complete-add of hash and blind)."""
        blind, _ = self.ecc.mul_fixed(layouter, r, self.r_base)
        p = self.hash_gadget.hash_to_point(layouter, message_bits, num_words)
        return self.ecc.add(layouter, p, blind)

    def short_commit(self, layouter: Layouter, message_bits: Optional[List[bool]],
                     num_words: int, r: "Value") -> AssignedCell:
        return self.commit(layouter, message_bits, num_words, r).x


class SinsemillaHashGadget:
    """Gadget-level driver binding a HashDomain (sinsemilla.rs HashDomain)."""

    def __init__(self, chip: SinsemillaChip, domain):
        self.chip = chip
        self.domain = domain  # sinsemilla_primitives.HashDomain

    def hash_to_point(self, layouter: Layouter, message_bits: Optional[List[bool]],
                      num_words: int) -> NonIdentityEccPoint:
        if message_bits is None:
            words = [None] * num_words
        else:
            padded = pad(message_bits)
            assert len(padded) == num_words * K
            words = [
                lebs2ip_k(padded[i * K : (i + 1) * K]) for i in range(num_words)
            ]
        return self.chip.hash_to_point(layouter, self.domain.Q, words)
