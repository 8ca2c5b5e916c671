"""Fused Sinsemilla chip: one row per message word.

Implements the reference's running-column Sinsemilla layout
(`halo2_gadgets/src/sinsemilla/chip.rs` + `chip/{hash_to_point,
generator_table}.rs`; spec: halo2 book "Sinsemilla"): 5 advice columns
(x_a, x_p, bits, lambda_1, lambda_2), a 0/1/2-valued fixed column q_s2
encoding piece boundaries, and a 3-column generator lookup whose y_p entry
is DERIVED from the double-and-add slopes -

    y_p = Y_A/2 - lambda_1 (x_a - x_p),   Y_A = (l1 + l2)(x_a - x_r)

so the accumulator's y-coordinate is never witnessed until the final row.
Each word costs ONE row (z running sum + slopes), vs ~5 rows/word for the
incomplete-add composition in `sinsemilla.py` (kept as the simple
fallback).

Messages are hashed as multi-word MessagePieces (a single witnessed field
element per <= 25 words, decomposed in-circuit by the z running sum with
the implicit z_n = 0 boundary).

A copy of `halo2_tpu/gadgets/sinsemilla_fused.py` on the port's front-end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..fields import Fp
from ..frontend import AssignedCell, Layouter, Region, Value
from ..plonk import ConstraintSystem
from ..plonk.expression import Constant
from ..poly import Rotation
from .ecc import NonIdentityEccPoint, _inv0
from .sinsemilla_primitives import K, lebs2ip_k, pad, sinsemilla_s

P = Fp.MODULUS
TWO_INV = pow(2, -1, P)
INV_TWO_POW_K = pow(1 << K, -1, P)
MAX_PIECE_WORDS = 25  # sinsemilla::C / K: single-field-element capacity


@dataclass
class MessagePiece:
    cell: AssignedCell
    num_words: int
    words: Optional[List[int]]  # host values, None when witness-less


@dataclass
class FusedSinsemillaConfig:
    q_s1: object  # complex selector: every hash row
    q_s2: object  # fixed column: 1 mid-piece, 0 piece boundary, 2 final row
    q_s4: object  # selector: initial y_Q row
    fixed_y_q: object  # fixed column holding y(Q)
    x_a: object
    x_p: object
    bits: object
    lambda_1: object
    lambda_2: object
    witness_pieces: object
    table_idx: object
    table_x: object
    table_y: object


class SinsemillaFusedChip:
    def __init__(self, config: FusedSinsemillaConfig):
        self.config = config
        self._s = None

    @staticmethod
    def configure(meta: ConstraintSystem, advices, witness_pieces,
                  fixed_y_q=None) -> FusedSinsemillaConfig:
        """advices: 5 columns (x_a, x_p, bits, lambda_1, lambda_2)
        (reference chip.rs configure)."""
        assert len(advices) == 5
        for a in advices:
            meta.enable_equality(a)
        meta.enable_equality(witness_pieces)
        x_a, x_p, bits, l1, l2 = advices
        q_s1 = meta.complex_selector()
        q_s2 = meta.fixed_column()
        q_s4 = meta.selector()
        if fixed_y_q is None:
            fixed_y_q = meta.fixed_column()
        table_idx = meta.lookup_table_column()
        table_x = meta.lookup_table_column()
        table_y = meta.lookup_table_column()

        def x_r(cells, rot):
            xa = cells.query_advice(x_a, rot)
            xp = cells.query_advice(x_p, rot)
            lam1 = cells.query_advice(l1, rot)
            return lam1 * lam1 - xa - xp

        def y_a_expr(cells, rot):
            xa = cells.query_advice(x_a, rot)
            lam1 = cells.query_advice(l1, rot)
            lam2 = cells.query_advice(l2, rot)
            return (lam1 + lam2) * (xa - x_r(cells, rot))

        def q_s3(cells):
            q2 = cells.query_fixed(q_s2, Rotation.cur())
            return q2 * (q2 - Constant(1))

        # generator lookup: (word, x_p, derived y_p) in SINSEMILLA_S
        # (generator_table.rs configure)
        s0x, s0y = _S_XY(0)

        def lookup_map(cells):
            qs1 = cells.query_selector(q_s1)
            q_run = cells.query_fixed(q_s2, Rotation.cur()) - q_s3(cells)
            z_cur = cells.query_advice(bits, Rotation.cur())
            z_next = cells.query_advice(bits, Rotation.next())
            word = z_cur - q_run * z_next * Constant(1 << K)
            xp = cells.query_advice(x_p, Rotation.cur())
            lam1 = cells.query_advice(l1, Rotation.cur())
            xa = cells.query_advice(x_a, Rotation.cur())
            y_p = y_a_expr(cells, Rotation.cur()) * Constant(TWO_INV) - lam1 * (
                xa - xp
            )
            not_q = Constant(1) - qs1
            return [
                (qs1 * word, table_idx),
                (qs1 * xp + not_q * Constant(s0x), table_x),
                (qs1 * y_p + not_q * Constant(s0y), table_y),
            ]

        meta.lookup("sinsemilla generators", lookup_map)

        def init_y_q_gate(cells):
            q4 = cells.query_selector(q_s4)
            y_q = cells.query_fixed(fixed_y_q, Rotation.cur())
            return [q4 * (y_q * Constant(2) - y_a_expr(cells, Rotation.cur()))]

        meta.create_gate("sinsemilla initial y_Q", init_y_q_gate)

        def main_gate(cells):
            qs1 = cells.query_selector(q_s1)
            qs3 = q_s3(cells)
            lam1_next = cells.query_advice(l1, Rotation.next())
            lam2 = cells.query_advice(l2, Rotation.cur())
            xa_cur = cells.query_advice(x_a, Rotation.cur())
            xa_next = cells.query_advice(x_a, Rotation.next())
            secant = lam2 * lam2 - (xa_next + x_r(cells, Rotation.cur()) + xa_cur)
            lhs = lam2 * Constant(4) * (xa_cur - xa_next)
            rhs = (
                y_a_expr(cells, Rotation.cur()) * Constant(2)
                + (Constant(2) - qs3) * y_a_expr(cells, Rotation.next())
                + qs3 * Constant(2) * lam1_next
            )
            return [qs1 * secant, qs1 * (lhs - rhs)]

        meta.create_gate("sinsemilla main", main_gate)

        return FusedSinsemillaConfig(
            q_s1, q_s2, q_s4, fixed_y_q, x_a, x_p, bits, l1, l2,
            witness_pieces, table_idx, table_x, table_y,
        )

    # ---- table ----
    def load_table(self, layouter: Layouter):
        cfg = self.config
        s = _S()

        def in_table(table):
            for i in range(1 << K):
                x, y = s[i]
                table.assign_cell(cfg.table_idx, i, i, "idx")
                table.assign_cell(cfg.table_x, i, x, "x")
                table.assign_cell(cfg.table_y, i, y, "y")

        layouter.assign_table("sinsemilla generators", in_table)

    # ---- message pieces ----
    def witness_message(self, layouter: Layouter, message_bits: Optional[List[bool]],
                        num_words: int) -> List[MessagePiece]:
        """Chunk a K*num_words bitstring into <= MAX_PIECE_WORDS-word pieces
        and witness each as one field element."""
        pieces = []
        for start in range(0, num_words, MAX_PIECE_WORDS):
            n = min(MAX_PIECE_WORDS, num_words - start)
            if message_bits is None:
                words = None
                val = Value.unknown()
            else:
                bits = message_bits[start * K : (start + n) * K]
                words = [
                    lebs2ip_k(bits[i * K : (i + 1) * K]) for i in range(n)
                ]
                v = sum(w << (K * i) for i, w in enumerate(words)) % P
                val = Value.known(v)
            cell = layouter.assign_region(
                "witness message piece",
                lambda region, _v=val: region.assign_advice(
                    self.config.witness_pieces, 0, _v, "piece"
                ),
            )
            pieces.append(MessagePiece(cell, n, words))
        return pieces

    # ---- hashing ----
    def hash_to_point(self, layouter: Layouter, q_point,
                      pieces: List[MessagePiece]) -> NonIdentityEccPoint:
        """hash_to_point.rs: Q + [words] accumulated at one row per word."""
        cfg = self.config
        s = _S()

        def in_region(region: Region):
            offset = 0
            region.enable_selector(cfg.q_s4, 0)
            region.assign_fixed(cfg.fixed_y_q, 0, q_point.xy[1], "y_q")
            x_a = region.assign_advice_from_constant(
                cfg.x_a, 0, q_point.xy[0], "x_q"
            )
            x_a_v: Optional[int] = q_point.xy[0]
            y_a_v: Optional[int] = q_point.xy[1]

            for p_idx, piece in enumerate(pieces):
                final_piece = p_idx == len(pieces) - 1
                n = piece.num_words
                for row in range(n):
                    region.enable_selector(cfg.q_s1, offset + row)
                for row in range(n - 1):
                    region.assign_fixed(cfg.q_s2, offset + row, 1, "q_s2")
                region.assign_fixed(
                    cfg.q_s2, offset + n - 1, 2 if final_piece else 0, "q_s2"
                )

                # z running sum decomposing the piece (z_n == 0 implicit)
                z = piece.cell.copy_advice(region, cfg.bits, offset, "z_0")
                z_v = None if piece.words is None else (
                    sum(w << (K * i) for i, w in enumerate(piece.words)) % P
                )
                for idx in range(n - 1):
                    if z_v is None:
                        zv = Value.unknown()
                    else:
                        z_v = (z_v - piece.words[idx]) * INV_TWO_POW_K % P
                        zv = Value.known(z_v)
                    z = region.assign_advice(cfg.bits, offset + idx + 1, zv, "z")

                for row in range(n):
                    word = None if piece.words is None else piece.words[row]
                    if word is None or x_a_v is None:
                        x_p_val = lam1_val = lam2_val = None
                        x_a_new = y_a_new = None
                    else:
                        x_p_v, y_p_v = s[word]
                        lam1_val = (y_a_v - y_p_v) * _inv0(x_a_v - x_p_v) % P
                        x_r_v = (lam1_val * lam1_val - x_a_v - x_p_v) % P
                        lam2_val = (
                            2 * y_a_v * _inv0(x_a_v - x_r_v) - lam1_val
                        ) % P
                        x_a_new = (lam2_val * lam2_val - x_a_v - x_r_v) % P
                        y_a_new = (lam2_val * (x_a_v - x_a_new) - y_a_v) % P
                        x_p_val = x_p_v

                    def val(x):
                        return Value.unknown() if x is None else Value.known(x)

                    region.assign_advice(cfg.x_p, offset + row, val(x_p_val), "x_p")
                    region.assign_advice(
                        cfg.lambda_1, offset + row, val(lam1_val), "lambda_1"
                    )
                    region.assign_advice(
                        cfg.lambda_2, offset + row, val(lam2_val), "lambda_2"
                    )
                    x_a = region.assign_advice(
                        cfg.x_a, offset + row + 1, val(x_a_new), "x_a"
                    )
                    x_a_v, y_a_v = x_a_new, y_a_new
                offset += n

            # final y_a witnessed in lambda_1; dummy lambda_2/x_p (queried
            # by the final row's gate, multiplied by zero selectors)
            y_a = region.assign_advice(
                cfg.lambda_1, offset,
                Value.known(y_a_v) if y_a_v is not None else Value.unknown(),
                "y_a",
            )
            region.assign_advice(cfg.lambda_2, offset, Value.known(0), "dummy l2")
            region.assign_advice(cfg.x_p, offset, Value.known(0), "dummy x_p")
            return NonIdentityEccPoint(x_a, y_a)

        return layouter.assign_region("sinsemilla hash", in_region)


_S_CACHE: Optional[List[Tuple[int, int]]] = None


def _S() -> List[Tuple[int, int]]:
    global _S_CACHE
    if _S_CACHE is None:
        _S_CACHE = [(pt.xy[0], pt.xy[1]) for pt in sinsemilla_s()]
    return _S_CACHE


def _S_XY(i: int) -> Tuple[int, int]:
    return _S()[i]
