"""Row-optimized variable-base scalar multiplication.

Implements the zcash/halo2 variable-base mul layout (reference
`halo2_gadgets/src/ecc/chip/mul.rs` + `mul/{incomplete,complete,
overflow}.rs`; spec: halo2 book "variable-base scalar multiplication"):

  * the scalar alpha (a base-field cell) is extended to k = alpha + t_q
    and decomposed MSB-first into 255 bits via a running sum z_i = 2
    z_{i+1} + k_i;
  * bits 254..4 use x-only INCOMPLETE double-and-add at one row per bit,
    split into "hi" (125 bits) and "lo" (126 bits) halves that share rows
    in non-overlapping column sets; each row carries (z, x_A, lambda_1,
    lambda_2) and the accumulator's y is never materialized - it is the
    derived expression y_A = (lambda_1 + lambda_2)(x_A - x_R)/2;
  * bits 3..1 use complete addition (2 rows/bit) with a decomposition
    gate on the shared z_complete column;
  * bit 0 conditionally subtracts the base (q_mul_lsb gate);
  * an overflow check ties z_0 back to alpha + t_q (mod p) using a
    13x10-bit lookup decomposition of s = alpha + k_254 * 2^130
    (mul/overflow.rs; requires the 10-bit table to be loaded).

~137 region rows + ~16 overflow rows per mul, vs ~1530 for the bitwise
complete-add fallback in `ecc.py` (kept for lookup-free configs).

A copy of `halo2_tpu/gadgets/ecc_mul.py` on the port's front-end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..curves import Pallas
from ..fields import Fp, Fq
from ..frontend import Layouter, Region, Value
from ..plonk import ConstraintSystem
from ..plonk.expression import Constant
from ..poly import Rotation
from .ecc import EccPoint, NonIdentityEccPoint, _inv0
from .utilities import bool_check, ternary

P = Fp.MODULUS  # circuit (base) field
Q = Fq.MODULUS  # group order (scalar field)
T_Q = Q - (1 << 254)
NUM_BITS = 255
NUM_COMPLETE_BITS = 3
INCOMPLETE_LEN = NUM_BITS - 1 - NUM_COMPLETE_BITS  # 251
HI_LEN = INCOMPLETE_LEN // 2  # 125: bits 254..130
LO_LEN = INCOMPLETE_LEN - HI_LEN  # 126: bits 129..4
TWO_INV = pow(2, -1, P)
K_LOOKUP = 10  # sinsemilla::K


@dataclass
class IncompleteHalf:
    """One double-and-add column set (mul/incomplete.rs DoubleAndAdd)."""

    q_mul_1: object
    q_mul_2: object
    q_mul_3: object
    z: object
    x_a: object
    x_p: object
    y_p: object
    lambda_1: object
    lambda_2: object
    num_bits: int


def _configure_incomplete(meta: ConstraintSystem, z, x_a, x_p, y_p, l1, l2,
                          num_bits: int, tag: str) -> IncompleteHalf:
    meta.enable_equality(z)
    meta.enable_equality(l1)
    half = IncompleteHalf(
        meta.selector(), meta.selector(), meta.selector(),
        z, x_a, x_p, y_p, l1, l2, num_bits,
    )

    def x_r(cells, rot):
        xa = cells.query_advice(x_a, rot)
        xp = cells.query_advice(x_p, rot)
        lam1 = cells.query_advice(l1, rot)
        return lam1 * lam1 - xa - xp

    def y_a(cells, rot):
        xa = cells.query_advice(x_a, rot)
        lam1 = cells.query_advice(l1, rot)
        lam2 = cells.query_advice(l2, rot)
        return (lam1 + lam2) * (xa - x_r(cells, rot)) * Constant(TWO_INV)

    def for_loop(cells, y_a_next):
        one = Constant(1)
        z_cur = cells.query_advice(z, Rotation.cur())
        z_prev = cells.query_advice(z, Rotation.prev())
        x_a_cur = cells.query_advice(x_a, Rotation.cur())
        x_a_next = cells.query_advice(x_a, Rotation.next())
        x_p_cur = cells.query_advice(x_p, Rotation.cur())
        y_p_cur = cells.query_advice(y_p, Rotation.cur())
        l1_cur = cells.query_advice(l1, Rotation.cur())
        l2_cur = cells.query_advice(l2, Rotation.cur())
        y_a_cur = y_a(cells, Rotation.cur())
        k = z_cur - z_prev * Constant(2)
        checks = [bool_check(k)]
        # lambda_1 (x_A - x_P) - y_A + (2k - 1) y_P = 0
        checks.append(
            l1_cur * (x_a_cur - x_p_cur) - y_a_cur
            + (k * Constant(2) - one) * y_p_cur
        )
        # lambda_2^2 - x_{A,next} - x_R - x_A = 0
        checks.append(
            l2_cur * l2_cur - x_a_next - x_r(cells, Rotation.cur()) - x_a_cur
        )
        # lambda_2 (x_A - x_{A,next}) - y_A - y_{A,next} = 0
        checks.append(l2_cur * (x_a_cur - x_a_next) - y_a_cur - y_a_next)
        return checks

    def gate_1(cells):
        q = cells.query_selector(half.q_mul_1)
        y_a_next = y_a(cells, Rotation.next())
        y_a_witnessed = cells.query_advice(l1, Rotation.cur())
        return [q * (y_a_witnessed - y_a_next)]

    meta.create_gate(f"var-mul {tag} first row", gate_1)

    def gate_2(cells):
        q = cells.query_selector(half.q_mul_2)
        y_a_next = y_a(cells, Rotation.next())
        x_p_cur = cells.query_advice(x_p, Rotation.cur())
        x_p_next = cells.query_advice(x_p, Rotation.next())
        y_p_cur = cells.query_advice(y_p, Rotation.cur())
        y_p_next = cells.query_advice(y_p, Rotation.next())
        checks = [x_p_cur - x_p_next, y_p_cur - y_p_next]
        checks.extend(for_loop(cells, y_a_next))
        return [q * c for c in checks]

    meta.create_gate(f"var-mul {tag} main loop", gate_2)

    def gate_3(cells):
        q = cells.query_selector(half.q_mul_3)
        y_a_final = cells.query_advice(l1, Rotation.next())
        return [q * c for c in for_loop(cells, y_a_final)]

    meta.create_gate(f"var-mul {tag} last row", gate_3)
    return half


@dataclass
class VarMulConfig:
    q_mul_lsb: object
    q_mul_decompose_var: object
    q_mul_overflow: object
    hi: IncompleteHalf
    lo: IncompleteHalf
    z_complete: object  # shared with hi.z (advices[9])
    overflow_advices: Tuple[object, object, object]
    lookup: object  # LookupRangeCheckConfig


def configure_var_mul(meta: ConstraintSystem, ecc_config, lookup_config) -> VarMulConfig:
    """Wire the var-mul gates onto the EccChip's 10 advice columns
    (reference mul.rs configure: hi = [9,3,0,1,4,5], lo = [6,7,0,1,8,2])."""
    adv = ecc_config.advices
    hi = _configure_incomplete(
        meta, adv[9], adv[3], adv[0], adv[1], adv[4], adv[5], HI_LEN, "hi"
    )
    lo = _configure_incomplete(
        meta, adv[6], adv[7], adv[0], adv[1], adv[8], adv[2], LO_LEN, "lo"
    )
    z_complete = adv[9]
    meta.enable_equality(z_complete)
    for a in (adv[6], adv[7], adv[8]):
        meta.enable_equality(a)

    q_mul_decompose_var = meta.selector()

    def decompose_gate(cells):
        q = cells.query_selector(q_mul_decompose_var)
        z_prev = cells.query_advice(z_complete, Rotation.prev())
        z_next = cells.query_advice(z_complete, Rotation.next())
        k = z_next - Constant(2) * z_prev
        base_y = cells.query_advice(z_complete, Rotation.cur())
        y_p = cells.query_advice(ecc_config.y_p, Rotation.prev())
        y_switch = ternary(k, base_y - y_p, base_y + y_p)
        return [q * bool_check(k), q * y_switch]

    meta.create_gate("var-mul complete-bit decomposition", decompose_gate)

    q_mul_lsb = meta.selector()

    def lsb_gate(cells):
        q = cells.query_selector(q_mul_lsb)
        z_1 = cells.query_advice(z_complete, Rotation.cur())
        z_0 = cells.query_advice(z_complete, Rotation.next())
        x_p = cells.query_advice(ecc_config.x_p, Rotation.cur())
        y_p = cells.query_advice(ecc_config.y_p, Rotation.cur())
        base_x = cells.query_advice(ecc_config.x_p, Rotation.next())
        base_y = cells.query_advice(ecc_config.y_p, Rotation.next())
        lsb = z_0 - z_1 * Constant(2)
        lsb_x = ternary(lsb, x_p, x_p - base_x)
        lsb_y = ternary(lsb, y_p, y_p + base_y)
        return [q * bool_check(lsb), q * lsb_x, q * lsb_y]

    meta.create_gate("var-mul LSB check", lsb_gate)

    q_mul_overflow = meta.selector()
    ov = (adv[6], adv[7], adv[8])

    def overflow_gate(cells):
        q = cells.query_selector(q_mul_overflow)
        one = Constant(1)
        two_pow_124 = Constant(1 << 124)
        two_pow_130 = Constant(1 << 130)
        z_0 = cells.query_advice(ov[0], Rotation.prev())
        z_130 = cells.query_advice(ov[0], Rotation.cur())
        eta = cells.query_advice(ov[0], Rotation.next())
        k_254 = cells.query_advice(ov[1], Rotation.prev())
        alpha = cells.query_advice(ov[1], Rotation.cur())
        s_minus_lo_130 = cells.query_advice(ov[1], Rotation.next())
        s = cells.query_advice(ov[2], Rotation.cur())
        s_check = s - (alpha + k_254 * two_pow_130)
        recovery = z_0 - alpha - Constant(T_Q % P)
        lo_zero = k_254 * (z_130 - two_pow_124)
        s_minus_check = k_254 * s_minus_lo_130
        canonicity = (one - k_254) * (one - z_130 * eta) * s_minus_lo_130
        return [
            q * s_check, q * recovery, q * lo_zero, q * s_minus_check,
            q * canonicity,
        ]

    meta.create_gate("var-mul overflow checks", overflow_gate)

    return VarMulConfig(
        q_mul_lsb, q_mul_decompose_var, q_mul_overflow, hi, lo,
        z_complete, ov, lookup_config,
    )


def _decompose_for_scalar_mul(alpha: Optional[int]) -> List[Optional[int]]:
    """255 bits of k = alpha + t_q, MSB first (mul.rs
    decompose_for_scalar_mul)."""
    if alpha is None:
        return [None] * NUM_BITS
    k = (alpha + T_Q) % (1 << 256)
    return [(k >> i) & 1 for i in range(NUM_BITS - 1, -1, -1)]


class VarMul:
    """Assignment driver (reference mul.rs assign + process_lsb)."""

    def __init__(self, ecc_chip, config: VarMulConfig):
        self.chip = ecc_chip
        self.config = config

    # ---- host point helpers (affine, python ints) ----
    @staticmethod
    def _val(cell) -> Optional[int]:
        from .poseidon import _as_int

        v = cell.value()
        if v.is_none():
            return None
        return _as_int(v.force_value(), P)

    def assign(self, layouter: Layouter, alpha, base: NonIdentityEccPoint
               ) -> Tuple[EccPoint, object]:
        """alpha: AssignedCell of a base-field element; returns
        ([alpha]base, alpha)."""
        cfg = self.config
        chip = self.chip
        ecc = chip.config

        def in_region(region: Region):
            base_x = self._val(base.x)
            base_y = self._val(base.y)
            alpha_v = self._val(alpha)
            bits = _decompose_for_scalar_mul(alpha_v)

            # init: Acc = [2]base via complete addition (row 0)
            acc = chip._assign_complete_add(region, 0, base, base)
            offset = 1

            # z_init = 0 at (hi.z, offset)
            z_init = region.assign_advice(cfg.hi.z, offset, Value.known(0), "z_init")
            region.constrain_constant(z_init.cell(), 0)

            x_a, y_a_cell, y_a_val, zs_hi = self._double_and_add(
                region, offset, cfg.hi, (base_x, base_y), bits[:HI_LEN],
                acc.x, acc.y, self._val(acc.x), self._val(acc.y), z_init,
            )
            x_a, y_a_cell, y_a_val, zs_lo = self._double_and_add(
                region, offset, cfg.lo, (base_x, base_y),
                bits[HI_LEN:INCOMPLETE_LEN],
                x_a, y_a_cell, self._val(x_a), y_a_val, zs_hi[-1],
            )

            offset_c = offset + LO_LEN + 2
            acc, zs_complete = self._complete_rounds(
                region, offset_c, bits[INCOMPLETE_LEN:INCOMPLETE_LEN + 3],
                base, x_a, y_a_cell, zs_lo[-1],
            )

            offset_lsb = offset_c + 2 * NUM_COMPLETE_BITS
            result, z_0 = self._process_lsb(
                region, offset_lsb, base, acc, zs_complete[-1], bits[-1]
            )

            # sanity: honest witness must produce [alpha] base (skipped in
            # the floor planner's shape pass, where cells carry no values)
            rx, ry = self._val(result.x), self._val(result.y)
            if None not in (alpha_v, base_x, rx, ry):
                expect = Pallas.from_xy(base_x, base_y).mul(alpha_v % Q)
                got = (
                    Pallas.identity()
                    if (rx == 0 and ry == 0)
                    else Pallas.from_xy(rx, ry)
                )
                assert got == expect, "var-mul witness mismatch"

            zs = [z_init] + zs_hi[1:] + zs_lo[1:] + zs_complete + [z_0]
            assert len(zs) == NUM_BITS + 1
            zs.reverse()  # zs[i] = z_i
            return result, zs

        result, zs = layouter.assign_region("variable-base scalar mul", in_region)
        self._overflow_check(layouter, alpha, zs)
        return result, alpha

    def _double_and_add(self, region: Region, offset: int, half: IncompleteHalf,
                        base_xy, bits, x_a_cell, y_a_cell, x_a_val, y_a_val,
                        z_cell):
        """mul/incomplete.rs double_and_add; returns (x_a cell, final y_a
        cell, final y_a value, [z cells incl. the copied-in start])."""
        region.enable_selector(half.q_mul_1, offset)
        for idx in range(half.num_bits - 1):
            region.enable_selector(half.q_mul_2, offset + 1 + idx)
        region.enable_selector(half.q_mul_3, offset + half.num_bits)

        base_x, base_y = base_xy
        z = z_cell.copy_advice(region, half.z, offset, "starting z")
        x_a = x_a_cell.copy_advice(region, half.x_a, offset + 1, "starting x_a")
        y_a_cell.copy_advice(region, half.lambda_1, offset, "starting y_a")

        zs = [z]
        x_a_v, y_a_v = x_a_val, y_a_val
        row = offset + 1
        for k in bits:
            z_val = (
                Value.unknown()
                if k is None or z.value().is_none()
                else Value.known((2 * self._val(z) + k) % P)
            )
            z = region.assign_advice(half.z, row, z_val, "z")
            zs.append(z)
            region.assign_advice(
                half.x_p, row,
                Value.known(base_x) if base_x is not None else Value.unknown(),
                "x_p",
            )
            region.assign_advice(
                half.y_p, row,
                Value.known(base_y) if base_y is not None else Value.unknown(),
                "y_p",
            )
            known = None not in (k, x_a_v, y_a_v, base_x, base_y)
            if known:
                y_p_used = base_y if k else (P - base_y) % P
                lam1 = (y_a_v - y_p_used) * _inv0(x_a_v - base_x) % P
                x_r = (lam1 * lam1 - x_a_v - base_x) % P
                lam2 = (2 * y_a_v * _inv0(x_a_v - x_r) - lam1) % P
                x_a_new = (lam2 * lam2 - x_a_v - x_r) % P
                y_a_new = (lam2 * (x_a_v - x_a_new) - y_a_v) % P
                region.assign_advice(half.lambda_1, row, Value.known(lam1), "lambda1")
                region.assign_advice(half.lambda_2, row, Value.known(lam2), "lambda2")
                x_a = region.assign_advice(
                    half.x_a, row + 1, Value.known(x_a_new), "x_a"
                )
                x_a_v, y_a_v = x_a_new, y_a_new
            else:
                region.assign_advice(half.lambda_1, row, Value.unknown(), "lambda1")
                region.assign_advice(half.lambda_2, row, Value.unknown(), "lambda2")
                x_a = region.assign_advice(half.x_a, row + 1, Value.unknown(), "x_a")
                x_a_v = y_a_v = None
            row += 1

        y_a = region.assign_advice(
            half.lambda_1, offset + 1 + half.num_bits,
            Value.known(y_a_v) if y_a_v is not None else Value.unknown(),
            "y_a",
        )
        return x_a, y_a, y_a_v, zs

    def _complete_rounds(self, region: Region, offset: int, bits, base,
                         x_a, y_a, z):
        """mul/complete.rs assign_region: 3 bits, 2 rows each."""
        cfg = self.config
        chip = self.chip
        ecc = chip.config
        base_y = self._val(base.y)

        for it in range(len(bits)):
            region.enable_selector(cfg.q_mul_decompose_var, offset + 2 * it + 1)

        acc = EccPoint(x_a, y_a)
        z = z.copy_advice(region, cfg.z_complete, offset, "z from incomplete")
        zs = []
        for it, k in enumerate(bits):
            row = offset + 2 * it
            z_val = (
                Value.unknown()
                if k is None or z.value().is_none()
                else Value.known((2 * self._val(z) + k) % P)
            )
            z = region.assign_advice(cfg.z_complete, row + 2, z_val, "z")
            zs.append(z)
            base_y_cell = base.y.copy_advice(
                region, cfg.z_complete, row + 1, "base.y"
            )
            if k is None or base_y is None:
                y_p_val = Value.unknown()
            else:
                y_p_val = Value.known(base_y if k else (P - base_y) % P)
            y_p = region.assign_advice(ecc.y_p, row, y_p_val, "y_p")
            u = EccPoint(base.x, y_p)
            tmp = chip._assign_complete_add(region, row, u, acc)
            acc = chip._assign_complete_add(region, row + 1, acc, tmp)
        return acc, zs

    def _process_lsb(self, region: Region, offset: int, base, acc, z_1, lsb):
        cfg = self.config
        chip = self.chip
        ecc = chip.config
        region.enable_selector(cfg.q_mul_lsb, offset)
        if lsb is None or z_1.value().is_none():
            z0_val = Value.unknown()
        else:
            z0_val = Value.known((2 * self._val(z_1) + lsb) % P)
        z_0 = region.assign_advice(cfg.z_complete, offset + 1, z0_val, "z_0")
        base.x.copy_advice(region, ecc.x_p, offset + 1, "base_x")
        base.y.copy_advice(region, ecc.y_p, offset + 1, "base_y")

        base_x, base_y = self._val(base.x), self._val(base.y)
        if lsb is None or base_x is None:
            xv = yv = Value.unknown()
        elif lsb:
            xv, yv = Value.known(0), Value.known(0)
        else:
            xv, yv = Value.known(base_x), Value.known((P - base_y) % P)
        x_cell = region.assign_advice(ecc.x_p, offset, xv, "x")
        y_cell = region.assign_advice(ecc.y_p, offset, yv, "y")
        p = EccPoint(x_cell, y_cell)
        result = chip._assign_complete_add(region, offset, p, acc)
        return result, z_0

    def _overflow_check(self, layouter: Layouter, alpha, zs):
        """mul/overflow.rs overflow_check."""
        cfg = self.config
        ov = cfg.overflow_advices
        alpha_v = self._val(alpha)
        k254_v = self._val(zs[254])

        def s_region(region: Region):
            if alpha_v is None or k254_v is None:
                sv = Value.unknown()
            else:
                sv = Value.known((alpha_v + k254_v * (1 << 130)) % P)
            return region.assign_advice(ov[0], 0, sv, "s")

        s = layouter.assign_region("s = alpha + k_254 * 2^130", s_region)

        num_words = 130 // K_LOOKUP
        s_zs = cfg.lookup.copy_check(
            layouter.namespace("decompose s_{0..=129}"), s, num_words, False
        )
        s_minus_lo_130 = s_zs[-1]

        def in_region(region: Region):
            region.enable_selector(cfg.q_mul_overflow, 1)
            zs[0].copy_advice(region, ov[0], 0, "z_0")
            zs[130].copy_advice(region, ov[0], 1, "z_130")
            z130 = self._val(zs[130])
            eta = (
                Value.unknown() if z130 is None else Value.known(_inv0(z130))
            )
            region.assign_advice(ov[0], 2, eta, "eta")
            zs[254].copy_advice(region, ov[1], 0, "k_254")
            alpha.copy_advice(region, ov[1], 1, "alpha")
            s_minus_lo_130.copy_advice(region, ov[1], 2, "s_minus_lo_130")
            s.copy_advice(region, ov[2], 1, "s")

        layouter.assign_region("overflow check", in_region)
