"""In-circuit elliptic-curve chip over Pallas (base field Fp).

Mirrors the core of `halo2_gadgets/src/ecc/chip/`:
  * witness_point: q_point gate `x|y * (y^2 - x^3 - b) = 0` allowing the
    identity encoded as (0, 0), and q_point_non_id requiring on-curve
    (witness_point.rs:48-89),
  * add_incomplete: 2-row incomplete addition gate (add_incomplete.rs:57-81),
  * add: the 12-constraint complete addition gate with inv0 hint columns
    alpha/beta/gamma/delta (add.rs:91-207),
  * variable-base scalar mul.

Layout note (documented deviation): `mul` is built as a bit-wise
double-and-add over the complete-addition gate with a boolean-select gate
per bit, rather than the reference's incomplete hi/lo-half decomposition
with final complete rounds (ecc/chip/mul.rs) - same instruction semantics
and soundness, more rows; adopting the reference's row-optimized
decomposition is follow-up work.

A copy of `halo2_tpu/gadgets/ecc.py` on the port's front-end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Type

from ..curves import Pallas
from ..fields import Fp
from ..frontend import AssignedCell, Layouter, Region, Value
from ..plonk.constraint_system import ConstraintSystem
from ..plonk.expression import Constant
from ..poly import Rotation
from .poseidon import _as_int
from .utilities import bool_check

P = Fp.MODULUS
B_COEFF = Pallas.B


def _inv0(v: int) -> int:
    return 0 if v % P == 0 else pow(v, -1, P)


@dataclass
class EccPoint:
    """A curve point; the identity is encoded as (0, 0) (chip.rs EccPoint)."""

    x: AssignedCell
    y: AssignedCell

    def point(self) -> Value:
        if self.x.value().is_none() or self.y.value().is_none():
            return Value.unknown()
        xv = _as_int(self.x.value().force_value(), P)
        yv = _as_int(self.y.value().force_value(), P)
        from ..curves import Point

        if xv == 0 and yv == 0:
            return Value.known(Point(Pallas, None))
        return Value.known(Point(Pallas, (xv, yv)))


class NonIdentityEccPoint(EccPoint):
    pass


@dataclass
class EccConfig:
    advices: List[object]  # 10 advice columns (chip.rs:1-130)
    q_point: object
    q_point_non_id: object
    q_add_incomplete: object
    q_add: object
    q_mul_bit: object
    # column roles
    x_p: object
    y_p: object
    x_qr: object
    y_qr: object
    lam: object
    alpha: object
    beta: object
    gamma: object
    delta: object
    # row-optimized variable-base mul (ecc_mul.py); present when the chip
    # was configured with a 10-bit lookup config (reference mul.rs)
    var_mul: object = None


class EccChip:
    def __init__(self, config: EccConfig):
        self.config = config

    @staticmethod
    def configure(meta: ConstraintSystem, advices, lookup_config=None) -> EccConfig:
        assert len(advices) == 10
        for col in advices:
            meta.enable_equality(col)
        x_p, y_p, x_qr, y_qr, lam, alpha, beta, gamma, delta, bit_col = advices

        q_point = meta.selector()
        q_point_non_id = meta.selector()
        q_add_incomplete = meta.selector()
        q_add = meta.selector()
        q_mul_bit = meta.selector()

        def curve_eqn(cells, xc, yc):
            x = cells.query_advice(xc, Rotation.cur())
            y = cells.query_advice(yc, Rotation.cur())
            return y * y - x * x * x - Constant(B_COEFF)

        def witness_gate(cells):
            q = cells.query_selector(q_point)
            x = cells.query_advice(x_p, Rotation.cur())
            y = cells.query_advice(y_p, Rotation.cur())
            eqn = curve_eqn(cells, x_p, y_p)
            return [q * x * eqn, q * y * eqn]

        meta.create_gate("witness point", witness_gate)

        def witness_non_id_gate(cells):
            q = cells.query_selector(q_point_non_id)
            return [q * curve_eqn(cells, x_p, y_p)]

        meta.create_gate("witness non-identity point", witness_non_id_gate)

        def incomplete_gate(cells):
            q = cells.query_selector(q_add_incomplete)
            xp = cells.query_advice(x_p, Rotation.cur())
            yp = cells.query_advice(y_p, Rotation.cur())
            xq = cells.query_advice(x_qr, Rotation.cur())
            yq = cells.query_advice(y_qr, Rotation.cur())
            xr = cells.query_advice(x_qr, Rotation.next())
            yr = cells.query_advice(y_qr, Rotation.next())
            poly1 = (xr + xq + xp) * (xp - xq) * (xp - xq) - (yp - yq) * (yp - yq)
            poly2 = (yr + yq) * (xp - xq) - (yp - yq) * (xq - xr)
            return [q * poly1, q * poly2]

        meta.create_gate("incomplete addition", incomplete_gate)

        def complete_gate(cells):
            q = cells.query_selector(q_add)
            xp = cells.query_advice(x_p, Rotation.cur())
            yp = cells.query_advice(y_p, Rotation.cur())
            xq = cells.query_advice(x_qr, Rotation.cur())
            yq = cells.query_advice(y_qr, Rotation.cur())
            xr = cells.query_advice(x_qr, Rotation.next())
            yr = cells.query_advice(y_qr, Rotation.next())
            lmb = cells.query_advice(lam, Rotation.cur())
            al = cells.query_advice(alpha, Rotation.cur())
            be = cells.query_advice(beta, Rotation.cur())
            ga = cells.query_advice(gamma, Rotation.cur())
            de = cells.query_advice(delta, Rotation.cur())

            one = Constant(1)
            xq_minus_xp = xq - xp
            xp_minus_xr = xp - xr
            yq_plus_yp = yq + yp
            if_alpha = xq_minus_xp * al
            if_beta = xp * be
            if_gamma = xq * ga
            if_delta = yq_plus_yp * de

            poly1 = xq_minus_xp * (xq_minus_xp * lmb - (yq - yp))
            poly2 = (one - if_alpha) * (lmb * yp * 2 - xp * xp * 3)
            nonexceptional_x_r = lmb * lmb - xp - xq - xr
            nonexceptional_y_r = lmb * xp_minus_xr - yp - yr
            poly3a = xp * xq * xq_minus_xp * nonexceptional_x_r
            poly3b = xp * xq * xq_minus_xp * nonexceptional_y_r
            poly3c = xp * xq * yq_plus_yp * nonexceptional_x_r
            poly3d = xp * xq * yq_plus_yp * nonexceptional_y_r
            poly4a = (one - if_beta) * (xr - xq)
            poly4b = (one - if_beta) * (yr - yq)
            poly5a = (one - if_gamma) * (xr - xp)
            poly5b = (one - if_gamma) * (yr - yp)
            poly6a = (one - if_alpha - if_delta) * xr
            poly6b = (one - if_alpha - if_delta) * yr
            return [
                q * e
                for e in (
                    poly1, poly2, poly3a, poly3b, poly3c, poly3d,
                    poly4a, poly4b, poly5a, poly5b, poly6a, poly6b,
                )
            ]

        meta.create_gate("complete addition", complete_gate)

        def mul_bit_gate(cells):
            """Select gate: out = bit ? cand : acc (bit is boolean).

            Row layout: bit | x_acc y_acc (x_p,y_p) | x_cand y_cand
            (x_qr,y_qr) | x_out y_out (x_qr,y_qr at next)."""
            q = cells.query_selector(q_mul_bit)
            b = cells.query_advice(bit_col, Rotation.cur())
            x_acc = cells.query_advice(x_p, Rotation.cur())
            y_acc = cells.query_advice(y_p, Rotation.cur())
            x_cand = cells.query_advice(x_qr, Rotation.cur())
            y_cand = cells.query_advice(y_qr, Rotation.cur())
            x_out = cells.query_advice(x_qr, Rotation.next())
            y_out = cells.query_advice(y_qr, Rotation.next())
            one = Constant(1)
            return [
                q * bool_check(b),
                q * (x_out - (b * x_cand + (one - b) * x_acc)),
                q * (y_out - (b * y_cand + (one - b) * y_acc)),
            ]

        meta.create_gate("mul bit select", mul_bit_gate)

        config = EccConfig(
            list(advices), q_point, q_point_non_id, q_add_incomplete, q_add,
            q_mul_bit, x_p, y_p, x_qr, y_qr, lam, alpha, beta, gamma, delta,
        )
        if lookup_config is not None:
            # row-optimized variable-base mul needs the 10-bit range table
            from .ecc_mul import configure_var_mul

            config.var_mul = configure_var_mul(meta, config, lookup_config)
        return config

    # ---- instructions ----
    def witness_point(self, layouter: Layouter, value: Value) -> EccPoint:
        """value: Value of a host Point (identity -> (0,0))."""
        config = self.config

        def in_region(region: Region):
            region.enable_selector(config.q_point, 0)
            if value.is_none():
                xv = yv = Value.unknown()
            else:
                pt = value.force_value()
                if pt.is_identity():
                    xv, yv = Value.known(0), Value.known(0)
                else:
                    xv, yv = Value.known(pt.xy[0]), Value.known(pt.xy[1])
            x = region.assign_advice(config.x_p, 0, xv, "x")
            y = region.assign_advice(config.y_p, 0, yv, "y")
            return EccPoint(x, y)

        return layouter.assign_region("witness point", in_region)

    def witness_point_non_id(self, layouter: Layouter, value: Value) -> NonIdentityEccPoint:
        config = self.config

        def in_region(region: Region):
            region.enable_selector(config.q_point_non_id, 0)
            if value.is_none():
                xv = yv = Value.unknown()
            else:
                pt = value.force_value()
                assert not pt.is_identity()
                xv, yv = Value.known(pt.xy[0]), Value.known(pt.xy[1])
            x = region.assign_advice(config.x_p, 0, xv, "x")
            y = region.assign_advice(config.y_p, 0, yv, "y")
            return NonIdentityEccPoint(x, y)

        return layouter.assign_region("witness non-identity point", in_region)

    def _vals(self, pt: EccPoint) -> Optional[Tuple[int, int]]:
        if pt.x.value().is_none() or pt.y.value().is_none():
            return None
        return (
            _as_int(pt.x.value().force_value(), P),
            _as_int(pt.y.value().force_value(), P),
        )

    def add_incomplete(self, layouter: Layouter, p: EccPoint, q: EccPoint) -> EccPoint:
        config = self.config

        def in_region(region: Region):
            region.enable_selector(config.q_add_incomplete, 0)
            p.x.copy_advice(region, config.x_p, 0, "x_p")
            p.y.copy_advice(region, config.y_p, 0, "y_p")
            q.x.copy_advice(region, config.x_qr, 0, "x_q")
            q.y.copy_advice(region, config.y_qr, 0, "y_q")
            pv, qv = self._vals(p), self._vals(q)
            if pv is None or qv is None:
                xr = yr = Value.unknown()
            else:
                (xp, yp), (xq, yq) = pv, qv
                assert not (xp == 0 and yp == 0) and not (xq == 0 and yq == 0)
                assert xp != xq, "incomplete addition exceptional case"
                lmb = (yq - yp) * _inv0(xq - xp) % P
                x_r = (lmb * lmb - xp - xq) % P
                y_r = (lmb * (xp - x_r) - yp) % P
                xr, yr = Value.known(x_r), Value.known(y_r)
            x = region.assign_advice(config.x_qr, 1, xr, "x_r")
            y = region.assign_advice(config.y_qr, 1, yr, "y_r")
            return EccPoint(x, y)

        return layouter.assign_region("incomplete point addition", in_region)

    def _assign_complete_add(self, region: Region, offset: int, p: EccPoint,
                             q: EccPoint) -> EccPoint:
        config = self.config
        region.enable_selector(config.q_add, offset)
        p.x.copy_advice(region, config.x_p, offset, "x_p")
        p.y.copy_advice(region, config.y_p, offset, "y_p")
        q.x.copy_advice(region, config.x_qr, offset, "x_q")
        q.y.copy_advice(region, config.y_qr, offset, "y_q")
        pv, qv = self._vals(p), self._vals(q)
        if pv is None or qv is None:
            for col in (config.alpha, config.beta, config.gamma, config.delta, config.lam):
                region.assign_advice(col, offset, Value.unknown(), "hint")
            x = region.assign_advice(config.x_qr, offset + 1, Value.unknown(), "x_r")
            y = region.assign_advice(config.y_qr, offset + 1, Value.unknown(), "y_r")
            return EccPoint(x, y)

        (xp, yp), (xq, yq) = pv, qv
        alpha = _inv0(xq - xp)
        beta = _inv0(xp)
        gamma = _inv0(xq)
        delta = _inv0(yq + yp) if xq == xp else 0
        if xq != xp:
            lmb = (yq - yp) * alpha % P
        elif yp != 0:
            lmb = 3 * xp * xp % P * _inv0(2 * yp) % P
        else:
            lmb = 0
        region.assign_advice(config.alpha, offset, Value.known(alpha), "alpha")
        region.assign_advice(config.beta, offset, Value.known(beta), "beta")
        region.assign_advice(config.gamma, offset, Value.known(gamma), "gamma")
        region.assign_advice(config.delta, offset, Value.known(delta), "delta")
        region.assign_advice(config.lam, offset, Value.known(lmb), "lambda")

        if xp == 0 and yp == 0:
            x_r, y_r = xq, yq
        elif xq == 0 and yq == 0:
            x_r, y_r = xp, yp
        elif xq == xp and (yq + yp) % P == 0:
            x_r, y_r = 0, 0
        else:
            x_r = (lmb * lmb - xp - xq) % P
            y_r = (lmb * (xp - x_r) - yp) % P
        x = region.assign_advice(config.x_qr, offset + 1, Value.known(x_r), "x_r")
        y = region.assign_advice(config.y_qr, offset + 1, Value.known(y_r), "y_r")
        return EccPoint(x, y)

    def add(self, layouter: Layouter, p: EccPoint, q: EccPoint) -> EccPoint:
        return layouter.assign_region(
            "complete point addition",
            lambda region: self._assign_complete_add(region, 0, p, q),
        )

    def mul(self, layouter: Layouter, scalar: Value, base: EccPoint,
            num_bits: int = 255) -> Tuple[EccPoint, Value]:
        """Variable-base scalar mul: [scalar] base via double-and-add with
        complete additions and per-bit boolean selects."""
        config = self.config
        chip = self

        def in_region(region: Region):
            bit_col = config.advices[9]
            offset = 0
            # start from the identity
            acc_x = region.assign_advice(config.x_qr, offset, Value.known(0), "acc0_x")
            acc_y = region.assign_advice(config.y_qr, offset, Value.known(0), "acc0_y")
            region.constrain_constant(acc_x.cell(), 0)
            region.constrain_constant(acc_y.cell(), 0)
            acc = EccPoint(acc_x, acc_y)
            offset += 1

            known = not scalar.is_none()
            bits = []
            if known:
                s = _as_int(scalar.force_value(), Pallas.SCALAR.MODULUS)
                bits = [(s >> i) & 1 for i in range(num_bits)][::-1]  # MSB first
            for i in range(num_bits):
                # double
                acc = chip._assign_complete_add(region, offset, acc, acc)
                offset += 2
                # candidate = acc + base
                cand = chip._assign_complete_add(region, offset, acc, base)
                offset += 2
                # select
                region.enable_selector(config.q_mul_bit, offset)
                bv = Value.known(bits[i]) if known else Value.unknown()
                region.assign_advice(bit_col, offset, bv, f"bit_{i}")
                acc.x.copy_advice(region, config.x_p, offset, "acc_x")
                acc.y.copy_advice(region, config.y_p, offset, "acc_y")
                cand.x.copy_advice(region, config.x_qr, offset, "cand_x")
                cand.y.copy_advice(region, config.y_qr, offset, "cand_y")
                av, cv = chip._vals(acc), chip._vals(cand)
                if known and av is not None and cv is not None:
                    sel = cv if bits[i] else av
                    xo, yo = Value.known(sel[0]), Value.known(sel[1])
                else:
                    xo = yo = Value.unknown()
                x = region.assign_advice(config.x_qr, offset + 1, xo, "out_x")
                y = region.assign_advice(config.y_qr, offset + 1, yo, "out_y")
                acc = EccPoint(x, y)
                offset += 2
            return acc

        result = layouter.assign_region("variable-base mul", in_region)
        return result, scalar

    def mul_var(self, layouter: Layouter, alpha, base: NonIdentityEccPoint):
        """Row-optimized variable-base mul (reference ecc/chip/mul.rs):
        ~137 rows + a 13-word overflow lookup, vs ~1530 for `mul`. `alpha`
        is a base-field AssignedCell (or a Value, witnessed here); needs
        the chip configured with a lookup_config and the 10-bit table
        loaded."""
        assert self.config.var_mul is not None, (
            "EccChip.configure(..., lookup_config=...) required for mul_var"
        )
        from .ecc_mul import VarMul
        from .utilities import load_private

        if isinstance(alpha, Value):
            alpha = load_private(layouter, self.config.advices[0], alpha)
        return VarMul(self, self.config.var_mul).assign(layouter, alpha, base)
