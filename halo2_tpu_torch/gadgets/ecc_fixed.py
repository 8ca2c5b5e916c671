"""Fixed-base scalar multiplication for the ECC chip.

Mirrors `halo2_gadgets/src/ecc/chip/mul_fixed{.rs,/full_width.rs,/short.rs,
/base_field_elem.rs}` and `ecc/chip/constants.rs`:

  * 3-bit windowed decomposition (H = 8 points per window, 85 windows for a
    full-width Pallas scalar, 22 for a 64-bit short scalar)
    (constants.rs:11-35),
  * per-window multiples `[(k+2)*8^w]B` with the MSB window correcting the
    accumulated +2 offsets (constants.rs:40-82),
  * per-window x-coordinate Lagrange interpolation polynomials stored in 8
    fixed columns, and per-window `z` values with witnessed `u = sqrt(y+z)`
    certifying the y-coordinate (constants.rs:86-148, mul_fixed.rs:106-171),
  * full-width variant witnessing windows directly with a 3-bit range check
    (mul_fixed/full_width.rs:34-51),
  * short signed variant: running-sum magnitude decomposition + sign gate
    (mul_fixed/short.rs:35-77),
  * base-field-element variant: running-sum decomposition + canonicity
    checks via 10-bit lookups (mul_fixed/base_field_elem.rs:59-160).

Host-side constants (`compute_window_table`, `compute_lagrange_coeffs`,
`find_zs_and_us`) are computed in pure Python over the host bigint curve
layer; `find_zs_and_us` results are cached on disk because the z-search is
a ~2^16-deep rejection sample per window.

A copy of `halo2_tpu/gadgets/ecc_fixed.py` on the port's front-end; its zs/us cache lives
under halo2_tpu_torch/_cache.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional, Sequence, Tuple

from ..curves import Pallas, Point
from ..fields import Fp
from ..frontend import AssignedCell, Layouter, Region, Value
from ..plonk.constraint_system import ConstraintSystem
from ..plonk.expression import Constant
from ..poly import Rotation, lagrange_interpolate_host
from ..poly.ipa import publish_file
from .ecc import EccChip, EccConfig, EccPoint, NonIdentityEccPoint, _inv0
from .poseidon import _as_int
from .utilities import (
    LookupRangeCheckConfig,
    RunningSumConfig,
    bitrange_subset,
    bool_check,
    decompose_word,
    range_check,
)

FIXED_BASE_WINDOW_SIZE = 3
H = 1 << FIXED_BASE_WINDOW_SIZE  # 8
# Number of 3-bit windows in a full-width (255-bit) Pallas scalar.
NUM_WINDOWS = (255 + FIXED_BASE_WINDOW_SIZE - 1) // FIXED_BASE_WINDOW_SIZE  # 85
L_SCALAR_SHORT = 64
NUM_WINDOWS_SHORT = (L_SCALAR_SHORT + FIXED_BASE_WINDOW_SIZE - 1) // FIXED_BASE_WINDOW_SIZE  # 22

# Pallas base field modulus is p = 2^254 + T_P (constants.rs:33-35).
T_P = 45560315531419706090280762371685220353

P = Fp.MODULUS


# ---------------------------------------------------------------------------
# Host-side window-table constants (constants.rs)
# ---------------------------------------------------------------------------


def compute_window_table(base: Point, num_windows: int) -> List[List[Point]]:
    """Multiples [(k+2)*8^w]B for w < num_windows-1, and
    [k*8^(nw-1) - sum]B for the last window (constants.rs:40-82)."""
    q = base.curve.SCALAR.MODULUS
    table = []
    for w in range(num_windows - 1):
        table.append([base.mul((k + 2) * pow(H, w, q) % q) for k in range(H)])
    s = sum(1 << (FIXED_BASE_WINDOW_SIZE * j + 1) for j in range(num_windows - 1))
    last = [base.mul((k * pow(H, num_windows - 1, q) - s) % q) for k in range(H)]
    table.append(last)
    return table


def compute_lagrange_coeffs(base: Point, num_windows: int) -> List[List[int]]:
    """Per-window interpolation coefficients of k -> x([(k+2)*8^w]B)
    (constants.rs:86-106)."""
    F = base.curve.BASE
    points = list(range(H))
    out = []
    for window_points in compute_window_table(base, num_windows):
        xs = [pt.xy[0] for pt in window_points]
        out.append(lagrange_interpolate_host(points, xs, F))
    return out


def _jacobi(a: int, n: int) -> int:
    """Jacobi symbol (a/n), n odd positive; equals Legendre for prime n."""
    a %= n
    result = 1
    while a != 0:
        while a % 2 == 0:
            a //= 2
            if n % 8 in (3, 5):
                result = -result
        a, n = n, a
        if a % 4 == 3 and n % 4 == 3:
            result = -result
        a %= n
    return result if n == 1 else 0


def _is_square(v: int, p: int) -> bool:
    return v % p == 0 or _jacobi(v, p) == 1


def find_zs_and_us(base: Point, num_windows: int) -> List[Tuple[int, List[int]]]:
    """For each window find z with: z+y a square and z-y a non-square for all
    8 window points; return (z, us) with us[k]^2 = z + y_k
    (constants.rs:117-148)."""
    F = base.curve.BASE
    p = F.MODULUS
    out = []
    for window_points in compute_window_table(base, num_windows):
        ys = [pt.xy[1] for pt in window_points]
        for z in range(1000 * (1 << (2 * H))):
            ok = True
            for y in ys:
                if _is_square(z - y, p) or not _is_square(z + y, p):
                    ok = False
                    break
            if ok:
                us = [F((z + y) % p).sqrt().v for y in ys]
                out.append((z, us))
                break
        else:
            raise ValueError("no z found for window")
    return out


_ZS_US_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_cache")


def find_zs_and_us_cached(base: Point, num_windows: int) -> List[Tuple[int, List[int]]]:
    """`find_zs_and_us`, cached in halo2_tpu_torch/_cache/zs_us_<key>.json
    (the JAX package's file names and contents: the key is the blake2b of
    the base and the window count). A new file is published through a
    temporary name of this process's own, so a concurrent reader never
    sees half of one."""
    key = hashlib.blake2b(
        base.to_bytes() + num_windows.to_bytes(2, "little"), digest_size=16
    ).hexdigest()
    path = os.path.join(_ZS_US_CACHE_DIR, f"zs_us_{key}.json")
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
        return [(z, [int(u, 16) for u in us]) for z, us in data]
    res = find_zs_and_us(base, num_windows)
    data = json.dumps([[z, [hex(u) for u in us]] for z, us in res])
    publish_file(path, data.encode())
    return res


class FixedPointBase:
    """A fixed base with its precomputed circuit constants (the analogue of
    an impl of the reference's `FixedPoint` trait: generator(), u(), z(),
    lagrange_coeffs())."""

    def __init__(self, generator: Point, num_windows: int = NUM_WINDOWS):
        assert not generator.is_identity()
        self.generator = generator
        self.num_windows = num_windows
        self.lagrange_coeffs = compute_lagrange_coeffs(generator, num_windows)
        zs_us = find_zs_and_us_cached(generator, num_windows)
        self.z = [z for z, _ in zs_us]
        self.u = [us for _, us in zs_us]


# ---------------------------------------------------------------------------
# Scalar wrappers (chip.rs EccScalarFixed / EccScalarFixedShort /
# EccBaseFieldElemFixed)
# ---------------------------------------------------------------------------


class EccScalarFixed:
    def __init__(self, value: Value, windows: List[AssignedCell]):
        self.value = value
        self.windows = windows


class EccScalarFixedShort:
    def __init__(self, magnitude: AssignedCell, sign: AssignedCell,
                 running_sum: List[AssignedCell]):
        self.magnitude = magnitude
        self.sign = sign
        self.running_sum = running_sum


class EccBaseFieldElemFixed:
    def __init__(self, base_field_elem: AssignedCell, running_sum: List[AssignedCell]):
        self.base_field_elem = base_field_elem
        self.running_sum = running_sum


def _windows_of(scalar) -> List[Optional[int]]:
    """3-bit window values (ints, or None when unknown) of a decomposed
    scalar (mul_fixed.rs:440-497)."""
    if isinstance(scalar, EccScalarFixed):
        out = []
        for cell in scalar.windows:
            v = cell.value()
            out.append(None if v.is_none() else _as_int(v.force_value(), P))
        return out
    zs = scalar.running_sum
    out = []
    for i in range(len(zs) - 1):
        zc, zn = zs[i].value(), zs[i + 1].value()
        if zc.is_none() or zn.is_none():
            out.append(None)
        else:
            word = (_as_int(zc.force_value(), P) - _as_int(zn.force_value(), P) * H) % P
            out.append(word & (H - 1))
    return out


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


class MulFixedConfig:
    """Shared fixed-base mul configuration (mul_fixed.rs Config).

    Column roles on top of `EccConfig`:
      * 8 fixed `lagrange` columns + 1 fixed `z` column,
      * `window` = advices[9] (running-sum / witnessed windows),
      * `u` = advices[4] (the lam hint column, free in mul_fixed rows),
      * canon advices = advices[5..8] for the base-field canonicity rows.
    """

    def __init__(self, meta: ConstraintSystem, ecc: EccConfig,
                 lookup: Optional[LookupRangeCheckConfig] = None):
        self.ecc = ecc
        self.lagrange = [meta.fixed_column() for _ in range(H)]
        self.fixed_z = meta.fixed_column()
        self.window = ecc.advices[9]
        self.u = ecc.advices[4]
        meta.enable_equality(self.window)
        meta.enable_equality(self.u)
        self.lookup = lookup

        # Running sum over the window column; its selector doubles as the
        # coords-check toggle for the short/base-field variants
        # (mul_fixed.rs:115-129).
        self.q_running = meta.selector()
        self.running_sum = RunningSumConfig.configure(
            meta, self.q_running, self.window, FIXED_BASE_WINDOW_SIZE, Fp
        )

        def running_coords_gate(cells):
            q = cells.query_selector(self.q_running)
            z_cur = cells.query_advice(self.window, Rotation.cur())
            z_next = cells.query_advice(self.window, Rotation.next())
            word = z_cur - z_next * H
            return [q * e for e in self._coords_check(cells, word)]

        meta.create_gate("Running sum coordinates check", running_coords_gate)

        # Full-width: windows witnessed directly; 3-bit range check + coords
        # (full_width.rs:34-51).
        self.q_full = meta.selector()

        def full_gate(cells):
            q = cells.query_selector(self.q_full)
            window = cells.query_advice(self.window, Rotation.cur())
            exprs = self._coords_check(cells, window)
            exprs.append(range_check(window, H))
            return [q * e for e in exprs]

        meta.create_gate("Full-width fixed-base scalar mul", full_gate)

        # Short signed: sign in window col, last window bit in u col
        # (short.rs:35-77).
        self.q_short = meta.selector()

        def short_gate(cells):
            q = cells.query_selector(self.q_short)
            y_p = cells.query_advice(ecc.y_p, Rotation.cur())
            y_a = cells.query_advice(ecc.y_qr, Rotation.cur())
            last_window = cells.query_advice(self.u, Rotation.cur())
            sign = cells.query_advice(self.window, Rotation.cur())
            one = Constant(1)
            return [
                q * bool_check(last_window),
                q * (sign * sign - one),
                q * ((y_p - y_a) * (y_p + y_a)),
                q * (sign * y_p - y_a),
            ]

        meta.create_gate("Short fixed-base mul gate", short_gate)

        # Base-field-element canonicity gate (base_field_elem.rs:59-160).
        self.q_base_field = meta.selector()
        self.canon_advices = [ecc.advices[5], ecc.advices[6], ecc.advices[7]]

        def canon_gate(cells):
            q = cells.query_selector(self.q_base_field)
            a0c, a1c, a2c = self.canon_advices
            alpha = cells.query_advice(a0c, Rotation.prev())
            z_84_alpha = cells.query_advice(a2c, Rotation.prev())
            two_pow_252 = Constant(1 << 252)
            alpha_0 = alpha - z_84_alpha * two_pow_252
            alpha_1 = cells.query_advice(a1c, Rotation.cur())
            alpha_2 = cells.query_advice(a2c, Rotation.cur())
            alpha_0_prime = cells.query_advice(a0c, Rotation.cur())
            z_13_alpha_0_prime = cells.query_advice(a0c, Rotation.next())
            z_44_alpha = cells.query_advice(a1c, Rotation.next())
            z_43_alpha = cells.query_advice(a2c, Rotation.next())

            alpha_0_hi_120 = z_44_alpha - z_84_alpha * Constant(1 << 120)
            a_43 = z_43_alpha - z_44_alpha * H
            canon = [
                alpha_2 * alpha_1,                      # MSB=1 => alpha_1 = 0
                alpha_2 * alpha_0_hi_120,               # MSB=1 => hi 120 bits of alpha_0 = 0
                alpha_2 * bool_check(a_43),             # MSB=1 => a_43 in {0,1}
                alpha_2 * z_13_alpha_0_prime,           # MSB=1 => alpha_0' < 2^130
            ]
            decomposition = [
                range_check(alpha_1, 1 << 2),
                bool_check(alpha_2),
                z_84_alpha - (alpha_1 + alpha_2 * Constant(1 << 2)),
            ]
            alpha_0_prime_check = alpha_0_prime - (
                alpha_0 + Constant(1 << 130) - Constant(T_P)
            )
            return [q * e for e in canon + decomposition + [alpha_0_prime_check]]

        meta.create_gate("Canonicity checks", canon_gate)

    def _coords_check(self, cells, window):
        """x interpolation, u^2 = y + z, on-curve (mul_fixed.rs:133-171)."""
        ecc = self.ecc
        y_p = cells.query_advice(ecc.y_p, Rotation.cur())
        x_p = cells.query_advice(ecc.x_p, Rotation.cur())
        z = cells.query_fixed(self.fixed_z, Rotation.cur())
        u = cells.query_advice(self.u, Rotation.cur())

        interpolated_x = Constant(0)
        window_pow = Constant(1)
        for k in range(H):
            coeff = cells.query_fixed(self.lagrange[k], Rotation.cur())
            interpolated_x = interpolated_x + window_pow * coeff
            if k + 1 < H:
                window_pow = window_pow * window

        x_check = interpolated_x - x_p
        y_check = u * u - y_p - z
        on_curve = y_p * y_p - x_p * x_p * x_p - Constant(Pallas.B)
        return [x_check, y_check, on_curve]

    # -- shared assignment helpers (mul_fixed.rs:174-407) --

    def _assign_fixed_constants(self, region: Region, offset: int,
                                base: FixedPointBase, toggle):
        for w in range(base.num_windows):
            region.enable_selector(toggle, offset + w)
            for k in range(H):
                region.assign_fixed(
                    self.lagrange[k], offset + w,
                    Value.known(base.lagrange_coeffs[w][k]), f"lagrange w={w} k={k}",
                )
            region.assign_fixed(
                self.fixed_z, offset + w, Value.known(base.z[w]), f"z w={w}"
            )

    def _process_window(self, region: Region, offset: int, w: int,
                        k: Optional[int], window_scalar: Optional[int],
                        base: FixedPointBase) -> NonIdentityEccPoint:
        """Assign mul_b = [window_scalar]B into (x_p, y_p) at offset+w and the
        u certificate (mul_fixed.rs:257-307)."""
        ecc = self.ecc
        if window_scalar is None:
            xv = yv = uv = Value.unknown()
        else:
            pt = base.generator.mul(window_scalar)
            assert not pt.is_identity()
            xv, yv = Value.known(pt.xy[0]), Value.known(pt.xy[1])
            uv = Value.known(base.u[w][k])
        x = region.assign_advice(ecc.x_p, offset + w, xv, f"mul_b_x w={w}")
        y = region.assign_advice(ecc.y_p, offset + w, yv, f"mul_b_y w={w}")
        region.assign_advice(self.u, offset + w, uv, "u")
        return NonIdentityEccPoint(x, y)

    def _incomplete_add_row(self, region: Region, offset: int,
                            mul_b: NonIdentityEccPoint,
                            acc: NonIdentityEccPoint) -> NonIdentityEccPoint:
        """One incomplete-add row at `offset`: P = mul_b in (x_p,y_p) cur,
        Q = acc copied into (x_qr,y_qr) cur, result at next row."""
        ecc = self.ecc
        region.enable_selector(ecc.q_add_incomplete, offset)
        acc.x.copy_advice(region, ecc.x_qr, offset, "acc_x")
        acc.y.copy_advice(region, ecc.y_qr, offset, "acc_y")
        mv = _point_vals(mul_b)
        av = _point_vals(acc)
        if mv is None or av is None:
            xr = yr = Value.unknown()
        else:
            (xp, yp), (xq, yq) = mv, av
            assert xp != xq, "incomplete addition exceptional case in mul_fixed"
            lmb = (yq - yp) * _inv0(xq - xp) % P
            x_r = (lmb * lmb - xp - xq) % P
            y_r = (lmb * (xq - x_r) - yq) % P
            xr, yr = Value.known(x_r), Value.known(y_r)
        x = region.assign_advice(ecc.x_qr, offset + 1, xr, "x_r")
        y = region.assign_advice(ecc.y_qr, offset + 1, yr, "y_r")
        return NonIdentityEccPoint(x, y)

    def _assign_region_inner(self, region: Region, offset: int, scalar,
                             base: FixedPointBase, toggle
                             ) -> Tuple[NonIdentityEccPoint, NonIdentityEccPoint]:
        """Windows 0..nw-2 accumulated with incomplete adds; MSB window
        returned separately (mul_fixed.rs:174-195)."""
        nw = base.num_windows
        q = base.generator.curve.SCALAR.MODULUS
        self._assign_fixed_constants(region, offset, base, toggle)
        windows = _windows_of(scalar)
        assert len(windows) == nw

        def lower_scalar(w):
            k = windows[w]
            return None if k is None else (k + 2) * pow(H, w, q) % q

        acc = self._process_window(region, offset, 0, windows[0], lower_scalar(0), base)
        for w in range(1, nw - 1):
            mul_b = self._process_window(region, offset, w, windows[w], lower_scalar(w), base)
            acc = self._incomplete_add_row(region, offset + w, mul_b, acc)

        offset_acc = sum(
            1 << (FIXED_BASE_WINDOW_SIZE * j + 1) for j in range(nw - 1)
        )
        k_msb = windows[nw - 1]
        msb_scalar = (
            None if k_msb is None else (k_msb * pow(H, nw - 1, q) - offset_acc) % q
        )
        mul_b = self._process_window(region, offset, nw - 1, k_msb, msb_scalar, base)
        return acc, mul_b


def _point_vals(pt: EccPoint) -> Optional[Tuple[int, int]]:
    if pt.x.value().is_none() or pt.y.value().is_none():
        return None
    return (_as_int(pt.x.value().force_value(), P),
            _as_int(pt.y.value().force_value(), P))


# ---------------------------------------------------------------------------
# Variants
# ---------------------------------------------------------------------------


class MulFixedFullWidth:
    """Full-width fixed-base mul (mul_fixed/full_width.rs)."""

    def __init__(self, config: MulFixedConfig, chip: EccChip):
        self.config = config
        self.chip = chip

    def _witness_windows(self, region: Region, offset: int,
                         scalar: Value) -> EccScalarFixed:
        config = self.config
        if scalar.is_none():
            words: Sequence[Optional[int]] = [None] * NUM_WINDOWS
        else:
            s = _as_int(scalar.force_value(), Pallas.SCALAR.MODULUS)
            words = decompose_word(s, 255, FIXED_BASE_WINDOW_SIZE)
        cells = []
        for idx, word in enumerate(words):
            v = Value.unknown() if word is None else Value.known(word)
            cells.append(
                region.assign_advice(config.window, offset + idx, v, f"k[{idx}]")
            )
        return EccScalarFixed(scalar, cells)

    def assign(self, layouter: Layouter, scalar: Value,
               base: FixedPointBase) -> Tuple[EccPoint, EccScalarFixed]:
        assert base.num_windows == NUM_WINDOWS
        config = self.config

        def in_region(region: Region):
            sc = self._witness_windows(region, 0, scalar)
            acc, mul_b = config._assign_region_inner(region, 0, sc, base, config.q_full)
            return sc, acc, mul_b

        sc, acc, mul_b = layouter.assign_region(
            "Full-width fixed-base mul (incomplete addition)", in_region
        )
        result = layouter.assign_region(
            "Full-width fixed-base mul (last window, complete addition)",
            lambda region: self.chip._assign_complete_add(region, 0, mul_b, acc),
        )
        return result, sc


class MulFixedShort:
    """Short signed fixed-base mul (mul_fixed/short.rs)."""

    def __init__(self, config: MulFixedConfig, chip: EccChip):
        self.config = config
        self.chip = chip

    def assign(self, layouter: Layouter, magnitude_sign: Tuple[AssignedCell, AssignedCell],
               base: FixedPointBase) -> Tuple[EccPoint, EccScalarFixedShort]:
        assert base.num_windows == NUM_WINDOWS_SHORT
        config = self.config
        magnitude, sign = magnitude_sign

        def in_region(region: Region):
            zs = config.running_sum.copy_decompose(
                region, 0, magnitude, True, L_SCALAR_SHORT, NUM_WINDOWS_SHORT
            )
            sc = EccScalarFixedShort(magnitude, sign, zs)
            acc, mul_b = config._assign_region_inner(
                region, 0, sc, base, config.q_running
            )
            return sc, acc, mul_b

        sc, acc, mul_b = layouter.assign_region(
            "Short fixed-base mul (incomplete addition)", in_region
        )

        def last_region(region: Region):
            magnitude_mul = self.chip._assign_complete_add(region, 0, mul_b, acc)
            offset = 1
            sgn = sign.copy_advice(region, config.window, offset, "sign")
            # last window copied into the u column (a free cell) (short.rs:172-176)
            sc.running_sum[NUM_WINDOWS_SHORT - 1].copy_advice(
                region, config.u, offset, "last_window"
            )
            region.enable_selector(config.q_short, offset)
            sv, yv = sgn.value(), magnitude_mul.y.value()
            if sv.is_none() or yv.is_none():
                y_final = Value.unknown()
            else:
                y = _as_int(yv.force_value(), P)
                neg = _as_int(sv.force_value(), P) == P - 1
                y_final = Value.known((P - y) % P if neg else y)
            y_var = region.assign_advice(config.ecc.y_p, offset, y_final, "y_var")
            return EccPoint(magnitude_mul.x, y_var)

        result = layouter.assign_region(
            "Short fixed-base mul (most significant word)", last_region
        )
        return result, sc


class MulFixedBaseField:
    """Fixed-base mul by a base-field element with canonicity enforcement
    (mul_fixed/base_field_elem.rs)."""

    def __init__(self, config: MulFixedConfig, chip: EccChip):
        assert config.lookup is not None, "base-field mul needs a 10-bit lookup config"
        self.config = config
        self.chip = chip

    def assign(self, layouter: Layouter, scalar: AssignedCell,
               base: FixedPointBase) -> EccPoint:
        assert base.num_windows == NUM_WINDOWS
        config = self.config

        def in_region(region: Region):
            zs = config.running_sum.copy_decompose(
                region, 0, scalar, True, 255, NUM_WINDOWS
            )
            sc = EccBaseFieldElemFixed(zs[0], zs)
            acc, mul_b = config._assign_region_inner(
                region, 0, sc, base, config.q_running
            )
            return sc, acc, mul_b

        sc, acc, mul_b = layouter.assign_region(
            "Base-field elem fixed-base mul (incomplete addition)", in_region
        )
        result = layouter.assign_region(
            "Base-field elem fixed-base mul (complete addition)",
            lambda region: self.chip._assign_complete_add(region, 0, mul_b, acc),
        )

        # Canonicity: alpha = alpha_0 (252) || alpha_1 (2) || alpha_2 (1)
        # (base_field_elem.rs:235-360).
        alpha = sc.base_field_elem
        z_43, z_44, z_84 = sc.running_sum[43], sc.running_sum[44], sc.running_sum[84]

        av = alpha.value()
        if av.is_none():
            alpha_0_prime_val = Value.unknown()
        else:
            a = _as_int(av.force_value(), P)
            z84v = _as_int(z_84.value().force_value(), P)
            alpha_0 = (a - z84v * (1 << 252)) % P
            alpha_0_prime_val = Value.known((alpha_0 + (1 << 130) - T_P) % P)

        zs13 = config.lookup.witness_check(layouter, alpha_0_prime_val, 13, False)
        alpha_0_prime, z_13_alpha_0_prime = zs13[0], zs13[13]

        def canon_region(region: Region):
            region.enable_selector(config.q_base_field, 1)
            a0c, a1c, a2c = config.canon_advices
            alpha.copy_advice(region, a0c, 0, "alpha")
            z_84.copy_advice(region, a2c, 0, "z_84")
            alpha_0_prime.copy_advice(region, a0c, 1, "alpha_0_prime")
            if av.is_none():
                a1v = a2v = Value.unknown()
            else:
                a = _as_int(av.force_value(), P)
                a1v = Value.known(bitrange_subset(a, 252, 254))
                a2v = Value.known(bitrange_subset(a, 254, 255))
            region.assign_advice(a1c, 1, a1v, "alpha_1")
            region.assign_advice(a2c, 1, a2v, "alpha_2")
            z_13_alpha_0_prime.copy_advice(region, a0c, 2, "z_13_alpha_0_prime")
            z_44.copy_advice(region, a1c, 2, "z_44")
            z_43.copy_advice(region, a2c, 2, "z_43")

        layouter.assign_region("Canonicity checks", canon_region)
        return result
