"""Typed gadget-level ECC API (reference `halo2_gadgets/src/ecc.rs`).

Wraps the `EccChip` + fixed-base configs behind the reference's typed
wrapper structs: `Point` / `NonIdentityPoint` / `X` (ecc.rs:259-455),
`ScalarVar` / `ScalarFixed` / `ScalarFixedShort` (ecc.rs:174-257), and
`FixedPoint` / `FixedPointBaseField` / `FixedPointShort` (ecc.rs:462-575).

The chip bundle (`EccGadgetChip`) plays the role of the reference's
`EccChip` implementing `EccInstructions` (ecc/chip.rs).

A copy of `halo2_tpu/gadgets/ecc_api.py` on the port's front-end.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..frontend import AssignedCell, Value
from ..plonk.constraint_system import ConstraintSystem
from .ecc import EccChip, EccConfig, EccPoint, NonIdentityEccPoint
from .ecc_fixed import (
    NUM_WINDOWS,
    NUM_WINDOWS_SHORT,
    FixedPointBase,
    MulFixedBaseField,
    MulFixedConfig,
    MulFixedFullWidth,
    MulFixedShort,
)
from .utilities import LookupRangeCheckConfig


class EccGadgetConfig:
    """Bundled configuration (ecc/chip.rs EccConfig)."""

    def __init__(self, ecc: EccConfig, mul_fixed: MulFixedConfig):
        self.ecc = ecc
        self.mul_fixed = mul_fixed

    @staticmethod
    def configure(meta: ConstraintSystem, advices,
                  lookup: Optional[LookupRangeCheckConfig] = None
                  ) -> "EccGadgetConfig":
        ecc = EccChip.configure(meta, advices)
        mul_fixed = MulFixedConfig(meta, ecc, lookup)
        return EccGadgetConfig(ecc, mul_fixed)


class EccGadgetChip:
    """The full ECC chip: all EccInstructions (ecc.rs:16-170)."""

    def __init__(self, config: EccGadgetConfig):
        self.config = config
        self.inner = EccChip(config.ecc)

    # -- instruction surface --
    def witness_point(self, layouter, value: Value) -> EccPoint:
        return self.inner.witness_point(layouter, value)

    def witness_point_non_id(self, layouter, value: Value) -> NonIdentityEccPoint:
        return self.inner.witness_point_non_id(layouter, value)

    def add(self, layouter, a: EccPoint, b: EccPoint) -> EccPoint:
        return self.inner.add(layouter, a, b)

    def add_incomplete(self, layouter, a, b) -> NonIdentityEccPoint:
        return self.inner.add_incomplete(layouter, a, b)

    def mul(self, layouter, scalar: Value, base: EccPoint, num_bits: int = 255):
        return self.inner.mul(layouter, scalar, base, num_bits)

    def mul_fixed(self, layouter, scalar: Value, base: FixedPointBase):
        return MulFixedFullWidth(self.config.mul_fixed, self.inner).assign(
            layouter, scalar, base
        )

    def mul_fixed_short(self, layouter, magnitude_sign, base: FixedPointBase):
        return MulFixedShort(self.config.mul_fixed, self.inner).assign(
            layouter, magnitude_sign, base
        )

    def mul_fixed_base_field_elem(self, layouter, base_field_elem: AssignedCell,
                                  base: FixedPointBase):
        return MulFixedBaseField(self.config.mul_fixed, self.inner).assign(
            layouter, base_field_elem, base
        )

    def constrain_equal(self, layouter, a: EccPoint, b: EccPoint):
        def in_region(region):
            region.constrain_equal(a.x.cell(), b.x.cell())
            region.constrain_equal(a.y.cell(), b.y.cell())

        layouter.assign_region("constrain equal", in_region)


# ---------------------------------------------------------------------------
# Typed wrappers
# ---------------------------------------------------------------------------


class ScalarVar:
    """Variable-base full-width scalar (ecc.rs:174-206)."""

    def __init__(self, chip: EccGadgetChip, inner: Value):
        self.chip = chip
        self.inner = inner

    @staticmethod
    def new(chip: EccGadgetChip, layouter, value: Value) -> "ScalarVar":
        return ScalarVar(chip, value)


class ScalarFixed:
    """Fixed-base full-width scalar (ecc.rs:209-229)."""

    def __init__(self, chip: EccGadgetChip, inner):
        self.chip = chip
        self.inner = inner

    @staticmethod
    def new(chip: EccGadgetChip, layouter, value: Value) -> "ScalarFixed":
        # witnessed lazily inside mul_fixed (full_width.rs:152-154)
        return ScalarFixed(chip, value)


class ScalarFixedShort:
    """Signed short scalar: (magnitude, sign) cells (ecc.rs:232-257)."""

    def __init__(self, chip: EccGadgetChip, inner: Tuple[AssignedCell, AssignedCell]):
        self.chip = chip
        self.inner = inner

    @staticmethod
    def new(chip: EccGadgetChip, layouter, magnitude_sign) -> "ScalarFixedShort":
        return ScalarFixedShort(chip, magnitude_sign)


class X:
    """The affine x-coordinate of a point (ecc.rs:439-455)."""

    def __init__(self, chip: EccGadgetChip, inner: AssignedCell):
        self.chip = chip
        self.inner = inner


class Point:
    """A curve point, possibly the identity (ecc.rs:377-436)."""

    def __init__(self, chip: EccGadgetChip, inner: EccPoint):
        self.chip = chip
        self.inner = inner

    @staticmethod
    def new(chip: EccGadgetChip, layouter, value: Value) -> "Point":
        return Point(chip, chip.witness_point(layouter, value))

    def constrain_equal(self, layouter, other: "Point"):
        self.chip.constrain_equal(layouter, self.inner, other.inner)

    def extract_p(self) -> X:
        return X(self.chip, self.inner.x)

    def add(self, layouter, other: "Point") -> "Point":
        return Point(self.chip, self.chip.add(layouter, self.inner, other.inner))


class NonIdentityPoint(Point):
    """A point constrained to be non-identity (ecc.rs:259-374)."""

    @staticmethod
    def new(chip: EccGadgetChip, layouter, value: Value) -> "NonIdentityPoint":
        return NonIdentityPoint(chip, chip.witness_point_non_id(layouter, value))

    def add_incomplete(self, layouter, other: "NonIdentityPoint") -> "NonIdentityPoint":
        return NonIdentityPoint(
            self.chip, self.chip.add_incomplete(layouter, self.inner, other.inner)
        )

    def mul(self, layouter, by: ScalarVar) -> Tuple[Point, ScalarVar]:
        result, scalar = self.chip.mul(layouter, by.inner, self.inner)
        return Point(self.chip, result), ScalarVar(self.chip, scalar)


class FixedPoint:
    """A constant base for full-width fixed-base mul (ecc.rs:462-516)."""

    def __init__(self, chip: EccGadgetChip, base: FixedPointBase):
        assert base.num_windows == NUM_WINDOWS
        self.chip = chip
        self.base = base

    def mul(self, layouter, by: ScalarFixed) -> Tuple[Point, ScalarFixed]:
        result, scalar = self.chip.mul_fixed(layouter, by.inner, self.base)
        return Point(self.chip, result), ScalarFixed(self.chip, scalar)


class FixedPointBaseField:
    """A constant base multiplied by a base-field element (ecc.rs:473-541)."""

    def __init__(self, chip: EccGadgetChip, base: FixedPointBase):
        assert base.num_windows == NUM_WINDOWS
        self.chip = chip
        self.base = base

    def mul(self, layouter, by: AssignedCell) -> Point:
        return Point(self.chip, self.chip.mul_fixed_base_field_elem(layouter, by, self.base))


class FixedPointShort:
    """A constant base for short signed fixed-base mul (ecc.rs:480-575)."""

    def __init__(self, chip: EccGadgetChip, base: FixedPointBase):
        assert base.num_windows == NUM_WINDOWS_SHORT
        self.chip = chip
        self.base = base

    def mul(self, layouter, by: ScalarFixedShort) -> Tuple[Point, ScalarFixedShort]:
        result, scalar = self.chip.mul_fixed_short(layouter, by.inner, self.base)
        return Point(self.chip, result), ScalarFixedShort(self.chip, scalar)
