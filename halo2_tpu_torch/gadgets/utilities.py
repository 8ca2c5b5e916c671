"""Utility gadgets (reference `halo2_gadgets/src/utilities{,.rs}`):

  * expression helpers `bool_check` / `ternary` / `range_check`
    (utilities.rs:131-173),
  * bit helpers `bitrange_subset` / `decompose_word` / `lebs2ip` / `i2lebsp`
    (utilities.rs:144-235),
  * `load_private` (UtilitiesInstructions, utilities.rs:52-72),
  * `CondSwapChip` (cond_swap.rs),
  * windowed `RunningSumConfig` decomposition (decompose_running_sum.rs),
  * `LookupRangeCheckConfig` K-bit lookup range checks with short-range
    bitshift checks (lookup_range_check.rs).

A copy of `halo2_tpu/gadgets/utilities.py` on the port's front-end.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Type

from ..fields import FieldElement
from ..frontend import AssignedCell, Layouter, Region, Value
from ..plonk.assigned import Assigned
from ..plonk.constraint_system import ConstraintSystem
from ..plonk.expression import Constant, Expression
from ..poly import Rotation
from .poseidon import _as_int

# ---------------------------------------------------------------------------
# Expression helpers
# ---------------------------------------------------------------------------


def range_check(word: Expression, range_: int) -> Expression:
    """word * (1-word) * ... * ((range-1)-word) (utilities.rs:169-173)."""
    acc = word
    for i in range(1, range_):
        acc = acc * (Constant(i) - word)
    return acc


def bool_check(value: Expression) -> Expression:
    return range_check(value, 2)


def ternary(a: Expression, b: Expression, c: Expression) -> Expression:
    """(a * b) + (1 - a) * c; `a` must be boolean-constrained."""
    return a * b + (Constant(1) - a) * c


# ---------------------------------------------------------------------------
# Bit helpers (host ints; LSB-first bit numbering like PrimeFieldBits)
# ---------------------------------------------------------------------------


def bitrange_subset(value: int, start: int, end: int) -> int:
    """Bits [start, end) of the little-endian representation (utilities.rs:144)."""
    return (value >> start) & ((1 << (end - start)) - 1)


def decompose_word(word: int, word_num_bits: int, window_num_bits: int) -> List[int]:
    """K-bit little-endian windows of `word` (utilities.rs:182-204)."""
    assert window_num_bits <= 8
    num_windows = (word_num_bits + window_num_bits - 1) // window_num_bits
    mask = (1 << window_num_bits) - 1
    word &= (1 << word_num_bits) - 1
    return [(word >> (i * window_num_bits)) & mask for i in range(num_windows)]


def lebs2ip(bits: List[bool]) -> int:
    assert len(bits) <= 64
    return sum(1 << i for i, b in enumerate(bits) if b)


def i2lebsp(value: int, num_bits: int) -> List[bool]:
    assert num_bits <= 64 and value < (1 << num_bits)
    return [(value >> i) & 1 == 1 for i in range(num_bits)]


def load_private(layouter: Layouter, column, value: Value) -> AssignedCell:
    """UtilitiesInstructions::load_private (utilities.rs:52-72)."""
    return layouter.assign_region(
        "load private",
        lambda region: region.assign_advice(column, 0, value, "load private"),
    )


# ---------------------------------------------------------------------------
# CondSwapChip (cond_swap.rs)
# ---------------------------------------------------------------------------


class CondSwapConfig:
    def __init__(self, q_swap, a, b, a_swapped, b_swapped, swap):
        self.q_swap = q_swap
        self.a = a
        self.b = b
        self.a_swapped = a_swapped
        self.b_swapped = b_swapped
        self.swap = swap


class CondSwapChip:
    def __init__(self, config: CondSwapConfig, field: Type[FieldElement]):
        self.config = config
        self.field = field

    @staticmethod
    def configure(meta: ConstraintSystem, advices) -> CondSwapConfig:
        """advices: 5 advice columns; advices[0] is equality-enabled."""
        a, b, a_swapped, b_swapped, swap = advices
        meta.enable_equality(a)
        q_swap = meta.selector()
        config = CondSwapConfig(q_swap, a, b, a_swapped, b_swapped, swap)

        def gate(cells):
            q = cells.query_selector(q_swap)
            av = cells.query_advice(a, Rotation.cur())
            bv = cells.query_advice(b, Rotation.cur())
            asw = cells.query_advice(a_swapped, Rotation.cur())
            bsw = cells.query_advice(b_swapped, Rotation.cur())
            sw = cells.query_advice(swap, Rotation.cur())
            return [
                q * (asw - ternary(sw, bv, av)),
                q * (bsw - ternary(sw, av, bv)),
                q * bool_check(sw),
            ]

        meta.create_gate("a' = b*swap + a*(1-swap)", gate)
        return config

    def swap(self, layouter: Layouter, pair: Tuple[AssignedCell, Value],
             swap: Value) -> Tuple[AssignedCell, AssignedCell]:
        config = self.config
        p = self.field.MODULUS

        def in_region(region: Region):
            region.enable_selector(config.q_swap, 0)
            a = pair[0].copy_advice(region, config.a, 0, "copy a")
            b = region.assign_advice(config.b, 0, pair[1], "witness b")
            swap_val = swap.map(lambda s: int(bool(s)))
            region.assign_advice(config.swap, 0, swap_val, "swap")

            def select(cond_sw, x, y):
                if x.is_none() or y.is_none() or cond_sw.is_none():
                    return Value.unknown()
                xv = _as_int(x.force_value(), p)
                yv = _as_int(y.force_value(), p)
                return Value.known(yv if cond_sw.force_value() else xv)

            a_swapped = region.assign_advice(
                config.a_swapped, 0, select(swap, a.value(), b.value()), "a_swapped"
            )
            b_swapped = region.assign_advice(
                config.b_swapped, 0, select(swap, b.value(), a.value()), "b_swapped"
            )
            return a_swapped, b_swapped

        return layouter.assign_region("swap", in_region)


# ---------------------------------------------------------------------------
# RunningSumConfig (decompose_running_sum.rs)
# ---------------------------------------------------------------------------


class RunningSumConfig:
    """Windowed K-bit running-sum decomposition, K <= 3."""

    def __init__(self, q_range_check, z, window_num_bits: int, field: Type[FieldElement]):
        self.q_range_check = q_range_check
        self.z = z
        self.window_num_bits = window_num_bits
        self.field = field

    @staticmethod
    def configure(meta: ConstraintSystem, q_range_check, z, window_num_bits: int,
                  field: Type[FieldElement]) -> "RunningSumConfig":
        assert window_num_bits <= 3
        meta.enable_equality(z)
        config = RunningSumConfig(q_range_check, z, window_num_bits, field)

        def gate(cells):
            q = cells.query_selector(q_range_check)
            z_cur = cells.query_advice(z, Rotation.cur())
            z_next = cells.query_advice(z, Rotation.next())
            word = z_cur - z_next * (1 << window_num_bits)
            return [q * range_check(word, 1 << window_num_bits)]

        meta.create_gate("range check", gate)
        return config

    def witness_decompose(self, region: Region, offset: int, alpha: Value, strict: bool,
                          word_num_bits: int, num_windows: int) -> List[AssignedCell]:
        z_0 = region.assign_advice(self.z, offset, alpha, "z_0 = alpha")
        return self._decompose(region, offset, z_0, strict, word_num_bits, num_windows)

    def copy_decompose(self, region: Region, offset: int, alpha: AssignedCell, strict: bool,
                       word_num_bits: int, num_windows: int) -> List[AssignedCell]:
        z_0 = alpha.copy_advice(region, self.z, offset, "copy z_0 = alpha")
        return self._decompose(region, offset, z_0, strict, word_num_bits, num_windows)

    def _decompose(self, region: Region, offset: int, z_0: AssignedCell, strict: bool,
                   word_num_bits: int, num_windows: int) -> List[AssignedCell]:
        K = self.window_num_bits
        assert K * num_windows < word_num_bits + K
        p = self.field.MODULUS
        for idx in range(num_windows):
            region.enable_selector(self.q_range_check, offset + idx)

        if z_0.value().is_none():
            words = [None] * num_windows
        else:
            words = decompose_word(_as_int(z_0.value().force_value(), p), word_num_bits, K)[
                :num_windows
            ]

        zs = [z_0]
        z = z_0
        inv_two_pow_k = pow(1 << K, -1, p)
        for i, word in enumerate(words):
            if word is None or z.value().is_none():
                z_next_val = Value.unknown()
            else:
                z_cur = _as_int(z.value().force_value(), p)
                z_next_val = Value.known((z_cur - word) * inv_two_pow_k % p)
            z = region.assign_advice(self.z, offset + i + 1, z_next_val, f"z_{i + 1}")
            zs.append(z)
        assert len(zs) == num_windows + 1
        if strict:
            region.constrain_constant(zs[-1].cell(), 0)
        return zs


# ---------------------------------------------------------------------------
# LookupRangeCheckConfig (lookup_range_check.rs)
# ---------------------------------------------------------------------------


class LookupRangeCheckConfig:
    """K-bit lookup range check against a [0, 2^K) table column."""

    def __init__(self, q_lookup, q_running, q_bitshift, running_sum, table_idx,
                 k: int, field: Type[FieldElement]):
        self.q_lookup = q_lookup
        self.q_running = q_running
        self.q_bitshift = q_bitshift
        self.running_sum = running_sum
        self.table_idx = table_idx
        self.k = k
        self.field = field

    @staticmethod
    def configure(meta: ConstraintSystem, running_sum, table_idx, k: int,
                  field: Type[FieldElement]) -> "LookupRangeCheckConfig":
        meta.enable_equality(running_sum)
        q_lookup = meta.complex_selector()
        q_running = meta.complex_selector()
        q_bitshift = meta.selector()
        config = LookupRangeCheckConfig(
            q_lookup, q_running, q_bitshift, running_sum, table_idx, k, field
        )

        def lookup_map(cells):
            ql = cells.query_selector(q_lookup)
            qr = cells.query_selector(q_running)
            z_cur = cells.query_advice(running_sum, Rotation.cur())
            z_next = cells.query_advice(running_sum, Rotation.next())
            running_word = qr * (z_cur - z_next * (1 << k))
            short_word = (Constant(1) - qr) * z_cur
            return [(ql * (running_word + short_word), table_idx)]

        meta.lookup("lookup", lookup_map)

        def bitshift_gate(cells):
            q = cells.query_selector(q_bitshift)
            word = cells.query_advice(running_sum, Rotation.prev())
            shifted = cells.query_advice(running_sum, Rotation.cur())
            inv_two_pow_s = cells.query_advice(running_sum, Rotation.next())
            return [q * (word * (1 << k) * inv_two_pow_s - shifted)]

        meta.create_gate("Short lookup bitshift", bitshift_gate)
        return config

    def load(self, layouter: Layouter):
        """Load [0, 2^K) into table_idx (testing; Sinsemilla preloads its own)."""

        def in_table(table):
            for index in range(1 << self.k):
                table.assign_cell(self.table_idx, index, index, "table_idx")

        layouter.assign_table("table_idx", in_table)

    def copy_check(self, layouter: Layouter, element: AssignedCell, num_words: int,
                   strict: bool) -> List[AssignedCell]:
        def in_region(region: Region):
            z_0 = element.copy_advice(region, self.running_sum, 0, "z_0")
            return self._range_check(region, z_0, num_words, strict)

        return layouter.assign_region(f"{num_words} words range check", in_region)

    def witness_check(self, layouter: Layouter, value: Value, num_words: int,
                      strict: bool) -> List[AssignedCell]:
        def in_region(region: Region):
            z_0 = region.assign_advice(self.running_sum, 0, value, "Witness element")
            return self._range_check(region, z_0, num_words, strict)

        return layouter.assign_region("Witness element", in_region)

    def _range_check(self, region: Region, element: AssignedCell, num_words: int,
                     strict: bool) -> List[AssignedCell]:
        K = self.k
        p = self.field.MODULUS
        assert num_words * K <= self.field.NUM_BITS - 1
        if element.value().is_none():
            words = [None] * num_words
        else:
            v = _as_int(element.value().force_value(), p)
            words = [bitrange_subset(v, i * K, (i + 1) * K) for i in range(num_words)]

        zs = [element]
        z = element
        inv_two_pow_k = pow(1 << K, -1, p)
        for idx, word in enumerate(words):
            region.enable_selector(self.q_lookup, idx)
            region.enable_selector(self.q_running, idx)
            if word is None or z.value().is_none():
                z_val = Value.unknown()
            else:
                z_cur = _as_int(z.value().force_value(), p)
                z_val = Value.known((z_cur - word) * inv_two_pow_k % p)
            z = region.assign_advice(self.running_sum, idx + 1, z_val, f"z_{idx + 1}")
            zs.append(z)
        if strict:
            region.constrain_constant(zs[-1].cell(), 0)
        return zs

    def copy_short_check(self, layouter: Layouter, element: AssignedCell, num_bits: int):
        assert num_bits < self.k

        def in_region(region: Region):
            el = element.copy_advice(region, self.running_sum, 0, "element")
            self._short_range_check(region, el, num_bits)

        layouter.assign_region(f"Range check {num_bits} bits", in_region)

    def witness_short_check(self, layouter: Layouter, element: Value,
                            num_bits: int) -> AssignedCell:
        assert num_bits <= self.k

        def in_region(region: Region):
            el = region.assign_advice(self.running_sum, 0, element, "Witness element")
            self._short_range_check(region, el, num_bits)
            return el

        return layouter.assign_region(f"Range check {num_bits} bits", in_region)

    def _short_range_check(self, region: Region, element: AssignedCell, num_bits: int):
        K = self.k
        p = self.field.MODULUS
        region.enable_selector(self.q_lookup, 0)
        region.enable_selector(self.q_lookup, 1)
        region.enable_selector(self.q_bitshift, 1)
        if element.value().is_none():
            shifted = Value.unknown()
        else:
            shifted = Value.known(
                _as_int(element.value().force_value(), p) * (1 << (K - num_bits)) % p
            )
        region.assign_advice(
            self.running_sum, 1, shifted, f"element * 2^({K}-{num_bits})"
        )
        inv_two_pow_s = pow(1 << num_bits, -1, p)
        region.assign_advice_from_constant(
            self.running_sum, 2, inv_two_pow_s, f"2^(-{num_bits})"
        )
