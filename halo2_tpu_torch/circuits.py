"""Example circuits on the port's front-end.

`MulCircuit` is `tests/circuits.py::MulCircuit` (the reference's
`examples/simple-example.rs`: private a, b, a fixed constant, and the public
c = constant * a^2 * b^2). `BenchCircuit` / `bench_circuit_for_k` are
`examples/plonk_bench.py`'s proof workload: per active row c = a*b + a + b
through the gate sm*(a*b) + sa*a + sb*b - sc*c = 0, a copy chain c[i] ->
a[i+1], and a lookup of b into a 2^bits table. The synthesis is the same,
written against `halo2_tpu_torch`'s front-end, so keys and proofs match the
JAX package's byte for byte. `BenchCircuit` takes the scalar field its
witness chain is reduced in: Pasta's Fp, the default, keeps
`examples/plonk_bench.py`'s bytes; BN254's FrBn makes the KZG workload.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Type

from .fields import FieldElement, Fp
from .frontend import Circuit, Layouter, Region, Value
from .plonk import ConstraintSystem
from .poly import Rotation


@dataclass
class MulConfig:
    advice0: object
    advice1: object
    instance: object
    constant: object
    s_mul: object


class MulCircuit(Circuit):
    def __init__(self, constant: int, a=None, b=None):
        self.constant = constant
        self.a = Value.unknown() if a is None else Value.known(a)
        self.b = Value.unknown() if b is None else Value.known(b)

    def without_witnesses(self):
        return MulCircuit(self.constant)

    @classmethod
    def configure(cls, meta: ConstraintSystem) -> MulConfig:
        advice0 = meta.advice_column()
        advice1 = meta.advice_column()
        instance = meta.instance_column()
        constant = meta.fixed_column()
        meta.enable_equality(instance)
        meta.enable_constant(constant)
        meta.enable_equality(advice0)
        meta.enable_equality(advice1)
        s_mul = meta.selector()

        def mul_gate(cells):
            lhs = cells.query_advice(advice0, Rotation.cur())
            rhs = cells.query_advice(advice1, Rotation.cur())
            out = cells.query_advice(advice0, Rotation.next())
            s = cells.query_selector(s_mul)
            return [s * (lhs * rhs - out)]

        meta.create_gate("mul", mul_gate)
        return MulConfig(advice0, advice1, instance, constant, s_mul)

    def synthesize(self, config: MulConfig, layouter: Layouter):
        # load private inputs
        def load_private(value, name):
            return layouter.assign_region(
                f"load {name}",
                lambda region: region.assign_advice(config.advice0, 0, value, name),
            )

        a = load_private(self.a, "a")
        b = load_private(self.b, "b")
        const_cell = layouter.assign_region(
            "load constant",
            lambda region: region.assign_advice_from_constant(
                config.advice0, 0, self.constant, "constant"
            ),
        )

        def mul(lhs, rhs, name):
            def in_region(region):
                config.s_mul.enable(region, 0)
                lhs.copy_advice(region, config.advice0, 0, "lhs")
                rhs.copy_advice(region, config.advice1, 0, "rhs")
                out = lhs.value() * rhs.value()
                return region.assign_advice(config.advice0, 1, out, "lhs*rhs")

            return layouter.assign_region(name, in_region)

        ab = mul(a, b, "ab")
        absq = mul(ab, ab, "absq")
        c = mul(const_cell, absq, "c")
        layouter.constrain_instance(c.cell(), config.instance, 0)


class BenchConfig:
    def __init__(self, a, b, c, sa, sb, sc, sm, sl):
        self.a, self.b, self.c = a, b, c
        self.sa, self.sb, self.sc, self.sm = sa, sb, sc, sm
        self.sl = sl


class BenchCircuit(Circuit):
    """`rows` active gate rows; `seed` drives the witness chain, reduced mod
    the scalar field `field` (Pasta's Fp by default; BN254's FrBn for KZG)."""

    def __init__(self, rows: int, table_bits: int = 8, seed: int = None,
                 field: Type[FieldElement] = Fp):
        self.rows = rows
        self.table_bits = table_bits
        self.seed = seed
        self.field = field

    def without_witnesses(self):
        return BenchCircuit(self.rows, self.table_bits, None, self.field)

    @classmethod
    def configure(cls, meta: ConstraintSystem) -> BenchConfig:
        a = meta.advice_column()
        b = meta.advice_column()
        c = meta.advice_column()
        sa = meta.fixed_column()
        sb = meta.fixed_column()
        sc = meta.fixed_column()
        sm = meta.fixed_column()
        sl = meta.lookup_table_column()
        meta.enable_equality(a)
        meta.enable_equality(c)

        def gate(cells):
            av = cells.query_advice(a, Rotation.cur())
            bv = cells.query_advice(b, Rotation.cur())
            cv = cells.query_advice(c, Rotation.cur())
            return [
                av * cells.query_fixed(sa, Rotation.cur())
                + bv * cells.query_fixed(sb, Rotation.cur())
                + av * bv * cells.query_fixed(sm, Rotation.cur())
                - cv * cells.query_fixed(sc, Rotation.cur())
            ]

        meta.create_gate("plonk", gate)

        def lookup_map(cells):
            return [(cells.query_advice(b, Rotation.cur()), sl)]

        meta.lookup("range", lookup_map)
        return BenchConfig(a, b, c, sa, sb, sc, sm, sl)

    def synthesize(self, config: BenchConfig, layouter: Layouter):
        P = self.field.MODULUS
        mask = (1 << self.table_bits) - 1
        rows = self.rows
        witness = self.seed is not None

        def main_region(region: Region):
            acells = []
            ccells = []
            av = (self.seed or 0) % P
            for i in range(rows):
                bv = (av * 0x9E3779B9 + i) & mask
                cv = (av * bv + av + bv) % P
                acells.append(
                    region.assign_advice(
                        config.a, i,
                        Value.known(av) if witness else Value.unknown(), "a",
                    ).cell()
                )
                region.assign_advice(
                    config.b, i,
                    Value.known(bv) if witness else Value.unknown(), "b",
                )
                ccells.append(
                    region.assign_advice(
                        config.c, i,
                        Value.known(cv) if witness else Value.unknown(), "c",
                    ).cell()
                )
                region.assign_fixed(config.sa, i, Value.known(1), "sa")
                region.assign_fixed(config.sb, i, Value.known(1), "sb")
                region.assign_fixed(config.sc, i, Value.known(1), "sc")
                region.assign_fixed(config.sm, i, Value.known(1), "sm")
                av = cv
            # chain: c[i] is copied into a[i+1]
            for i in range(rows - 1):
                region.constrain_equal(ccells[i], acells[i + 1])

        layouter.assign_region("main", main_region)

        def in_table(table):
            for v in range(1 << self.table_bits):
                table.assign_cell(config.sl, v, v, "t")

        layouter.assign_table("table", in_table)


def bench_circuit_for_k(k: int, seed: int = 42, field: Type[FieldElement] = Fp):
    """Fill ~all usable rows of a 2^k domain (leave room for blinding +
    the lookup table tail)."""
    rows = (1 << k) - 64
    return BenchCircuit(rows, table_bits=min(8, k - 1), seed=seed, field=field)
