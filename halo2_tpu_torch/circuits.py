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

The rest are copies of the JAX package's test circuits, written against the
port's front-end so that the port's tests and `chip_smoke.py` (which may not
import `tests/`) can drive them: `HashCircuit` (the Poseidon Pow5 chip
hashing two elements, `tests/test_poseidon_gadget.py`; `poseidon_k11` is
BASELINE.md's gating config 2, `tests/golden_circuits.py`),
`PlonkApiCircuit` (`tests/plonk_api_circuit.py`, the reference's
`plonk_api.rs` circuit, whose k = 5 VK the Rust reference pinned),
`RangeCheckCircuit` and `ShuffleCircuit` (`tests/test_lookup_and_phases.py`),
`SumCircuit` (`tests/test_circuit_params.py`), `DupFixedCircuit`
(`tests/test_duplicate_commitments.py`), `MulCircuitV1`
(`tests/test_v1_floor_planner.py`) and `MixedDegreeCircuit`
(`tests/circuits.py`); and the ECC and Sinsemilla gadgets' circuits:
`EccOpsCircuit` and `FullMulCircuit` (`tests/test_ecc_gadget.py`),
`VarMulCircuit` (`tests/test_ecc_var_mul.py`), `FixedMulCircuit`,
`ShortMulCircuit` and `BaseFieldMulCircuit` (`tests/test_ecc_fixed.py`),
`SinsemillaCircuit` (`tests/test_sinsemilla_gadget.py`; `sinsemilla_k14` is
BASELINE.md's gating config 4), `FusedCircuit`
(`tests/test_sinsemilla_fused.py`) and `MerkleCircuit`
(`tests/test_sinsemilla_merkle.py`); and the SHA-256 gadget's `ShaCircuit`
(`tests/test_sha256_gadget.py`, with the block count a parameter;
`sha256_k17` hashes the most blocks that fit at k = 17).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Type

from .fields import FieldElement, Fp
from .frontend import Circuit, Layouter, Region, Value
from .frontend.floor_planner import V1FloorPlanner
from .plonk import FIRST_PHASE, SECOND_PHASE, ConstraintSystem
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


# ---------------- copies of the JAX package's test circuits ----------------


class HashCircuit(Circuit):
    """Poseidon (P128Pow5T3 over Fp, ConstantLength(2)) of a 2-element
    message through the Pow5 chip; the digest is the one public input."""

    def __init__(self, message=None):
        self.message = message  # list of 2 ints or None

    def without_witnesses(self):
        return HashCircuit(None)

    @classmethod
    def configure(cls, meta: ConstraintSystem):
        from .gadgets.poseidon import Pow5Chip
        from .gadgets.poseidon_primitives import P128Pow5T3Fp

        width = 3
        state = [meta.advice_column() for _ in range(width)]
        partial_sbox = meta.advice_column()
        rc_a = [meta.fixed_column() for _ in range(width)]
        rc_b = [meta.fixed_column() for _ in range(width)]
        meta.enable_constant(rc_b[0])
        config = Pow5Chip.configure(meta, P128Pow5T3Fp, state, partial_sbox, rc_a, rc_b)
        instance = meta.instance_column()
        meta.enable_equality(instance)
        return config, instance

    def synthesize(self, config, layouter: Layouter):
        from .gadgets.poseidon import PoseidonHash, Pow5Chip
        from .gadgets.poseidon_primitives import ConstantLength

        pow5_config, instance = config
        chip = Pow5Chip(pow5_config)

        def load_message(region):
            cells = []
            for i in range(2):
                v = Value.unknown() if self.message is None else Value.known(self.message[i])
                cells.append(
                    region.assign_advice(pow5_config.state[i], 0, v, f"load message_{i}")
                )
            return cells

        message = layouter.assign_region("load message", load_message)
        hasher = PoseidonHash(chip, layouter.namespace("init"), ConstantLength(2))
        output = hasher.hash(layouter.namespace("hash"), message)
        layouter.constrain_instance(output.cell(), instance, 0)


POSEIDON_K11_MESSAGE = [7, 11]
POSEIDON_K11_SEED = b"\x02" * 32


def poseidon_k11():
    """Gating config 2 of BASELINE.md: (k, circuit, instances, rng seed) of
    HashCircuit([7, 11]) at k = 11, as `tests/golden_circuits.py` proves it."""
    from .gadgets.poseidon_primitives import ConstantLength, P128Pow5T3Fp, poseidon_hash

    digest = poseidon_hash(POSEIDON_K11_MESSAGE, P128Pow5T3Fp, ConstantLength(2))
    return 11, HashCircuit(POSEIDON_K11_MESSAGE), [[digest]], POSEIDON_K11_SEED


class PlonkApiConfig:
    def __init__(self, a, b, c, d, e, sa, sb, sc, sm, sp, sl, p):
        self.a, self.b, self.c, self.d, self.e = a, b, c, d, e
        self.sa, self.sb, self.sc, self.sm, self.sp = sa, sb, sc, sm, sp
        self.sl = sl
        self.p = p


class PlonkApiCircuit(Circuit):
    """plonk_api.rs MyCircuit / StandardPlonk: a standard PLONK gate with an
    extra sf*(d*e) term, a public-input gate, one lookup and heavy equality,
    columns and queries allocated in the reference's call order; `a=None`
    for keygen (without witnesses)."""

    def __init__(self, a: Optional[int], lookup_table: List[int]):
        self.a = a
        self.lookup_table = lookup_table

    def without_witnesses(self):
        return PlonkApiCircuit(None, self.lookup_table)

    @classmethod
    def configure(cls, meta: ConstraintSystem) -> PlonkApiConfig:
        e = meta.advice_column()
        a = meta.advice_column()
        b = meta.advice_column()
        sf = meta.fixed_column()
        c = meta.advice_column()
        d = meta.advice_column()
        p = meta.instance_column()

        meta.enable_equality(a)
        meta.enable_equality(b)
        meta.enable_equality(c)

        sm = meta.fixed_column()
        sa = meta.fixed_column()
        sb = meta.fixed_column()
        sc = meta.fixed_column()
        sp = meta.fixed_column()
        sl = meta.lookup_table_column()

        def lookup_map(cells):
            a_ = cells.query_advice(a, Rotation.cur())
            return [(a_, sl)]

        meta.lookup("lookup", lookup_map)

        def combined_gate(cells):
            dq = cells.query_advice(d, Rotation.next())
            aq = cells.query_advice(a, Rotation.cur())
            sfq = cells.query_fixed(sf, Rotation.cur())
            eq = cells.query_advice(e, Rotation.prev())
            bq = cells.query_advice(b, Rotation.cur())
            cq = cells.query_advice(c, Rotation.cur())
            saq = cells.query_fixed(sa, Rotation.cur())
            sbq = cells.query_fixed(sb, Rotation.cur())
            scq = cells.query_fixed(sc, Rotation.cur())
            smq = cells.query_fixed(sm, Rotation.cur())
            return [aq * saq + bq * sbq + aq * bq * smq - (cq * scq) + sfq * (dq * eq)]

        meta.create_gate("Combined add-mult", combined_gate)

        def public_gate(cells):
            aq = cells.query_advice(a, Rotation.cur())
            pq = cells.query_instance(p, Rotation.cur())
            spq = cells.query_fixed(sp, Rotation.cur())
            return [spq * (aq - pq)]

        meta.create_gate("Public input", public_gate)

        meta.enable_equality(sf)
        meta.enable_equality(e)
        meta.enable_equality(d)
        meta.enable_equality(p)
        meta.enable_equality(sm)
        meta.enable_equality(sa)
        meta.enable_equality(sb)
        meta.enable_equality(sc)
        meta.enable_equality(sp)

        return PlonkApiConfig(a, b, c, d, e, sa, sb, sc, sm, sp, sl, p)

    def _raw(self, layouter: Layouter, cfg: PlonkApiConfig, mul: bool, vals):
        P = Fp.MODULUS

        def in_region(region: Region):
            if vals is None:
                v = [Value.unknown()] * 3
                lhs4 = rhs4 = Value.unknown()
            else:
                l, r, o = vals
                v = [Value.known(l), Value.known(r), Value.known(o)]
                lhs4 = Value.known(pow(l, 4, P))
                rhs4 = Value.known(pow(r, 4, P))
            lhs = region.assign_advice(cfg.a, 0, v[0], "lhs")
            region.assign_advice(cfg.d, 0, lhs4, "lhs^4")
            rhs = region.assign_advice(cfg.b, 0, v[1], "rhs")
            region.assign_advice(cfg.e, 0, rhs4, "rhs^4")
            out = region.assign_advice(cfg.c, 0, v[2], "out")
            region.assign_fixed(cfg.sa, 0, Value.known(0 if mul else 1), "a")
            region.assign_fixed(cfg.sb, 0, Value.known(0 if mul else 1), "b")
            region.assign_fixed(cfg.sc, 0, Value.known(1), "c")
            region.assign_fixed(cfg.sm, 0, Value.known(1 if mul else 0), "a * b")
            return lhs.cell(), rhs.cell(), out.cell()

        return layouter.assign_region("raw_multiply" if mul else "raw_add", in_region)

    def synthesize(self, config: PlonkApiConfig, layouter: Layouter):
        P = Fp.MODULUS

        def public_region(region: Region):
            value = region.assign_advice(config.a, 0, Value.known(2), "value")
            region.assign_fixed(config.sp, 0, Value.known(1), "public")
            return value.cell()

        layouter.assign_region("public_input", public_region)

        a = self.a
        for _ in range(10):
            if a is None:
                mul_vals = add_vals = None
            else:
                a2 = a * a % P
                mul_vals = (a, a, a2)
                add_vals = (a, a2, (a + a2) % P)
            a0, _, c0 = self._raw(layouter, config, True, mul_vals)
            a1, b1, _ = self._raw(layouter, config, False, add_vals)

            def copy_region(region: Region, l=a0, r=a1):
                region.constrain_equal(l, r)
                region.constrain_equal(l, r)

            layouter.assign_region("copy", copy_region)

            def copy_region2(region: Region, l=b1, r=c0):
                region.constrain_equal(l, r)
                region.constrain_equal(l, r)

            layouter.assign_region("copy", copy_region2)

        def in_table(table):
            for index, value in enumerate(self.lookup_table):
                table.assign_cell(config.sl, index, value, "table col")

        layouter.assign_table("", in_table)


def plonk_api_inputs():
    """(a, instance, lookup_table) per plonk_api.rs common! macro."""
    P = Fp.MODULUS
    a = 2834758237 * Fp.ZETA % P
    instance = 2
    lookup_table = [instance, a, a, 0]
    return a, instance, lookup_table


RANGE_TABLE_BITS = 3  # RangeCheckCircuit's table = [0, 8)


class RangeCheckCircuit(Circuit):
    """Advice values range-checked against a fixed table via a lookup."""

    N_VALUES = 5

    def __init__(self, values=None):
        # values: list of length N_VALUES (None entries = unknown witness);
        # circuit shape (selector pattern) is witness-independent
        self.values = values if values is not None else [None] * self.N_VALUES
        assert len(self.values) == self.N_VALUES

    def without_witnesses(self):
        return RangeCheckCircuit(None)

    @classmethod
    def configure(cls, meta: ConstraintSystem):
        advice = meta.advice_column()
        table = meta.lookup_table_column()
        q = meta.complex_selector()

        def lookup_map(cells):
            a = cells.query_advice(advice, Rotation.cur())
            qq = cells.query_selector(q)
            # gate the input: disabled rows look up 0 (present in table)
            return [(qq * a, table)]

        meta.lookup("range", lookup_map)
        return (advice, table, q)

    def synthesize(self, config, layouter):
        advice, table, q = config

        def fill_table(t):
            for i in range(1 << RANGE_TABLE_BITS):
                t.assign_cell(table, i, i, f"row {i}")

        layouter.assign_table("table", fill_table)

        values = self.values

        def region_fn(region):
            for i, v in enumerate(values):
                q.enable(region, i)
                region.assign_advice(
                    advice, i, Value.known(v) if v is not None else Value.unknown(), f"v{i}")

        layouter.assign_region("values", region_fn)


class ShuffleCircuit(Circuit):
    """Multi-phase: proves column b is a permutation of column a using a
    grand product over a challenge theta (reference examples/shuffle.rs)."""

    def __init__(self, a=None, b=None):
        self.a = a
        self.b = b

    def without_witnesses(self):
        return ShuffleCircuit(None, None)

    @classmethod
    def configure(cls, meta: ConstraintSystem):
        a = meta.advice_column_in(FIRST_PHASE)
        b = meta.advice_column_in(FIRST_PHASE)
        z = meta.advice_column_in(SECOND_PHASE)
        theta = meta.challenge_usable_after(FIRST_PHASE)
        q = meta.selector()
        q_last = meta.selector()

        def shuffle_gate(cells):
            qq = cells.query_selector(q)
            av = cells.query_advice(a, Rotation.cur())
            bv = cells.query_advice(b, Rotation.cur())
            zv = cells.query_advice(z, Rotation.cur())
            z_next = cells.query_advice(z, Rotation.next())
            th = cells.query_challenge(theta)
            # z_{i+1} * (b_i + theta) = z_i * (a_i + theta)
            return [qq * (z_next * (bv + th) - zv * (av + th))]

        meta.create_gate("shuffle", shuffle_gate)

        def boundary_gate(cells):
            ql = cells.query_selector(q_last)
            zv = cells.query_advice(z, Rotation.cur())
            return [ql * (zv - 1)]

        meta.create_gate("boundary", boundary_gate)
        return (a, b, z, theta, q, q_last)

    def synthesize(self, config, layouter):
        a_col, b_col, z_col, theta, q, q_last = config
        p = Fp.MODULUS
        theta_val = layouter.get_challenge(theta)
        n_items = len(self.a) if self.a else 4

        def region_fn(region):
            q_last.enable(region, 0)
            if self.a is None:
                avs = [Value.unknown()] * n_items
                bvs = [Value.unknown()] * n_items
            else:
                avs = [Value.known(v) for v in self.a]
                bvs = [Value.known(v) for v in self.b]
            region.assign_advice(z_col, 0, Value.known(1), "z0")
            z = Value.known(1)
            for i in range(n_items):
                q.enable(region, i)
                region.assign_advice(a_col, i, avs[i], f"a{i}")
                region.assign_advice(b_col, i, bvs[i], f"b{i}")
                num = avs[i].zip(theta_val).map(lambda t: (t[0] + t[1]) % p)
                den = bvs[i].zip(theta_val).map(lambda t: pow((t[0] + t[1]) % p, -1, p))
                z = z.zip(num).map(lambda t: t[0] * t[1] % p)
                z = z.zip(den).map(lambda t: t[0] * t[1] % p)
                region.assign_advice(z_col, i + 1, z, f"z{i+1}")
            q_last.enable(region, n_items)

        layouter.assign_region("shuffle", region_fn)


@dataclass
class WidthConfig:
    advice: list
    instance: object
    s_sum: object


class SumCircuit(Circuit):
    """Sums `width` private inputs; `width` arrives via circuit-params
    (`Circuit::Params` / `configure_with_params`)."""

    def __init__(self, width: int, values=None):
        self.width = width
        self.values = values

    def without_witnesses(self):
        return SumCircuit(self.width)

    def params(self):
        return self.width

    @classmethod
    def configure_with_params(cls, meta: ConstraintSystem, width) -> WidthConfig:
        assert width is not None, "configure_with_params must receive params()"
        advice = [meta.advice_column() for _ in range(width)]
        instance = meta.instance_column()
        meta.enable_equality(instance)
        for col in advice:
            meta.enable_equality(col)
        s_sum = meta.selector()

        def sum_gate(cells):
            terms = [cells.query_advice(col, Rotation.cur()) for col in advice]
            out = cells.query_advice(advice[0], Rotation.next())
            s = cells.query_selector(s_sum)
            acc = terms[0]
            for t in terms[1:]:
                acc = acc + t
            return [s * (acc - out)]

        meta.create_gate("sum", sum_gate)
        return WidthConfig(advice, instance, s_sum)

    def synthesize(self, config: WidthConfig, layouter: Layouter):
        def in_region(region):
            config.s_sum.enable(region, 0)
            total = None
            for i, col in enumerate(config.advice):
                v = (
                    Value.known(self.values[i])
                    if self.values is not None
                    else Value.unknown()
                )
                region.assign_advice(col, 0, v, f"x{i}")
                total = v if total is None else total + v
            return region.assign_advice(config.advice[0], 1, total, "sum")

        out = layouter.assign_region("sum", in_region)
        layouter.constrain_instance(out.cell(), config.instance, 0)


DUP_ROWS = 6


class DupFixedCircuit(Circuit):
    """c = a*b + a + b with four always-1 fixed 'selector' columns whose
    contents (and commitments) are identical."""

    def __init__(self, field, seed=None):
        self.field = field
        self.seed = seed

    def without_witnesses(self):
        return DupFixedCircuit(self.field)

    @classmethod
    def configure(cls, meta):
        a = meta.advice_column()
        b = meta.advice_column()
        c = meta.advice_column()
        sa = meta.fixed_column()
        sb = meta.fixed_column()
        sc = meta.fixed_column()
        sm = meta.fixed_column()
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
        return (a, b, c, sa, sb, sc, sm)

    def synthesize(self, cfg, layouter):
        P = self.field.MODULUS
        a, b, c, sa, sb, sc, sm = cfg
        witness = self.seed is not None

        def main(region):
            av = (self.seed or 0) % P
            ccells, acells = [], []
            for i in range(DUP_ROWS):
                bv = (av * 0x9E3779B9 + i) & 0xF
                cv = (av * bv + av + bv) % P
                acells.append(region.assign_advice(
                    a, i, Value.known(av) if witness else Value.unknown(), "a").cell())
                region.assign_advice(
                    b, i, Value.known(bv) if witness else Value.unknown(), "b")
                ccells.append(region.assign_advice(
                    c, i, Value.known(cv) if witness else Value.unknown(), "c").cell())
                for col in (sa, sb, sc, sm):
                    region.assign_fixed(col, i, Value.known(1), "s")
                av = cv
            for i in range(DUP_ROWS - 1):
                region.constrain_equal(ccells[i], acells[i + 1])

        layouter.assign_region("main", main)


class MulCircuitV1(MulCircuit):
    """MulCircuit laid out by the V1 (dual-pass) floor planner."""

    floor_planner = V1FloorPlanner

    def without_witnesses(self):
        return MulCircuitV1(self.constant)


class MixedDegreeCircuit(Circuit):
    """Gates of degree 2 and 5 plus a lookup and copy constraints: spreads
    constraints across clusters 1, 2 and the running-product clusters so
    the `need_to_compute` part-skipping engine (evaluation.rs:426-428) is
    exercised with a non-trivial cluster split (L = 2, m = 4 parts)."""

    TABLE_BITS = 3

    def __init__(self, values=None):
        self.values = values  # list of ints < 2^TABLE_BITS, or None

    def without_witnesses(self):
        return MixedDegreeCircuit(None)

    @classmethod
    def configure(cls, meta: ConstraintSystem):
        a = meta.advice_column()
        b = meta.advice_column()
        table = meta.lookup_table_column()
        s_low = meta.selector()
        s_high = meta.selector()
        q = meta.complex_selector()
        meta.enable_equality(a)
        meta.enable_equality(b)

        def low_gate(cells):
            av = cells.query_advice(a, Rotation.cur())
            bv = cells.query_advice(b, Rotation.cur())
            s = cells.query_selector(s_low)
            return [s * (av - bv)]  # degree 2

        def high_gate(cells):
            av = cells.query_advice(a, Rotation.cur())
            bv = cells.query_advice(b, Rotation.cur())
            s = cells.query_selector(s_high)
            return [s * (av * av * av * av - bv)]  # degree 5

        meta.create_gate("low", low_gate)
        meta.create_gate("high", high_gate)

        def lookup_map(cells):
            av = cells.query_advice(a, Rotation.cur())
            qq = cells.query_selector(q)
            return [(qq * av, table)]

        meta.lookup("range", lookup_map)
        return (a, b, table, s_low, s_high, q)

    def synthesize(self, config, layouter):
        a, b, table, s_low, s_high, q = config

        def fill_table(t):
            for i in range(1 << self.TABLE_BITS):
                t.assign_cell(table, i, i, f"row {i}")

        layouter.assign_table("table", fill_table)
        values = self.values or [None] * 3

        def val(x):
            return Value.known(x) if x is not None else Value.unknown()

        def region_fn(region):
            cells = []
            for i, v in enumerate(values):
                q.enable(region, i)
                s_low.enable(region, i)
                ca = region.assign_advice(a, i, val(v), f"a{i}")
                cb = region.assign_advice(b, i, val(v), f"b{i}")
                region.constrain_equal(ca.cell(), cb.cell())
                cells.append(ca)
            # one high-degree row: b = a^4
            row = len(values)
            s_high.enable(region, row)
            q.enable(region, row)
            v0 = values[0]
            region.assign_advice(a, row, val(v0), "a_high")
            region.assign_advice(
                b, row, val(None if v0 is None else pow(v0, 4, Fp.MODULUS)), "b_high"
            )
            return cells

        layouter.assign_region("rows", region_fn)


# ---------------- the ECC and Sinsemilla gadgets' test circuits ----------------
#
# Copies of tests/test_ecc_gadget.py, test_ecc_var_mul.py, test_ecc_fixed.py,
# test_sinsemilla_gadget.py, test_sinsemilla_fused.py and
# test_sinsemilla_merkle.py: the same columns, regions and names, so both
# packages' MockProver render the same failures and keygen the same keys.


def _val(v):
    return Value.unknown() if v is None else Value.known(v)


class EccOpsCircuit(Circuit):
    """Witness P, Q; check P+Q (complete & incomplete), P+P, P+(-P),
    identity cases, and [s]P for a small scalar width."""

    MUL_BITS = 8

    def __init__(self, p=None, q=None, s=None):
        self.p, self.q, self.s = p, q, s

    def without_witnesses(self):
        return type(self)()

    @classmethod
    def configure(cls, meta: ConstraintSystem):
        from .gadgets.ecc import EccChip

        advices = [meta.advice_column() for _ in range(10)]
        constants = meta.fixed_column()
        meta.enable_constant(constants)
        return EccChip.configure(meta, advices)

    def synthesize(self, config, layouter: Layouter):
        from .curves import Pallas
        from .gadgets.ecc import EccChip

        chip = EccChip(config)
        p = chip.witness_point(layouter, _val(self.p))
        q = chip.witness_point(layouter, _val(self.q))

        # complete addition covers all cases
        r = chip.add(layouter, p, q)
        if self.p is not None:
            assert r.point().force_value() == self.p + self.q
        # doubling through the complete gate
        d = chip.add(layouter, p, p)
        if self.p is not None:
            assert d.point().force_value() == self.p + self.p
        # identity + P
        idp = chip.witness_point(layouter, _val(Pallas.identity() if self.p is not None else None))
        r2 = chip.add(layouter, idp, p)
        if self.p is not None:
            assert r2.point().force_value() == self.p
        # incomplete addition (valid case)
        if self.p is None or (not self.p.is_identity() and not self.q.is_identity()
                              and self.p.xy[0] != self.q.xy[0]):
            pi = chip.witness_point_non_id(layouter, _val(self.p))
            qi = chip.witness_point_non_id(layouter, _val(self.q))
            ri = chip.add_incomplete(layouter, pi, qi)
            if self.p is not None:
                assert ri.point().force_value() == self.p + self.q
        # variable-base mul (small width for test speed)
        m, _ = chip.mul(layouter, _val(self.s), p, num_bits=self.MUL_BITS)
        if self.p is not None:
            assert m.point().force_value() == self.p.mul(self.s)


class FullMulCircuit(EccOpsCircuit):
    """Full 255-bit variable-base multiplication [s]P
    (tests/test_ecc_gadget.py::test_ecc_var_base_mul_full_width, k = 12)."""

    def synthesize(self, config, layouter):
        from .gadgets.ecc import EccChip

        chip = EccChip(config)
        p = chip.witness_point(layouter, _val(self.p))
        m, _ = chip.mul(layouter, _val(self.s), p, num_bits=255)
        if self.p is not None:
            assert m.point().force_value() == self.p.mul(self.s)


def full_mul_inputs():
    """(base, scalar) of the full-width case: random.Random(23)."""
    import random

    from .curves import Pallas

    rng = random.Random(23)
    base = Pallas.generator().mul(rng.randrange(2, 1 << 64))
    return base, rng.randrange(1, Pallas.SCALAR.MODULUS)


class VarMulCircuit(Circuit):
    """The row-optimised variable-base multiplication [alpha]T with the
    10-bit overflow-check table loaded."""

    def __init__(self, alpha=None, base=None):
        self.alpha = alpha  # base-field int or None
        self.base = base  # Pallas Point or None

    def without_witnesses(self):
        return VarMulCircuit(None, None)

    @classmethod
    def configure(cls, meta: ConstraintSystem):
        from .gadgets.ecc import EccChip
        from .gadgets.utilities import LookupRangeCheckConfig

        advices = [meta.advice_column() for _ in range(10)]
        table = meta.lookup_table_column()
        lookup = LookupRangeCheckConfig.configure(meta, advices[9], table, 10, Fp)
        constants = meta.fixed_column()
        meta.enable_constant(constants)
        return EccChip.configure(meta, advices, lookup_config=lookup)

    def synthesize(self, config, layouter: Layouter):
        from .fields import Fq
        from .gadgets.ecc import EccChip
        from .gadgets.utilities import load_private

        chip = EccChip(config)
        config.var_mul.lookup.load(layouter)
        base = chip.witness_point_non_id(layouter, _val(self.base))
        alpha = load_private(layouter, config.advices[0], _val(self.alpha))
        result, _ = chip.mul_var(layouter, alpha, base)
        if self.alpha is not None:
            assert result.point().force_value() == self.base.mul(self.alpha % Fq.MODULUS)


@lru_cache(maxsize=None)
def fixed_base(num_windows: int):
    """The Pallas generator as a FixedPointBase with `num_windows` windows
    (85 for full-width scalars, 22 for short ones), made once."""
    from .curves import Pallas
    from .gadgets.ecc_fixed import FixedPointBase

    return FixedPointBase(Pallas.generator(), num_windows)


class FixedMulCircuit(Circuit):
    """Fixed-base multiplication by the Pallas generator; `variant` is
    'full' (a full-width scalar), 'short' (a signed 64-bit one) or 'base' (a
    base-field element)."""

    variant = "full"

    def __init__(self, scalar=None, sign=1):
        self.scalar = scalar
        self.sign = sign

    def without_witnesses(self):
        return type(self)()

    @classmethod
    def configure(cls, meta: ConstraintSystem):
        from .gadgets.ecc import EccChip
        from .gadgets.ecc_fixed import MulFixedConfig
        from .gadgets.utilities import LookupRangeCheckConfig

        advices = [meta.advice_column() for _ in range(10)]
        constants = meta.fixed_column()
        meta.enable_constant(constants)
        ecc = EccChip.configure(meta, advices)
        lookup = None
        if cls.variant == "base":
            table_idx = meta.lookup_table_column()
            lookup = LookupRangeCheckConfig.configure(meta, advices[8], table_idx, 10, Fp)
        mf = MulFixedConfig(meta, ecc, lookup)
        return ecc, mf

    def synthesize(self, config, layouter: Layouter):
        from .fields import Fq
        from .gadgets.ecc import EccChip
        from .gadgets.ecc_fixed import (NUM_WINDOWS, NUM_WINDOWS_SHORT, MulFixedBaseField,
                                        MulFixedFullWidth, MulFixedShort)
        from .gadgets.utilities import load_private

        ecc, mf = config
        chip = EccChip(ecc)
        g = fixed_base(NUM_WINDOWS).generator
        P, Q = Fp.MODULUS, Fq.MODULUS
        val = _val(self.scalar)
        if self.variant == "full":
            result, _ = MulFixedFullWidth(mf, chip).assign(layouter, val, fixed_base(NUM_WINDOWS))
            if self.scalar is not None:
                assert result.point().force_value() == g.mul(self.scalar)
        elif self.variant == "short":
            magnitude = load_private(layouter, ecc.advices[0], val)
            sign_v = (
                Value.unknown() if self.scalar is None
                else Value.known(1 if self.sign == 1 else P - 1)
            )
            sign = load_private(layouter, ecc.advices[1], sign_v)
            result, _ = MulFixedShort(mf, chip).assign(layouter, (magnitude, sign),
                                                       fixed_base(NUM_WINDOWS_SHORT))
            if self.scalar is not None and self.scalar < (1 << 64):
                expected = g.mul(self.scalar if self.sign == 1 else Q - self.scalar)
                assert result.point().force_value() == expected
        else:
            mf.lookup.load(layouter)
            alpha = load_private(layouter, ecc.advices[0], val)
            result = MulFixedBaseField(mf, chip).assign(layouter, alpha, fixed_base(NUM_WINDOWS))
            if self.scalar is not None:
                assert result.point().force_value() == g.mul(self.scalar % Q)


class ShortMulCircuit(FixedMulCircuit):
    variant = "short"


class BaseFieldMulCircuit(FixedMulCircuit):
    variant = "base"


SINSEMILLA_NUM_WORDS = 3
SINSEMILLA_DOMAIN = "sinsemilla-gadget-test"
SINSEMILLA_SEED = b"\x04" * 32


class SinsemillaCircuit(Circuit):
    """SinsemillaHashToPoint of SINSEMILLA_NUM_WORDS 10-bit words through the
    Sinsemilla chip (10 ECC advice columns, 3 Sinsemilla advice columns, one
    constants column, the 2^10-row generator table)."""

    def __init__(self, bits=None):
        self.bits = bits  # SINSEMILLA_NUM_WORDS * K bools or None

    def without_witnesses(self):
        return type(self)(None)

    @classmethod
    def configure(cls, meta: ConstraintSystem):
        from .gadgets.ecc import EccChip
        from .gadgets.sinsemilla import SinsemillaChip

        ecc_advices = [meta.advice_column() for _ in range(10)]
        ecc_config = EccChip.configure(meta, ecc_advices)
        sin_advices = [meta.advice_column() for _ in range(3)]
        constants = meta.fixed_column()
        meta.enable_constant(constants)
        return SinsemillaChip.configure(meta, sin_advices, ecc_config)

    def synthesize(self, config, layouter: Layouter):
        from .gadgets.sinsemilla import SinsemillaChip, SinsemillaHashGadget
        from .gadgets.sinsemilla_primitives import HashDomain

        chip = SinsemillaChip(config)
        chip.load_table(layouter)
        domain = HashDomain(SINSEMILLA_DOMAIN)
        gadget = SinsemillaHashGadget(chip, domain)
        out = gadget.hash_to_point(layouter, self.bits, SINSEMILLA_NUM_WORDS)
        if self.bits is not None:
            assert out.point().force_value() == domain.hash_to_point(self.bits)


def sinsemilla_bits(seed: int = 21):
    """The message of gating config 4: SINSEMILLA_NUM_WORDS * K bits drawn
    from random.Random(seed)."""
    import random

    from .gadgets.sinsemilla_primitives import K

    rng = random.Random(seed)
    return [bool(rng.getrandbits(1)) for _ in range(SINSEMILLA_NUM_WORDS * K)]


def sinsemilla_k14():
    """Gating config 4 of BASELINE.md: (k, circuit, instances, rng seed) of
    SinsemillaCircuit at k = 14, as `tests/golden_circuits.py` proves it."""
    return 14, SinsemillaCircuit(sinsemilla_bits()), [], SINSEMILLA_SEED


def sinsemilla_k11():
    """The same circuit, message and seed at k = 11, the size of the JAX
    package's MockProver test (the generator table fills half the rows)."""
    return 11, SinsemillaCircuit(sinsemilla_bits()), [], SINSEMILLA_SEED


FUSED_NUM_WORDS = 30  # two pieces: 25 + 5 words
FUSED_DOMAIN = "sinsemilla-fused-test"


class FusedCircuit(Circuit):
    """The fused one-row-per-word Sinsemilla chip hashing FUSED_NUM_WORDS
    words."""

    def __init__(self, bits=None):
        self.bits = bits

    def without_witnesses(self):
        return type(self)(None)

    @classmethod
    def configure(cls, meta: ConstraintSystem):
        from .gadgets.sinsemilla_fused import SinsemillaFusedChip

        advices = [meta.advice_column() for _ in range(5)]
        witness_pieces = meta.advice_column()
        constants = meta.fixed_column()
        meta.enable_constant(constants)
        return SinsemillaFusedChip.configure(meta, advices, witness_pieces)

    def synthesize(self, config, layouter: Layouter):
        from .gadgets.sinsemilla_fused import SinsemillaFusedChip
        from .gadgets.sinsemilla_primitives import HashDomain

        chip = SinsemillaFusedChip(config)
        chip.load_table(layouter)
        domain = HashDomain(FUSED_DOMAIN)
        pieces = chip.witness_message(layouter, self.bits, FUSED_NUM_WORDS)
        out = chip.hash_to_point(layouter, domain.Q, pieces)
        if self.bits is not None:
            expected = domain.hash_to_point(self.bits)
            got = out.point().force_value()
            assert got == expected, (got, expected)


MERKLE_DEPTH = 2


def merkle_host_root(leaf: int, pos: int, path) -> int:
    """The Merkle root of `leaf` at position `pos` under the sibling `path`,
    by MerkleCRH on the host."""
    from .gadgets.sinsemilla_merkle import merkle_crh, merkle_crh_domain

    domain = merkle_crh_domain()
    node = leaf
    for l, sibling in enumerate(path):
        bit = (pos >> l) & 1
        left, right = (sibling, node) if bit else (node, sibling)
        node = merkle_crh(domain, l, left, right)
    return node


def merkle_inputs():
    """(leaf, pos, path, root) of the depth-2 Merkle case: random.Random(21)."""
    import random

    rng = random.Random(21)
    leaf = rng.randrange(Fp.MODULUS)
    path = [rng.randrange(Fp.MODULUS) for _ in range(MERKLE_DEPTH)]
    pos = rng.randrange(1 << MERKLE_DEPTH)
    return leaf, pos, path, merkle_host_root(leaf, pos, path)


class MerkleCircuit(Circuit):
    """A Merkle path of depth MERKLE_DEPTH: MerkleCRH (Sinsemilla) per layer,
    the cond-swap of the node and its sibling, and the 10-bit lookup range
    checks on the generator table's index column."""

    def __init__(self, leaf=None, pos=None, path=None, expected_root=None):
        self.leaf = leaf
        self.pos = pos
        self.path = path or [None] * MERKLE_DEPTH
        self.expected_root = expected_root

    def without_witnesses(self):
        return type(self)()

    @classmethod
    def configure(cls, meta: ConstraintSystem):
        from .gadgets.ecc import EccChip
        from .gadgets.sinsemilla import SinsemillaChip
        from .gadgets.sinsemilla_merkle import MerkleChip
        from .gadgets.sinsemilla_primitives import K
        from .gadgets.utilities import LookupRangeCheckConfig

        ecc_advices = [meta.advice_column() for _ in range(10)]
        constants = meta.fixed_column()
        meta.enable_constant(constants)
        ecc = EccChip.configure(meta, ecc_advices)
        sin_advices = [meta.advice_column() for _ in range(3)]
        sin = SinsemillaChip.configure(meta, sin_advices, ecc)
        # 10-bit lookup range check sharing the generator index table
        lookup_col = meta.advice_column()
        lookup = LookupRangeCheckConfig.configure(meta, lookup_col, sin.table_idx, K, Fp)
        merkle_advices = [meta.advice_column() for _ in range(5)]
        return MerkleChip.configure(meta, merkle_advices, sin, lookup)

    def synthesize(self, config, layouter: Layouter):
        from .gadgets.poseidon import _as_int
        from .gadgets.sinsemilla_merkle import MerkleChip, MerklePath, merkle_crh_domain
        from .gadgets.utilities import load_private

        chip = MerkleChip(config)
        chip.sinsemilla.load_table(layouter)
        leaf = load_private(layouter, config.advices[0], _val(self.leaf))
        path = MerklePath(chip, merkle_crh_domain(), self.pos, self.path)
        root = path.calculate_root(layouter, leaf)
        if self.expected_root is not None:
            rv = root.value()
            assert not rv.is_none()
            assert _as_int(rv.force_value(), Fp.MODULUS) == self.expected_root % Fp.MODULUS


SHA256_SEED = b"\x05" * 32
# 887 bytes pad to exactly 14 blocks (887 + 1 + 8 = 896 = 14 * 64): the most
# that fit in 2^17 rows, at about 8 980 rows a block.
SHA256_K17_MESSAGE_BYTES = 887
SHA256_K17_MESSAGE_SEED = 17


def sha256_digest_words(message: bytes) -> List[int]:
    """hashlib's SHA-256 of `message` as eight big-endian 32-bit words."""
    import hashlib

    h = hashlib.sha256(message).digest()
    return [int.from_bytes(h[4 * i: 4 * i + 4], "big") for i in range(8)]


class ShaCircuit(Circuit):
    """SHA-256 of `message` through the Table16 chip over `num_blocks` padded
    blocks (6 advice columns, one constants column, the 2^16-row spread
    table); `synthesize` checks the digest against hashlib's."""

    def __init__(self, message: Optional[bytes] = None, num_blocks: int = 1):
        self.message = message
        self.num_blocks = num_blocks

    def without_witnesses(self):
        return type(self)(None, self.num_blocks)

    @classmethod
    def configure(cls, meta: ConstraintSystem):
        from .gadgets.sha256 import Table16Chip

        constants = meta.fixed_column()
        meta.enable_constant(constants)
        return Table16Chip.configure(meta)

    def synthesize(self, config, layouter: Layouter):
        from .gadgets.sha256 import Sha256, Table16Chip

        chip = Table16Chip(config)
        chip.load_table(layouter)
        digest = Sha256(chip).digest_bytes(layouter, self.message, self.num_blocks)
        if self.message is not None:
            got = [d.value for d in digest]
            expected = sha256_digest_words(self.message)
            assert got == expected, (got, expected)


def sha256_k17_message() -> bytes:
    """The SHA-256 workload's message: SHA256_K17_MESSAGE_BYTES bytes drawn
    from random.Random(SHA256_K17_MESSAGE_SEED)."""
    import random

    rng = random.Random(SHA256_K17_MESSAGE_SEED)
    return bytes(rng.getrandbits(8) for _ in range(SHA256_K17_MESSAGE_BYTES))


def sha256_k17():
    """(k, circuit, instances, rng seed) of ShaCircuit at k = 17 over the
    14 blocks of sha256_k17_message()."""
    from .gadgets.sha256 import sha256_pad

    message = sha256_k17_message()
    return 17, ShaCircuit(message, len(sha256_pad(message))), [], SHA256_SEED
