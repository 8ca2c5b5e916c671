"""The port's ECC gadgets on the CPU, held to the JAX package.

Host constants (the fixed-base window tables, their Lagrange coefficients,
the zs/us cache) must equal the JAX package's; every test circuit must give
both packages the same constraint system, and both packages' MockProver the
same witness and the same failures, rendered as text. Cases at k <= 7 run
live against the JAX package. The k = 11 and k = 12 cases are held to
tests/fixtures_torch_ecc.json, which was written once on the CPU with

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_ecc.py

from the JAX package's MockProver (a `slow` twin recomputes it).
The helpers here are shared with tests/test_torch_sinsemilla.py.
"""

import hashlib
import json
import os
import random
import sys

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
sys.path[:0] = [p for p in (ROOT, TESTS) if p not in sys.path]


def _settle_native_build():
    """Load the JAX package's native host library once, up front. When
    several test workers build it at once, the loser's rename raises
    (halo2_tpu/native/build.py); the JAX package then runs its pure-Python
    curve path in this worker, which tests/test_native.py holds equal."""
    from halo2_tpu import native

    try:
        native.available()
    except OSError:
        pass


_settle_native_build()

import test_ecc_fixed as jfixed  # noqa: E402
import test_ecc_gadget as jgadget  # noqa: E402
import test_ecc_var_mul as jvarmul  # noqa: E402
import torch  # noqa: E402

from halo2_tpu.curves import Pallas as JPallas  # noqa: E402
from halo2_tpu.dev.mock_prover import MockProver as JMockProver  # noqa: E402
from halo2_tpu.frontend import Value as JValue  # noqa: E402
from halo2_tpu.gadgets import ecc as jecc, ecc_api as japi, ecc_fixed as jef  # noqa: E402
from halo2_tpu.gadgets import utilities as jutil  # noqa: E402
from halo2_tpu.plonk import ConstraintSystem as JConstraintSystem, pinned as jpinned  # noqa: E402
from halo2_tpu_torch import circuits  # noqa: E402
from halo2_tpu_torch.curves import Pallas  # noqa: E402
from halo2_tpu_torch.dev.mock_prover import MockProver  # noqa: E402
from halo2_tpu_torch.fields import Fp, Fq  # noqa: E402
from halo2_tpu_torch.frontend import Value  # noqa: E402
from halo2_tpu_torch.gadgets import ecc, ecc_api as api, ecc_fixed as ef  # noqa: E402
from halo2_tpu_torch.gadgets import utilities as util  # noqa: E402
from halo2_tpu_torch.plonk import ConstraintSystem, pinned  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """MockProver's vectorised check is many small torch ops; one thread
    each spares them the barriers that stall when the workers share cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


FIXTURE = os.path.join(TESTS, "fixtures_torch_ecc.json")
P = Fp.MODULUS
Q = Fq.MODULUS


# ---------------- helpers shared with test_torch_sinsemilla.py ----------------


def render(failures):
    return [[f.kind, str(f)] for f in failures]


def witness_digest(prover) -> str:
    """sha256 of what a MockProver run assigned: fixed, advice and selector
    cells, the copy permutation and the challenges."""
    state = (prover.fixed, prover.advice, prover.selectors, prover.permutation.mapping,
             sorted(prover.challenges.items()))
    return hashlib.sha256(repr(state).encode()).hexdigest()


def mock_record(prover, vectorized):
    """What a MockProver run is compared by: the witness digest and the
    failures as rendered text."""
    return {"witness": witness_digest(prover), "failures": render(prover.verify(vectorized=vectorized))}


def port_record(k, circuit):
    """The port's record, from its row loop; where that finds a failure, or
    the circuit is small, the vectorised check (the card's path, here on
    the CPU) must render the same."""
    prover = MockProver.run(k, circuit, [], device="cpu")
    record = mock_record(prover, vectorized=False)
    if record["failures"] or k <= 7:
        assert render(prover.verify(vectorized=True)) == record["failures"]
    return record


def jax_record(k, circuit):
    """The JAX package's record, from its row loop (the reference's
    semantics, and no XLA compile)."""
    return mock_record(JMockProver.run(k, circuit, []), vectorized=False)


def cs_summary(pinned_mod, cs_cls, circuit_cls):
    """A circuit's constraint system as text: the column counts, every gate
    (name, constraint names, expressions), every lookup, the permutation's
    columns, the constants and the degree."""
    cs = cs_cls()
    circuit_cls.configure(cs)

    def expr(e):
        return pinned_mod.render(pinned_mod.expression(e), False)

    return {
        "columns": [cs.num_fixed_columns, cs.num_advice_columns, cs.num_instance_columns,
                    cs.num_selectors],
        "gates": [[g.name, list(g.constraint_names), [expr(p) for p in g.polys]] for g in cs.gates],
        "lookups": [[lk.name, [expr(e) for e in lk.input_expressions],
                     [expr(e) for e in lk.table_expressions]] for lk in cs.lookups],
        "permutation": [str(c) for c in cs.permutation.columns],
        "constants": [str(c) for c in cs.constants],
        "degree": cs.degree(),
        "blinding_factors": cs.blinding_factors(),
    }


def port_cs(circuit_cls):
    return cs_summary(pinned, ConstraintSystem, circuit_cls)


def jax_cs(circuit_cls):
    return cs_summary(jpinned, JConstraintSystem, circuit_cls)


def jpoint(pt):
    """The JAX package's copy of a port point."""
    return JPallas.identity() if pt.is_identity() else JPallas.from_xy(*pt.xy)


def pin_cases(cases, path):
    """Write the JAX package's records of `cases` (name -> (k, JAX circuit,
    port circuit)) to `path`."""
    out = {name: {"k": k, **jax_record(k, make())} for name, (k, make, _) in cases.items()}
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    return out


# ---------------- host constants ----------------

G = Pallas.generator()
JG = JPallas.generator()


def test_point_copies_agree():
    assert jpoint(G) == JG
    assert jpoint(G.mul(12345)) == JG.mul(12345)
    assert jpoint(Pallas.identity()).is_identity()


@pytest.mark.parametrize("num_windows", [ef.NUM_WINDOWS_SHORT, ef.NUM_WINDOWS])
def test_window_table_matches_jax(num_windows):
    table = ef.compute_window_table(G, num_windows)
    jtable = jef.compute_window_table(JG, num_windows)
    assert len(table) == num_windows and all(len(w) == ef.H for w in table)
    assert [[pt.xy for pt in w] for w in table] == [[pt.xy for pt in w] for w in jtable]


@pytest.mark.parametrize("num_windows", [ef.NUM_WINDOWS_SHORT, ef.NUM_WINDOWS])
def test_lagrange_coeffs_match_jax_and_interpolate(num_windows):
    from halo2_tpu_torch.poly import eval_polynomial_host

    coeffs = ef.compute_lagrange_coeffs(G, num_windows)
    assert coeffs == jef.compute_lagrange_coeffs(JG, num_windows)
    table = ef.compute_window_table(G, num_windows)
    for w in (0, 1, num_windows - 1):
        for k in range(ef.H):
            assert eval_polynomial_host(coeffs[w], k, P) == table[w][k].xy[0], (w, k)


def test_msb_window_offset_correction():
    """The windows' multiples, with the MSB window's correction, sum to
    [s]B (constants.rs:40-82)."""
    s = random.Random(5).randrange(Q)
    windows = [(s >> (3 * i)) & 7 for i in range(ef.NUM_WINDOWS)]
    acc = Pallas.identity()
    for w in range(ef.NUM_WINDOWS - 1):
        acc = acc + G.mul((windows[w] + 2) * pow(ef.H, w, Q) % Q)
    offset = sum(1 << (3 * j + 1) for j in range(ef.NUM_WINDOWS - 1))
    acc = acc + G.mul((windows[-1] * pow(ef.H, ef.NUM_WINDOWS - 1, Q) - offset) % Q)
    assert acc == G.mul(s)


def _cached_bases():
    from halo2_tpu_torch.gadgets.sinsemilla_primitives import CommitDomain

    return {
        "G-85": (G, ef.NUM_WINDOWS),
        "G-22": (G, ef.NUM_WINDOWS_SHORT),
        "test-commit-R-85": (CommitDomain("test-commit").R, ef.NUM_WINDOWS),
    }


def _cache_name(base, num_windows):
    key = hashlib.blake2b(base.to_bytes() + num_windows.to_bytes(2, "little"),
                          digest_size=16).hexdigest()
    return f"zs_us_{key}.json"


@pytest.mark.parametrize("name", ["G-85", "G-22", "test-commit-R-85"])
def test_zs_us_cache_is_seeded_from_the_jax_files(name, monkeypatch):
    base, nw = _cached_bases()[name]
    fname = _cache_name(base, nw)
    port_file = os.path.join(ROOT, "halo2_tpu_torch", "_cache", fname)
    assert ef._ZS_US_CACHE_DIR == os.path.dirname(port_file)
    with open(port_file, "rb") as f, open(os.path.join(ROOT, "halo2_tpu", "_cache", fname), "rb") as g:
        assert f.read() == g.read()

    def no_search(*_):
        raise AssertionError("the cached base was searched again")

    monkeypatch.setattr(ef, "find_zs_and_us", no_search)
    zs_us = ef.find_zs_and_us_cached(base, nw)
    assert zs_us == jef.find_zs_and_us_cached(jpoint(base), nw)
    # the values certify each window's y-coordinates (constants.rs:117-148)
    table = ef.compute_window_table(base, nw)
    assert len(zs_us) == nw
    for w, (z, us) in enumerate(zs_us):
        for k in range(ef.H):
            y = table[w][k].xy[1]
            assert us[k] * us[k] % P == (z + y) % P
            assert not ef._is_square(z - y, P)


def test_zs_us_cache_publishes_a_new_base_through_a_per_process_temp_name(tmp_path, monkeypatch):
    """A base with no file yet: its zs/us land in the port's cache directory
    (here tmp_path) through a temporary name with this process's id, and
    are read back from there; nothing is written under either package's
    tracked cache."""
    tracked = [os.path.join(ROOT, pkg, "_cache") for pkg in ("halo2_tpu", "halo2_tpu_torch")]
    before = {d: sorted(os.listdir(d)) for d in tracked}
    base = G.mul(12345)
    fake = [(w + 1, [w * ef.H + k for k in range(ef.H)]) for w in range(2)]
    searched, replaced = [], []
    real_replace = os.replace

    def recording_replace(src, dst):
        replaced.append((str(src), str(dst)))
        return real_replace(src, dst)

    monkeypatch.setattr(ef, "_ZS_US_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(ef, "find_zs_and_us", lambda b, nw: searched.append(nw) or fake)
    monkeypatch.setattr(os, "replace", recording_replace)
    assert ef.find_zs_and_us_cached(base, 2) == fake
    path = str(tmp_path / _cache_name(base, 2))
    assert replaced == [(f"{path}.{os.getpid()}.tmp", path)]
    assert sorted(os.listdir(tmp_path)) == [_cache_name(base, 2)]
    assert ef.find_zs_and_us_cached(base, 2) == fake
    assert searched == [2]
    assert {d: sorted(os.listdir(d)) for d in tracked} == before


def test_fixed_point_base_matches_jax():
    fpb = circuits.fixed_base(ef.NUM_WINDOWS_SHORT)
    jfpb = jfixed._SHORT
    assert (fpb.lagrange_coeffs, fpb.z, fpb.u) == (jfpb.lagrange_coeffs, jfpb.z, jfpb.u)


def test_inv0_matches_jax():
    rng = random.Random(3)
    for v in [0, 1, P - 1] + [rng.randrange(P) for _ in range(5)]:
        assert ecc._inv0(v) == jecc._inv0(v)


# ---------------- constraint systems ----------------

CS_CIRCUITS = {
    "ecc_ops": (circuits.EccOpsCircuit, jgadget.EccOpsCircuit),
    "var_mul": (circuits.VarMulCircuit, jvarmul.VarMulCircuit),
    "fixed_full": (circuits.FixedMulCircuit, jfixed.FixedMulCircuit),
    "fixed_short": (circuits.ShortMulCircuit, jfixed.ShortMulCircuit),
    "fixed_base_field": (circuits.BaseFieldMulCircuit, jfixed.BaseFieldMulCircuit),
}


@pytest.mark.parametrize("name", sorted(CS_CIRCUITS))
def test_constraint_system_matches_jax(name):
    port_cls, jax_cls = CS_CIRCUITS[name]
    summary = port_cs(port_cls)
    assert summary == jax_cs(jax_cls)
    assert summary["gates"] and summary["permutation"]


# ---------------- MockProver, live against the JAX package (k <= 7) ----------------


def _ops_inputs(pallas):
    random.seed(11)
    g = pallas.generator()
    p = g.mul(random.randrange(2, 1000))
    q = g.mul(random.randrange(2, 1000))
    s = random.randrange(1, 1 << circuits.EccOpsCircuit.MUL_BITS)
    return p, q, s


def _neg_circuit(base, chip_cls, value_cls):
    class NegCircuit(base):
        """P + (-P) = identity through the complete gate."""

        def synthesize(self, config, layouter):
            chip = chip_cls(config)
            val = lambda v: value_cls.unknown() if v is None else value_cls.known(v)  # noqa: E731
            p = chip.witness_point(layouter, val(self.p))
            np_ = chip.witness_point(layouter, val(-self.p if self.p else None))
            r = chip.add(layouter, p, np_)
            if self.p is not None:
                assert r.point().force_value().is_identity()

    return NegCircuit


def _bad_point_circuit(base, value_cls):
    class BadCircuit(base):
        """A point off the curve must fail the witness gate."""

        def synthesize(self, config, layouter):
            def in_region(region):
                region.enable_selector(config.q_point_non_id, 0)
                region.assign_advice(config.x_p, 0, value_cls.known(3), "x")
                region.assign_advice(config.y_p, 0, value_cls.known(4), "y")

            layouter.assign_region("bad point", in_region)

    return BadCircuit


def _short_inputs():
    rng = random.Random(8)
    return [(rng.randrange(1, 1 << 64), 1), ((1 << 64) - 1, -1), (1, -1), (1 << 64, 1)]


# name -> (k, port circuit, JAX circuit, failures expected)
LIVE = {
    "ops": (7, lambda: circuits.EccOpsCircuit(*_ops_inputs(Pallas)),
            lambda: jgadget.EccOpsCircuit(*_ops_inputs(JPallas)), False),
    "neg": (7, lambda: _neg_circuit(circuits.EccOpsCircuit, ecc.EccChip, Value)(G.mul(5), G, 1),
            lambda: _neg_circuit(jgadget.EccOpsCircuit, jecc.EccChip, JValue)(JG.mul(5), JG, 1), False),
    "bad_point_k6": (6, lambda: _bad_point_circuit(circuits.EccOpsCircuit, Value)(),
                     lambda: _bad_point_circuit(jgadget.EccOpsCircuit, JValue)(), True),
    "fixed_full": (7, lambda: circuits.FixedMulCircuit(random.Random(7).randrange(1, Q)),
                   lambda: jfixed.FixedMulCircuit(random.Random(7).randrange(1, Q)), False),
}
for _i, (_m, _s) in enumerate(_short_inputs()):
    LIVE[f"fixed_short_{_i}"] = (7, lambda m=_m, s=_s: circuits.ShortMulCircuit(m, s),
                                 lambda m=_m, s=_s: jfixed.ShortMulCircuit(m, s), _m >= 1 << 64)


@pytest.mark.parametrize("name", sorted(LIVE))
def test_mock_prover_matches_jax_live(name):
    k, port_circuit, jax_circuit, fails = LIVE[name]
    record = port_record(k, port_circuit())
    assert record == jax_record(k, jax_circuit())
    assert bool(record["failures"]) == fails


# ---------------- MockProver, against the pinned JAX records (k = 11, 12) ----------------

VAR_MUL_ALPHAS = {
    "one": 1,
    "hi_lo_boundary": (1 << 130) - 1,
    "two_130": 1 << 130,
    "p_minus_1": Fp.MODULUS - 1,
    "small": 0xDEADBEEF1234,
}


def _var_mul_random(pallas):
    rng = random.Random(99)
    base = pallas.generator().mul(rng.randrange(1, 1 << 64))
    return rng.randrange(Fp.MODULUS), base


def _full_mul_circuit(base_cls, chip_cls, value_cls):
    class FullMulCircuit(base_cls):
        def synthesize(self, config, layouter):
            chip = chip_cls(config)
            val = lambda v: value_cls.unknown() if v is None else value_cls.known(v)  # noqa: E731
            p = chip.witness_point(layouter, val(self.p))
            m, _ = chip.mul(layouter, val(self.s), p, num_bits=255)
            if self.p is not None:
                assert m.point().force_value() == self.p.mul(self.s)

    return FullMulCircuit


def _jax_full_mul():
    base, s = circuits.full_mul_inputs()
    jb = jpoint(base)
    return _full_mul_circuit(jgadget.EccOpsCircuit, jecc.EccChip, JValue)(jb, jb, s)


def _port_full_mul():
    base, s = circuits.full_mul_inputs()
    return circuits.FullMulCircuit(base, base, s)


# name -> (k, JAX circuit, port circuit)
PINNED = {
    "full_mul_k12": (12, _jax_full_mul, _port_full_mul),
    "var_mul_random": (11, lambda: jvarmul.VarMulCircuit(*_var_mul_random(JPallas)),
                       lambda: circuits.VarMulCircuit(*_var_mul_random(Pallas))),
    "base_field_mul": (11, lambda: jfixed.BaseFieldMulCircuit(random.Random(9).randrange(1, P)),
                       lambda: circuits.BaseFieldMulCircuit(random.Random(9).randrange(1, P))),
}
for _name, _a in VAR_MUL_ALPHAS.items():
    PINNED[f"var_mul_{_name}"] = (11, lambda a=_a: jvarmul.VarMulCircuit(a, JG.mul(7)),
                                  lambda a=_a: circuits.VarMulCircuit(a, G.mul(7)))


def _pinned():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(PINNED))
def test_mock_prover_matches_pinned_jax_record(name):
    k, _, port_circuit = PINNED[name]
    want = _pinned()[name]
    assert want["k"] == k and want["failures"] == []
    assert {"k": k, **port_record(k, port_circuit())} == want


@pytest.mark.slow  # the JAX package's MockProver on every pinned case
def test_pinned_records_recomputed_from_jax():
    assert {name: {"k": k, **jax_record(k, make())} for name, (k, make, _) in PINNED.items()} == _pinned()


# ---------------- the typed API (ecc_api) ----------------


def _api_circuit(pkg):
    """Every wrapper of ecc_api in one circuit: Point / NonIdentityPoint
    addition, variable-base, full-width, short and base-field fixed-base
    multiplication, and constrain_equal between two routes to one point."""
    circuit_cls, value_cls, cs_cls, api_mod, util_mod, pallas, fixed_bases = pkg

    class ApiCircuit(circuit_cls):
        def __init__(self, p=None, s=None, short=None, elem=None):
            self.p, self.s, self.short, self.elem = p, s, short, elem

        def without_witnesses(self):
            return ApiCircuit()

        @classmethod
        def configure(cls, meta: cs_cls):
            advices = [meta.advice_column() for _ in range(10)]
            constants = meta.fixed_column()
            meta.enable_constant(constants)
            table_idx = meta.lookup_table_column()
            lookup = util_mod.LookupRangeCheckConfig.configure(meta, advices[8], table_idx, 10,
                                                               pallas.BASE)
            return api_mod.EccGadgetConfig.configure(meta, advices, lookup)

        def synthesize(self, config, layouter):
            known = self.p is not None
            val = lambda v: value_cls.known(v) if known else value_cls.unknown()  # noqa: E731
            chip = api_mod.EccGadgetChip(config)
            config.mul_fixed.lookup.load(layouter)
            full, short = fixed_bases
            p = api_mod.NonIdentityPoint.new(chip, layouter, val(self.p))
            g = api_mod.Point.new(chip, layouter, val(full.generator))
            sum_pg = p.add(layouter, g)
            inc = p.add_incomplete(layouter, api_mod.NonIdentityPoint.new(chip, layouter, val(full.generator)))
            sum_pg.constrain_equal(layouter, inc)
            by = api_mod.ScalarVar.new(chip, layouter, val(self.s))
            mul_p, _ = p.mul(layouter, by)
            mul_g, _ = api_mod.FixedPoint(chip, full).mul(
                layouter, api_mod.ScalarFixed.new(chip, layouter, val(self.s)))
            magnitude, sign = self.short if known else (None, None)
            mag = util_mod.load_private(layouter, config.ecc.advices[0], val(magnitude))
            sgn = util_mod.load_private(layouter, config.ecc.advices[1],
                                        val(None if sign is None else sign % pallas.BASE.MODULUS))
            mul_short, _ = api_mod.FixedPointShort(chip, short).mul(
                layouter, api_mod.ScalarFixedShort.new(chip, layouter, (mag, sgn)))
            elem = util_mod.load_private(layouter, config.ecc.advices[0], val(self.elem))
            mul_elem = api_mod.FixedPointBaseField(chip, full).mul(layouter, elem)
            x = mul_g.extract_p()
            if known:
                q = pallas.SCALAR.MODULUS
                gen = full.generator
                assert sum_pg.inner.point().force_value() == self.p + gen
                assert mul_p.inner.point().force_value() == self.p.mul(self.s)
                assert mul_g.inner.point().force_value() == gen.mul(self.s)
                assert x.inner.value().force_value() is not None
                assert mul_short.inner.point().force_value() == gen.mul(magnitude * sign % q)
                assert mul_elem.inner.point().force_value() == gen.mul(self.elem % q)

    return ApiCircuit


def _api_inputs(pallas):
    rng = random.Random(31)
    p = pallas.generator().mul(rng.randrange(2, 1 << 64))
    return p, rng.randrange(1, Q), (rng.randrange(1, 1 << 64), -1), rng.randrange(P)


def test_ecc_api_drives_every_wrapper_like_jax():
    from halo2_tpu.frontend import Circuit as JCircuit
    from halo2_tpu_torch.frontend import Circuit

    port = _api_circuit((Circuit, Value, ConstraintSystem, api, util, Pallas,
                         (circuits.fixed_base(ef.NUM_WINDOWS), circuits.fixed_base(ef.NUM_WINDOWS_SHORT))))
    jax = _api_circuit((JCircuit, JValue, JConstraintSystem, japi, jutil, JPallas,
                        (jfixed._FULL, jfixed._SHORT)))
    assert port_cs(port) == jax_cs(jax)
    record = port_record(11, port(*_api_inputs(Pallas)))
    assert record["failures"] == []
    assert record == jax_record(11, jax(*_api_inputs(JPallas)))


if __name__ == "__main__":
    pin_cases(PINNED, FIXTURE)
    print("wrote", FIXTURE)
