"""The port's dev tools on the CPU, held to the JAX package.

The same circuits (MulCircuit and its cheating variants, the utilities and
dev-tool circuits) go through both packages' MockProver, CircuitCost,
CircuitGates, circuit_dot_graph and CircuitLayout; the failure lists must
be equal, kind and rendered text alike, and so must every cost field, the
gate census, the DOT text and the layout image. The port's vectorised check
(limb tensors on the CPU here) must report what its row loop reports.
"""

import os

import pytest
from circuits import MulCircuit as JMulCircuit

from halo2_tpu.dev.cost import CircuitCost as JCircuitCost
from halo2_tpu.dev.gates import CircuitGates as JCircuitGates
from halo2_tpu.dev.graph import CircuitLayout as JCircuitLayout, circuit_dot_graph as jdot
from halo2_tpu.dev.mock_prover import MockProver as JMockProver
from halo2_tpu.fields import Fp as JFp
from halo2_tpu.plonk.error import NotEnoughRowsAvailable as JNotEnoughRows
from halo2_tpu_torch.circuits import MulCircuit
from halo2_tpu_torch.dev.cost import CircuitCost
from halo2_tpu_torch.dev.gates import CircuitGates
from halo2_tpu_torch.dev.graph import CircuitLayout, circuit_dot_graph
from halo2_tpu_torch.dev.mock_prover import MockProver
from halo2_tpu_torch.fields import Fp
from halo2_tpu_torch.plonk.error import NotEnoughRowsAvailable
from halo2_tpu_torch.utils import measure


P = Fp.MODULUS
C = 7 * 4 * 9  # c = constant * a^2 * b^2 for (7, 2, 3)


def _cheat(base, annotate=False):
    """MulCircuit whose last product cell holds 999999 (breaks the gate)."""

    class Cheat(base):
        def synthesize(self, config, layouter):
            a = layouter.assign_region(
                "a", lambda r: r.assign_advice(config.advice0, 0, self.a, "a"))
            b = layouter.assign_region(
                "b", lambda r: r.assign_advice(config.advice1, 0, self.b, "b"))

            def bad_mul(region):
                if annotate:
                    region.name_column(config.advice0, "lhs-operand")
                config.s_mul.enable(region, 0)
                a.copy_advice(region, config.advice0, 0)
                b.copy_advice(region, config.advice1, 0)
                return region.assign_advice(config.advice0, 1, 999999, "wrong")

            out = layouter.assign_region("bad mul", bad_mul)
            layouter.constrain_instance(out.cell(), config.instance, 0)

    return Cheat


def _hole(base):
    """MulCircuit whose gate region leaves its output cell unassigned."""

    class Hole(base):
        def synthesize(self, config, layouter):
            def region_fn(region):
                config.s_mul.enable(region, 0)
                region.assign_advice(config.advice0, 0, self.a, "a")
                region.assign_advice(config.advice1, 0, self.b, "b")

            layouter.assign_region("hole", region_fn)

    return Hole


CASES = {
    "satisfied": (lambda base: base(7, 2, 3), [[C]]),
    "bad_instance": (lambda base: base(7, 2, 3), [[C + 1]]),
    "bad_witness": (lambda base: _cheat(base)(7, 2, 3), [[999999]]),
    "annotated_bad_witness": (lambda base: _cheat(base, True)(7, 2, 3), [[999999]]),
    "unassigned_cell": (lambda base: _hole(base)(7, 2, 3), [[]]),
}


def _render(failures):
    return [(f.kind, str(f)) for f in failures]


@pytest.mark.parametrize("case", sorted(CASES))
def test_mock_prover_failures_match_jax(case):
    make, instances = CASES[case]
    want = _render(JMockProver.run(4, make(JMulCircuit), instances, field_cls=JFp).verify())
    prover = MockProver.run(4, make(MulCircuit), instances, field_cls=Fp, device="cpu")
    got = _render(prover.verify())
    assert got == want
    assert (case == "satisfied") == (got == [])
    # the vectorised check on limb tensors reports what the row loop reports
    assert _render(prover.verify(vectorized=True)) == got


def test_failure_rendering_carries_the_reference_fields():
    prover = MockProver.run(4, _cheat(MulCircuit, True)(7, 2, 3), [[999999]], device="cpu")
    text = str(next(f for f in prover.verify() if f.kind == "constraint"))
    assert "in Gate" in text and "is not satisfied" in text
    assert "in Region" in text and "'bad mul'" in text and "at offset" in text
    assert "<--" in text and "lhs-operand" in text
    hole = MockProver.run(4, _hole(MulCircuit)(7, 2, 3), [[]], device="cpu")
    text = str(next(f for f in hole.verify() if f.kind == "cell_not_assigned"))
    assert "uses Gate" in text and "does not assign Column" in text


def test_vectorized_matches_jax_vectorized():
    """Both packages' vectorised checks on the planted failure."""
    make, instances = CASES["annotated_bad_witness"]
    want = _render(JMockProver.run(4, make(JMulCircuit), instances).verify(vectorized=True))
    got = _render(MockProver.run(4, make(MulCircuit), instances, device="cpu")
                  .verify(vectorized=True))
    assert got == want and any(kind == "constraint" for kind, _ in got)


def test_mock_prover_too_small_k():
    with pytest.raises(JNotEnoughRows):
        JMockProver.run(2, JMulCircuit(7, 2, 3), [[0]], field_cls=JFp)
    with pytest.raises(NotEnoughRowsAvailable):
        MockProver.run(2, MulCircuit(7, 2, 3), [[0]], field_cls=Fp, device="cpu")


def test_circuit_cost_matches_jax():
    want = JCircuitCost.measure(4, JMulCircuit(7))
    got = CircuitCost.measure(4, MulCircuit(7))
    assert vars(got) == vars(want)
    assert got.advice_columns == 2 and got.permutation_cols == 4
    for instances in (1, 2):
        assert got.proof_size(instances) == want.proof_size(instances)
    assert got.marginal_proof_size() == want.marginal_proof_size() > 0


def test_circuit_gates_match_jax():
    want = JCircuitGates.collect(JMulCircuit)
    got = CircuitGates.collect(MulCircuit)
    assert str(got) == str(want)
    assert "mul:" in str(got) and got.total_multiplications == 2


def test_circuit_dot_graph_matches_jax():
    dot = circuit_dot_graph(MulCircuit(7))
    assert dot == jdot(JMulCircuit(7))
    assert dot.startswith("digraph Circuit {") and dot.rstrip().endswith("}")


def test_circuit_layout_matches_jax(tmp_path):
    ours, theirs = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    CircuitLayout().render(4, MulCircuit(7), ours)
    JCircuitLayout().render(4, JMulCircuit(7), theirs)
    assert os.path.getsize(ours) > 1000
    assert open(ours, "rb").read() == open(theirs, "rb").read()


def test_measure_spans_and_totals(capsys, monkeypatch):
    monkeypatch.setenv("MEASURE", "1")
    measure.reset_totals()
    with measure.span("outer"):
        with measure.span("inner fft", category="fft"):
            pass
        with measure.span("inner msm", category="msm"):
            pass
    measure.report_totals()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "outer ..." and lines[1] == "  inner fft ..."
    assert lines[2].startswith("  inner fft: ") and lines[-2].startswith("outer: ")
    assert lines[-1].startswith("FFT total: ") and "MSM total: " in lines[-1]
    totals = measure.get_totals()
    assert set(totals) == {"fft", "msm"} and min(totals.values()) >= 0
    monkeypatch.setenv("MEASURE", "0")
    with measure.span("quiet", category="fft"):
        pass
    assert capsys.readouterr().out == ""
