"""The port's EVAL_H and MSM switches, its BatchVerifier and its per-proof
totals, on the CPU, held to the JAX package's bytes.

- EVAL_H=full (the plain extended-domain fold) gives MulCircuit k = 4 the
  golden proof bytes (tests/fixtures_golden.json, the JAX package's), and
  the same bytes as the part-wise walk on MixedDegreeCircuit at k = 5, whose
  constraints span the clusters; unknown values raise (EVAL_H=mesh takes the
  row-sharded fold: tests/test_torch_parallel.py).
- MSM=host, pallas, sorted and jax each give the golden bytes with every MSM
  of 16 points or more sent down their route; an unknown value raises.
- BatchVerifier accepts the golden proof beside a second MulCircuit proof
  and returns False when one byte of the second is flipped.
- A proof under MEASURE=1 prints its spans nested and its per-proof FFT and
  MSM totals.
"""

import contextlib
import hashlib
import io
import json
import os

import pytest
import torch

from halo2_tpu_torch.circuits import MixedDegreeCircuit, MulCircuit
from halo2_tpu_torch.curves import Vesta
from halo2_tpu_torch.ops import msm as msm_mod, msm_bucket
from halo2_tpu_torch.plonk.batch import BatchVerifier
from halo2_tpu_torch.plonk.evaluation import Evaluator
from halo2_tpu_torch.plonk.keygen import keygen_pk, keygen_vk
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.plonk.verifier import verify_proof
from halo2_tpu_torch.poly.commitment import Blind
from halo2_tpu_torch.poly.ipa import ParamsIPA
from halo2_tpu_torch.poly.kzg import ParamsKZG
from halo2_tpu_torch.transcript import Blake2bRead, Blake2bWrite
from halo2_tpu_torch.utils import measure
from halo2_tpu_torch.utils.chacha import ChaCha20Rng


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """A proof on the CPU is thousands of small torch ops; one thread each
    spares them the intra-op barriers that stall when the suite's workers
    share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


GOLDEN = json.load(open(os.path.join(os.path.dirname(__file__), "fixtures_golden.json")))
C = 7 * 4 * 9


@pytest.fixture(scope="module")
def mul_k4():
    params = ParamsIPA.cached(Vesta, 4, device="cpu")
    vk = keygen_vk(params, MulCircuit(7))
    return params, vk, keygen_pk(params, vk, MulCircuit(7))


def _prove(params, pk, circuit, instances, seed=b"\x2a" * 32):
    t = Blake2bWrite(Vesta)
    create_proof(params, pk, [circuit], [instances], ChaCha20Rng(seed), t)
    return t.finalize()


@pytest.fixture(scope="module")
def golden_run(mul_k4):
    """The golden proof made under MEASURE=1: its bytes, what it printed and
    the per-proof totals it left."""
    params, _, pk = mul_k4
    out = io.StringIO()
    saved = os.environ.get("MEASURE")
    os.environ["MEASURE"] = "1"
    try:
        with contextlib.redirect_stdout(out):
            proof = _prove(params, pk, MulCircuit(7, 2, 3), [[C]])
    finally:
        if saved is None:
            os.environ.pop("MEASURE")
        else:
            os.environ["MEASURE"] = saved
    return proof, out.getvalue(), measure.get_totals()


def test_eval_h_full_gives_the_golden_bytes(mul_k4, monkeypatch):
    params, vk, pk = mul_k4
    monkeypatch.setenv("EVAL_H", "full")
    proof = _prove(params, pk, MulCircuit(7, 2, 3), [[C]])
    assert hashlib.sha256(proof).hexdigest() == GOLDEN["proof_sha256"]


def test_eval_h_full_equals_parts_on_mixed_degree_clusters(monkeypatch):
    params = ParamsIPA.cached(Vesta, 5, device="cpu")
    vk = keygen_vk(params, MixedDegreeCircuit())
    pk = keygen_pk(params, vk, MixedDegreeCircuit())
    assert vk.domain.extended_k - vk.domain.k >= 2  # a real cluster split
    proofs = {}
    for mode in ("full", "parts"):
        monkeypatch.setenv("EVAL_H", mode)
        proofs[mode] = _prove(params, pk, MixedDegreeCircuit([3, 5, 7]), [], b"\x2b" * 32)
    assert proofs["full"] == proofs["parts"]
    assert verify_proof(params, vk, [[]], Blake2bRead(Vesta, proofs["parts"])) is True


@pytest.mark.parametrize("mode,error", [("", ValueError), ("fold", ValueError)])
def test_eval_h_other_values_raise(mul_k4, monkeypatch, mode, error):
    """The switch is read before any argument is looked at."""
    monkeypatch.setenv("EVAL_H", mode)
    with pytest.raises(error, match="EVAL_H"):
        Evaluator(mul_k4[2]).evaluate_h([], [], [], 0, 0, 0, 0, [], [])


@pytest.mark.parametrize("route", ["host", "pallas", "sorted", "jax"])
def test_msm_route_gives_the_golden_bytes(mul_k4, monkeypatch, route):
    """The prover's single commits (17 points) take the route MSM names
    once the device threshold is below them."""
    params, _, pk = mul_k4
    monkeypatch.setenv("MSM", route)
    monkeypatch.setattr(msm_mod, "DEVICE_MSM_MIN", 16)
    monkeypatch.setattr(msm_mod, "ROUTES", msm_mod.Counter())
    taken = []
    host, window_sums = msm_mod.msm_host, msm_bucket.window_sums
    monkeypatch.setattr(msm_mod, "msm_host", lambda *a: taken.append("host") or host(*a))
    monkeypatch.setattr(msm_bucket, "window_sums",
                        lambda *a: taken.append("plain" if a[3] else "bucket") or window_sums(*a))
    proof = _prove(params, pk, MulCircuit(7, 2, 3), [[C]])
    assert hashlib.sha256(proof).hexdigest() == GOLDEN["proof_sha256"]
    routes = {r for (_, r) in msm_mod.ROUTES}
    assert ("host" in taken) == (route == "host")
    assert ("plain" in taken) == (route == "jax")
    assert routes == ({"sorted"} if route == "sorted" else set())


def test_msm_unknown_route_raises(mul_k4, monkeypatch):
    params, _, _ = mul_k4
    monkeypatch.setenv("MSM", "gpu")
    with pytest.raises(ValueError, match="MSM='gpu'"):
        params.commit([1] * params.n, Blind())


def test_batch_verifier(mul_k4, golden_run):
    params, vk, pk = mul_k4
    golden = golden_run[0]
    c2 = 7 * 16 * 25
    second = _prove(params, pk, MulCircuit(7, 4, 5), [[c2]], b"\x02" * 32)
    batch = BatchVerifier()
    batch.add_proof([[[C]]], golden)
    batch.add_proof([[[c2]]], second)
    assert batch.finalize(params, vk, ChaCha20Rng(b"\x55" * 32)) is True
    flipped = bytearray(second)
    flipped[len(flipped) // 2] ^= 0xFF
    bad = BatchVerifier()
    bad.add_proof([[[C]]], golden)
    bad.add_proof([[[c2]]], bytes(flipped))
    assert bad.finalize(params, vk, ChaCha20Rng(b"\x56" * 32)) is False
    wrong = BatchVerifier()
    wrong.add_proof([[[C + 1]]], golden)
    assert wrong.finalize(params, vk, ChaCha20Rng(b"\x57" * 32)) is False


def test_batch_verifier_is_ipa_only(mul_k4):
    _, vk, _ = mul_k4
    with pytest.raises(AssertionError, match="IPA-only"):
        BatchVerifier().finalize(ParamsKZG.__new__(ParamsKZG), vk, ChaCha20Rng(b"\x58" * 32))


def test_proof_fills_the_per_proof_totals(golden_run):
    """create_proof resets the totals and, under MEASURE=1, reports them."""
    proof, out, totals = golden_run
    assert hashlib.sha256(proof).hexdigest() == GOLDEN["proof_sha256"]
    assert totals["fft"] > 0 and totals["msm"] > 0
    lines = out.splitlines()
    assert lines[0] == "instances ..." and "  ntt 2^4 ..." in lines
    assert "  msm n=17 ..." in lines and lines[-1].startswith("FFT total: ")
