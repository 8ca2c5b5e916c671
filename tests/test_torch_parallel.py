"""The port's device mesh on the CPU, held to the JAX package.

Meshes of logical shards, `["cpu"] * 8` (as the JAX package's tests use
eight virtual host devices) and `["cpu"] * 2`: the sharded four-step NTT
equals the JAX package's NttPlan and the port's one-device plan; the
sharded MSM equals `msm_host`; ShardedQuotient round-trips, and its
rotation, its division by t(X) and `compile_gate_program` equal their
unsharded counterparts; `evaluate_h_mesh` equals `evaluate_h_parts`.

The mesh proof is tests/test_mesh_prover.py's: BenchCircuit(12,
table_bits=4, seed=3) at K = 5, ChaCha20Rng(b"\\x2a" * 32), Vesta, Blake2b.
Under a mesh its bytes must equal the port's single-device bytes and the
JAX package's single-chip bytes, whose sha256 is pinned below (with the
JAX package's NttPlan output that the four-step NTT is held to) from

    PYTHONPATH=. JAX_PLATFORMS=cpu XLA_FLAGS=--xla_cpu_parallel_codegen_split_count=1 \\
        python tests/test_torch_parallel.py

(a `slow` twin recomputes it); the counters show that each of the three
dispatch points (`get_plan`, `msm`, `evaluate_h`) took the mesh.
"""

import hashlib
import os
import random
import sys

import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
sys.path[:0] = [p for p in (ROOT, TESTS) if p not in sys.path]

from halo2_tpu_torch import parallel  # noqa: E402
from halo2_tpu_torch.circuits import BenchCircuit  # noqa: E402
from halo2_tpu_torch.curves import Vesta  # noqa: E402
from halo2_tpu_torch.fields import Fq  # noqa: E402
from halo2_tpu_torch.ops import msm as msm_mod  # noqa: E402
from halo2_tpu_torch.ops.field import FieldCtx  # noqa: E402
from halo2_tpu_torch.ops.msm import MSMBases, msm_host  # noqa: E402
from halo2_tpu_torch.ops.ntt import NttPlan, get_plan, single_plan  # noqa: E402
from halo2_tpu_torch.ops.ntt_cg import CgNttPlan  # noqa: E402
from halo2_tpu_torch.ops.ntt_mr import MrNttPlan  # noqa: E402
from halo2_tpu_torch.parallel import (FourStepNtt, MeshContext, ShardedQuotient, make_mesh,  # noqa: E402
                                      sharded_msm, use_mesh)
from halo2_tpu_torch.parallel.context import CALLS, active_mesh  # noqa: E402
from halo2_tpu_torch.parallel.ntt import gather_rows  # noqa: E402
from halo2_tpu_torch.parallel.quotient import compile_gate_program  # noqa: E402
from halo2_tpu_torch.plonk import evaluation  # noqa: E402
from halo2_tpu_torch.plonk.keygen import keygen_pk, keygen_vk  # noqa: E402
from halo2_tpu_torch.plonk.prover import create_proof  # noqa: E402
from halo2_tpu_torch.plonk.verifier import verify_proof  # noqa: E402
from halo2_tpu_torch.poly import FVec, Polynomial, EXTENDED  # noqa: E402
from halo2_tpu_torch.poly.domain import EvaluationDomain  # noqa: E402
from halo2_tpu_torch.poly.ipa import ParamsIPA  # noqa: E402
from halo2_tpu_torch.transcript import Blake2bRead, Blake2bWrite  # noqa: E402
from halo2_tpu_torch.utils.chacha import ChaCha20Rng  # noqa: E402

# The command above prints both pins: the JAX package's NttPlan at k = 8 on
# this file's inputs (the sha256 of its output as ints) and its single-chip
# proof of the mesh circuit.
JAX_NTT_K8_SHA256 = "7e8353809052d82bdaab836869aeceb84233f6f665a67bdb8596368b6e7f37a7"
JAX_MESH_CIRCUIT_PROOF_SHA256 = "032900c932df82e43115577cd3c80450ab24a6f04f80301773726786316a1a90"

P = Fq.MODULUS
CTX = FieldCtx(Fq)
MESHES = {"cpu8": ["cpu"] * 8, "cpu2": ["cpu"] * 2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rand(n, seed):
    rng = random.Random(seed)
    return [rng.randrange(P) for _ in range(n)]


def _omega(k):
    return pow(Fq.ROOT_OF_UNITY, 1 << (Fq.S - k), P)


# ---------------- the mesh and its context ----------------


def test_exports_match_jax():
    import halo2_tpu.parallel as jparallel

    assert parallel.__all__ == jparallel.__all__


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_thresholds_match_jax(D):
    import jax
    from jax.sharding import Mesh as JMesh

    from halo2_tpu.parallel.context import MeshContext as JMeshContext

    mc = MeshContext(make_mesh(devices=["cpu"] * D), msm_min=64)
    jmc = JMeshContext(JMesh(jax.devices()[:D], ("x",)), msm_min=64)
    assert (mc.D, mc.log_d) == (jmc.D, jmc.log_d)
    assert [mc.can_shard_ntt(k) for k in range(12)] == [jmc.can_shard_ntt(k) for k in range(12)]
    assert [mc.can_shard_msm(n) for n in range(0, 200, 7)] == [
        jmc.can_shard_msm(n) for n in range(0, 200, 7)]


def test_mesh_size_must_be_a_power_of_two():
    with pytest.raises(ValueError):
        MeshContext(make_mesh(devices=["cpu"] * 3))


def test_make_mesh_raises_on_too_few_devices():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError):
        make_mesh(have + 1)
    if have == 0:
        with pytest.raises(RuntimeError):
            make_mesh()
    with pytest.raises(ValueError):
        make_mesh(3, devices=["cpu"] * 2)
    mesh = make_mesh(devices=["cpu"] * 4, axis="y")
    assert mesh.shape == {"y": 4} and mesh.devices == (torch.device("cpu"),) * 4


def test_use_mesh_nests_and_restores():
    assert active_mesh() is None
    with use_mesh(make_mesh(devices=["cpu"] * 2)) as outer:
        with use_mesh(make_mesh(devices=["cpu"] * 4)) as inner:
            assert active_mesh() is inner and inner.D == 4
        assert active_mesh() is outer
    assert active_mesh() is None


# ---------------- the four-step NTT ----------------


def _ints_sha256(vals) -> str:
    return hashlib.sha256(repr(list(vals)).encode()).hexdigest()


def _jax_ntt_k8_sha256() -> str:
    """The JAX package's NttPlan at k = 8 on _rand(2^8, 101): the sha256 of
    its output as ints."""
    from halo2_tpu.fields import Fq as JFq
    from halo2_tpu.ops.field_jax import FieldCtx as JFieldCtx
    from halo2_tpu.ops.ntt import NttPlan as JNttPlan

    jctx = JFieldCtx(JFq)
    out = JNttPlan(JFq, 8, _omega(8))(jctx.encode_ints(_rand(1 << 8, 101)))
    return _ints_sha256(jctx.decode_ints(out))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_ntt_matches_jax_and_single_plan(mesh_name, inverse):
    k = 8
    omega = _omega(k)
    if inverse:
        omega = pow(omega, -1, P)
    a = CTX.encode_ints(_rand(1 << k, 101), "cpu")
    mesh = make_mesh(devices=MESHES[mesh_name])
    out = CTX.decode_ints(FourStepNtt(Fq, k, omega, mesh)(a))
    assert out == CTX.decode_ints(single_plan(Fq, k, omega)(a))
    assert out == CTX.decode_ints(NttPlan(Fq, k, omega)(a))
    if not inverse:
        assert _ints_sha256(out) == JAX_NTT_K8_SHA256


@pytest.mark.slow  # an XLA compile of the JAX package's NttPlan on the CPU
def test_pinned_jax_ntt_recomputed():
    assert _jax_ntt_k8_sha256() == JAX_NTT_K8_SHA256


def test_get_plan_takes_the_four_step_ntt_under_a_mesh(monkeypatch):
    monkeypatch.delenv("NTT", raising=False)
    with use_mesh(make_mesh(devices=["cpu"] * 8)):
        assert isinstance(get_plan(Fq, 6, _omega(6)), FourStepNtt)
        assert isinstance(get_plan(Fq, 5, _omega(5)), CgNttPlan)  # n < D^2
        monkeypatch.setenv("NTT", "bogus")  # the mesh is taken before the switch is read
        assert isinstance(get_plan(Fq, 6, _omega(6)), FourStepNtt)
    with pytest.raises(ValueError):
        get_plan(Fq, 6, _omega(6))


@pytest.mark.parametrize("plan_cls", [CgNttPlan, MrNttPlan])
@pytest.mark.parametrize("k", [3, 9])
def test_batched_transform_equals_each_row(plan_cls, k):
    plan = plan_cls(Fq, k, _omega(k))
    rows = torch.stack([CTX.encode_ints(_rand(1 << k, 7 + i), "cpu") for i in range(3)])
    many = plan.many(rows)
    for i in range(3):
        assert torch.equal(many[i], plan(rows[i]))


# ---------------- the sharded MSM ----------------


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_msm_matches_msm_host(mesh_name):
    rng = random.Random(102)
    n = 256
    q = Vesta.SCALAR.MODULUS
    pts = [Vesta.generator().mul(rng.randrange(1, 1000)) for _ in range(n)]
    scalars = [rng.randrange(q) for _ in range(n)]
    scalars[:3] = [0, 1, q - 1]
    mesh = make_mesh(devices=MESHES[mesh_name])
    bases = MSMBases(Vesta, pts, "cpu")
    assert sharded_msm(scalars, bases, mesh, lanes=8) == msm_host(scalars, pts, Vesta)
    if mesh_name == "cpu2":  # fewer scalars than bases, and a count the mesh does not divide
        assert sharded_msm(scalars[:101], bases, mesh) == msm_host(scalars[:101], pts[:101], Vesta)


def test_msm_takes_the_mesh_from_its_threshold(monkeypatch):
    monkeypatch.delenv("MSM", raising=False)
    rng = random.Random(104)
    pts = [Vesta.generator().mul(rng.randrange(1, 1000)) for _ in range(40)]
    scalars = [rng.randrange(Vesta.SCALAR.MODULUS) for _ in range(40)]
    msm_mod.ROUTES.clear()
    with use_mesh(make_mesh(devices=["cpu"] * 2), msm_min=32):
        assert msm_mod.msm(scalars, pts, device="cpu", site="t") == msm_host(scalars, pts, Vesta)
        assert msm_mod.msm(scalars[:31], pts, device="cpu", site="t") == msm_host(
            scalars[:31], pts[:31], Vesta)
        monkeypatch.setenv("MSM", "host")
        msm_mod.msm(scalars, pts, device="cpu", site="t")
    assert dict(msm_mod.ROUTES) == {("t", "sharded"): 1}
    msm_mod.ROUTES.clear()


# ---------------- the sharded quotient ----------------


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_quotient_roundtrip(mesh_name):
    k = 5
    sq = ShardedQuotient(Fq, 3, k, make_mesh(devices=MESHES[mesh_name]))
    n = 1 << k
    vals = _rand(n, 103)
    ext = sq.extend(CTX.encode_ints(vals, "cpu"))
    assert len(ext) == sq.D
    out = CTX.decode_ints(sq.to_coeff(ext))
    assert out[:n] == vals
    assert all(v == 0 for v in out[n:])


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_steps_equal_the_domains(mesh_name):
    """extend, rotate and divide_vanishing against EvaluationDomain's
    coeff_to_extended, rotate_extended and divide_by_vanishing_poly."""
    from halo2_tpu_torch.poly import COEFF, Rotation

    k = 5
    sq = ShardedQuotient(Fq, 3, k, make_mesh(devices=MESHES[mesh_name]))
    domain = EvaluationDomain(Fq, 3, k, "cpu")
    coeffs = CTX.encode_ints(_rand(1 << k, 105), "cpu")
    full = domain.coeff_to_extended(Polynomial(COEFF, FVec(Fq, coeffs)))
    ext = sq.extend(coeffs)
    assert CTX.decode_ints(gather_rows(ext, "cpu")) == CTX.decode_ints(full.vec.vals)
    for rot in (0, 1, -1, 3, -5, (1 << k) - 1):
        want = domain.rotate_extended(full, Rotation(rot)).vec.vals
        assert CTX.decode_ints(gather_rows(sq.rotate(ext, rot), "cpu")) == CTX.decode_ints(want)
    want = domain.divide_by_vanishing_poly(full).vec.vals
    assert CTX.decode_ints(gather_rows(sq.divide_vanishing(ext), "cpu")) == CTX.decode_ints(want)


def test_gate_program_equals_the_unsharded_fold():
    """BenchCircuit's gate and lookup expressions, folded with y over random
    extended columns: the sharded program against the same fold on whole
    columns (FVec ops, torch.roll rotations)."""
    from halo2_tpu_torch.plonk import ConstraintSystem

    cs = ConstraintSystem()
    BenchCircuit.configure(cs)
    exprs = [p for g in cs.gates for p in g.polys]
    exprs += [e for lk in cs.lookups for e in lk.input_expressions + lk.table_expressions]
    k = 5
    sq = ShardedQuotient(Fq, 3, k, make_mesh(devices=["cpu"] * 8))
    ext_n, step = sq.extended_n, sq.extended_n >> k
    cols = [[CTX.encode_ints(_rand(ext_n, 200 + 10 * kind + i), "cpu") for i in range(n)]
            for kind, n in enumerate((cs.num_fixed_columns, cs.num_advice_columns,
                                      cs.num_instance_columns))]
    y = 0x1234567
    fn = compile_gate_program(exprs, sq, *(len(c) for c in cols))
    got = fn(*[[list(c.chunk(sq.D)) for c in kind] for kind in cols], [], y)

    def whole(expr):
        def col(kind):
            return lambda q: FVec(Fq, cols[kind][q.column_index]).rotate(step * q.rotation.i)

        return expr.evaluate(
            constant=lambda c: FVec.fill(Fq, ext_n, c, "cpu"), selector=None,
            fixed=col(0), advice=col(1), instance=col(2), challenge=None,
            negated=lambda a: -a, sum_=lambda a, b: a + b, product=lambda a, b: a * b,
            scaled=lambda a, f: a * Fq(f))

    want = None
    for e in exprs:
        v = whole(e)
        want = v if want is None else want * Fq(y) + v
    assert CTX.decode_ints(gather_rows(got, "cpu")) == CTX.decode_ints(want.vals)


# ---------------- the mesh proof ----------------


@pytest.fixture(scope="module")
def mesh_circuit():
    """Keys of the mesh circuit, its single-device proof, and the arguments
    the prover gave evaluate_h."""
    params = ParamsIPA.cached(Vesta, 5, device="cpu")
    circuit = BenchCircuit(12, table_bits=4, seed=3)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, vk, circuit)
    assert vk.domain.extended_k >= 6, "the mesh must engage: extended_k >= 2 log2(8)"
    seen = []
    inner = evaluation.Evaluator.evaluate_h

    def recording(self, *args):
        seen.append((self, args))
        return inner(self, *args)

    evaluation.Evaluator.evaluate_h = recording
    try:
        proof = _prove(params, pk, circuit)
    finally:
        evaluation.Evaluator.evaluate_h = inner
    return params, vk, pk, circuit, proof, seen[0]


def _prove(params, pk, circuit):
    tr = Blake2bWrite(Vesta)
    create_proof(params, pk, [circuit], [[]], ChaCha20Rng(b"\x2a" * 32), tr)
    return tr.finalize()


def test_single_device_proof_has_the_jax_bytes(mesh_circuit):
    params, vk, _, _, proof, _ = mesh_circuit
    assert hashlib.sha256(proof).hexdigest() == JAX_MESH_CIRCUIT_PROOF_SHA256
    assert verify_proof(params, vk, [[]], Blake2bRead(Vesta, proof)) is True


@pytest.mark.parametrize("mesh_name", [None, "cpu8", "cpu2"])
def test_evaluate_h_mesh_equals_parts(mesh_circuit, mesh_name):
    evaluator, args = mesh_circuit[5]
    want = evaluator.evaluate_h_parts(*args)
    if mesh_name is None:  # EVAL_H=mesh alone: one shard
        got = evaluator.evaluate_h_mesh(*args)
    else:
        with use_mesh(make_mesh(devices=MESHES[mesh_name])):
            got = evaluator.evaluate_h_mesh(*args)
    assert got.basis == EXTENDED
    ctx = FieldCtx(evaluator.field)
    assert ctx.decode_ints(got.vec.vals) == ctx.decode_ints(want.vec.vals)


def test_eval_h_switch(mesh_circuit, monkeypatch):
    evaluator, args = mesh_circuit[5]
    calls = []
    monkeypatch.setattr(evaluator, "evaluate_h_mesh", lambda *a: calls.append("mesh"))
    monkeypatch.setattr(evaluator, "evaluate_h_parts", lambda *a: calls.append("parts"))
    monkeypatch.delenv("EVAL_H", raising=False)
    evaluator.evaluate_h(*args)
    with use_mesh(make_mesh(devices=["cpu"] * 8)):
        evaluator.evaluate_h(*args)
        monkeypatch.setenv("EVAL_H", "parts")
        evaluator.evaluate_h(*args)
    monkeypatch.setenv("EVAL_H", "mesh")
    evaluator.evaluate_h(*args)
    assert calls == ["parts", "mesh", "parts", "mesh"]
    monkeypatch.setenv("EVAL_H", "bogus")
    with pytest.raises(ValueError):
        evaluator.evaluate_h(*args)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_mesh_proof_has_the_single_device_bytes(mesh_circuit, mesh_name, monkeypatch):
    """Under the mesh every dispatch point takes it: with 8 shards the NTTs
    and the quotient fold (no MSM here reaches 8 D = 64 points, as in the
    JAX package), with 2 shards also every msm() of 32 points or more."""
    for name in ("NTT", "MSM", "EVAL_H"):
        monkeypatch.delenv(name, raising=False)
    params, vk, pk, circuit, single, _ = mesh_circuit
    CALLS.clear()
    msm_mod.ROUTES.clear()
    with use_mesh(make_mesh(devices=MESHES[mesh_name]), msm_min=32):
        proof = _prove(params, pk, circuit)
    assert proof == single
    assert verify_proof(params, vk, [[]], Blake2bRead(Vesta, proof)) is True
    assert CALLS["four_step_ntt"] > 0 and CALLS["evaluate_h_mesh"] == 1
    sharded = sum(c for (_, route), c in msm_mod.ROUTES.items() if route == "sharded")
    if mesh_name == "cpu2":
        assert CALLS["sharded_msm"] == sharded > 0
    else:
        assert CALLS["sharded_msm"] == sharded == 0
    msm_mod.ROUTES.clear()


# ---------------- the pin ----------------


def _jax_mesh_circuit_sha256() -> str:
    """The JAX package's single-chip proof of the mesh circuit; its sha256."""
    import jax

    sys.path[:0] = [os.path.join(ROOT, "examples")]
    jax.config.update("jax_platforms", "cpu")
    from plonk_bench import BenchCircuit as JBenchCircuit

    from halo2_tpu.curves import Vesta as JVesta
    from halo2_tpu.plonk.keygen import keygen_pk as jkeygen_pk, keygen_vk as jkeygen_vk
    from halo2_tpu.plonk.prover import create_proof as jcreate_proof
    from halo2_tpu.poly.ipa import ParamsIPA as JParamsIPA
    from halo2_tpu.transcript import Blake2bWrite as JBlake2bWrite
    from halo2_tpu.utils.chacha import ChaCha20Rng as JChaCha20Rng

    params = JParamsIPA.cached(JVesta, 5)
    circuit = JBenchCircuit(12, table_bits=4, seed=3)
    vk = jkeygen_vk(params, circuit)
    pk = jkeygen_pk(params, vk, circuit)
    t = JBlake2bWrite(JVesta)
    jcreate_proof(params, pk, [circuit], [[]], JChaCha20Rng(b"\x2a" * 32), t)
    return hashlib.sha256(t.finalize()).hexdigest()


@pytest.mark.slow  # XLA compiles the JAX package's prover on the CPU
def test_pinned_jax_bytes_recomputed():
    assert _jax_mesh_circuit_sha256() == JAX_MESH_CIRCUIT_PROOF_SHA256


if __name__ == "__main__":
    print(f"JAX_NTT_K8_SHA256 = {_jax_ntt_k8_sha256()!r}")
    print(f"JAX_MESH_CIRCUIT_PROOF_SHA256 = {_jax_mesh_circuit_sha256()!r}")
