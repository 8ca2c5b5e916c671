"""The port's KZG backend over BN254 on the CPU, held to the JAX package.

The pairing, the params bytes, the commitments, SHPLONK's intermediate sets
and MulCircuit k = 4 proofs (GWC and SHPLONK, Blake2b and Keccak256) of the
port equal the JAX package's. The proof sha256 values are pinned: the JAX
package's KZG prover spends minutes compiling on the CPU, so tier-1 holds
the port to the pins and the `slow` tests recompute them live. They were
made once on the CPU with

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_kzg.py pins
    PYTHONPATH=. JAX_PLATFORMS=cpu XLA_FLAGS=--xla_cpu_parallel_codegen_split_count=1 \\
        python tests/test_torch_kzg.py bench10

which prove with the JAX package and print the sha256 values (the second
one, BenchCircuit over BN254's scalar field at k = 10, takes about an hour:
XLA compiles the prover's programs again after each stage).
"""

import hashlib
import os
import random
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MUL_K4_PARAMS_SEED = 42
MUL_K4_CONSTANT, MUL_K4_A, MUL_K4_B = 7, 2, 3
MUL_K4_INSTANCE = 7 * 4 * 9
VARIANTS = [(m, t) for m in ("gwc", "shplonk") for t in ("blake2b", "keccak256")]


def _jax_transcript(name):
    from halo2_tpu.transcript import Blake2bWrite, Keccak256Write

    return {"blake2b": Blake2bWrite, "keccak256": Keccak256Write}[name]


def _jax_mul_k4_sha256s():
    """{(multiopen, transcript): sha256} of the JAX package's MulCircuit k = 4
    KZG proofs on `ParamsKZG.setup(4, random.Random(42))`."""
    from circuits import MulCircuit as JMulCircuit

    from halo2_tpu.curves import Bn254G1 as JBn254G1
    from halo2_tpu.plonk.keygen import keygen_pk as jkeygen_pk, keygen_vk as jkeygen_vk
    from halo2_tpu.plonk.prover import create_proof as jcreate_proof
    from halo2_tpu.poly.kzg import ParamsKZG as JParamsKZG
    from halo2_tpu.utils.chacha import ChaCha20Rng as JChaCha20Rng

    params = JParamsKZG.setup(4, random.Random(MUL_K4_PARAMS_SEED))
    vk = jkeygen_vk(params, JMulCircuit(MUL_K4_CONSTANT))
    pk = jkeygen_pk(params, vk, JMulCircuit(MUL_K4_CONSTANT))
    out = {}
    for multiopen, tname in VARIANTS:
        t = _jax_transcript(tname)(JBn254G1)
        jcreate_proof(params, pk, [JMulCircuit(MUL_K4_CONSTANT, MUL_K4_A, MUL_K4_B)],
                      [[[MUL_K4_INSTANCE]]], JChaCha20Rng(b"\x2a" * 32), t,
                      multiopen=multiopen)
        out[multiopen, tname] = hashlib.sha256(t.finalize()).hexdigest()
    return out


def _jax_bench_circuit_frbn(k: int):
    """examples/plonk_bench.py's BenchCircuit with its witness chain reduced
    mod BN254's scalar field, so its gate holds over FrBn."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "examples")]
    from plonk_bench import BenchCircuit as JBenchCircuit

    from halo2_tpu.fields import FrBn as JFrBn
    from halo2_tpu.frontend import Value as JValue

    class FrBnBenchCircuit(JBenchCircuit):
        def without_witnesses(self):
            return FrBnBenchCircuit(self.rows, self.table_bits, None)

        def synthesize(self, config, layouter):
            P = JFrBn.MODULUS
            mask = (1 << self.table_bits) - 1
            rows = self.rows
            witness = self.seed is not None

            def main_region(region):
                acells, ccells = [], []
                av = (self.seed or 0) % P
                for i in range(rows):
                    bv = (av * 0x9E3779B9 + i) & mask
                    cv = (av * bv + av + bv) % P
                    known = (lambda v: JValue.known(v)) if witness else (lambda v: JValue.unknown())
                    acells.append(region.assign_advice(config.a, i, known(av), "a").cell())
                    region.assign_advice(config.b, i, known(bv), "b")
                    ccells.append(region.assign_advice(config.c, i, known(cv), "c").cell())
                    for col, name in ((config.sa, "sa"), (config.sb, "sb"),
                                      (config.sc, "sc"), (config.sm, "sm")):
                        region.assign_fixed(col, i, JValue.known(1), name)
                    av = cv
                for i in range(rows - 1):
                    region.constrain_equal(ccells[i], acells[i + 1])

            layouter.assign_region("main", main_region)

            def in_table(table):
                for v in range(1 << self.table_bits):
                    table.assign_cell(config.sl, v, v, "t")

            layouter.assign_table("table", in_table)

    return FrBnBenchCircuit((1 << k) - 64, table_bits=min(8, k - 1), seed=42)


def _jax_bench_k10_sha256() -> str:
    """Prove BenchCircuit over FrBn at k = 10 with the JAX package's KZG
    backend (SHPLONK, Blake2b, `ParamsKZG.cached(10)`); return the sha256."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from halo2_tpu.utils import measure

    # XLA:CPU runs out of mappable code memory once a few hundred programs
    # have been compiled in one process; drop them at the end of every stage
    base_span = measure.span

    class _ClearingSpan:
        def __init__(self, *args, **kwargs):
            self._inner = base_span(*args, **kwargs)

        def __enter__(self):
            return self._inner.__enter__()

        def __exit__(self, *exc):
            out = self._inner.__exit__(*exc)
            jax.clear_caches()
            return out

    measure.span = _ClearingSpan
    from halo2_tpu.curves import Bn254G1 as JBn254G1
    from halo2_tpu.plonk.keygen import keygen_pk as jkeygen_pk, keygen_vk as jkeygen_vk
    from halo2_tpu.plonk.prover import create_proof as jcreate_proof
    from halo2_tpu.poly.kzg import ParamsKZG as JParamsKZG
    from halo2_tpu.transcript import Blake2bWrite as JBlake2bWrite
    from halo2_tpu.utils.chacha import ChaCha20Rng as JChaCha20Rng

    params = JParamsKZG.cached(10)
    circuit = _jax_bench_circuit_frbn(10)
    vk = jkeygen_vk(params, circuit.without_witnesses())
    pk = jkeygen_pk(params, vk, circuit.without_witnesses())
    jax.clear_caches()
    t = JBlake2bWrite(JBn254G1)
    jcreate_proof(params, pk, [circuit], [[]], JChaCha20Rng(b"\x2a" * 32), t)
    return hashlib.sha256(t.finalize()).hexdigest()


# ---------------------------------------------------------------------------
# The port on the CPU
# ---------------------------------------------------------------------------

torch.set_num_threads(2)

# sha256 of the committed .params_cache/kzg-Bn254G1-k10.raw, written by the
# JAX package's `ParamsKZG.cached(10).write()` on the CPU
KZG_K10_PARAMS_SHA256 = "2c4e876bede9d1f2089d4f65b32d8802ac77f9159af4ae34909c85bee2870ada"
# the JAX package's MulCircuit k = 4 KZG proofs (`python tests/test_torch_kzg.py pins`)
MUL_K4_PROOF_SHA256 = {
    ("gwc", "blake2b"):
        "e1ee956cb27f887e9f77cf8fa1f50718e7379aaab277f6edfa5382548aa863e4",
    ("gwc", "keccak256"):
        "599217a9e9554a9576269c1f07e1d834c9d499d4239c12041327742b87a0ee7d",
    ("shplonk", "blake2b"):
        "8d2d3a0ac68424774fe3fafb5b69bc2d7f1c34f059219feaf9634e9aa958ef04",
    ("shplonk", "keccak256"):
        "ab4feeba7eb913ff10c7b01beabf913416c9c288ac09727f8094a07fcadc1d8a",
}
# the JAX package's BenchCircuit-over-FrBn k = 10 proof, SHPLONK and Blake2b
# on `ParamsKZG.cached(10)` (`python tests/test_torch_kzg.py bench10`);
# chip_smoke.py holds the port on the card to the same value
BENCH_KZG_K10_PROOF_SHA256 = "c4f216e517414c290a95e4bcedcce5e50788bd68f868b06aff0eadb6ecc377fa"


def _port():
    from halo2_tpu_torch import pairing
    from halo2_tpu_torch.circuits import MulCircuit, bench_circuit_for_k
    from halo2_tpu_torch.curves import Bn254G1
    from halo2_tpu_torch.fields import FrBn
    from halo2_tpu_torch.plonk.error import Error, OpeningError
    from halo2_tpu_torch.plonk.keygen import keygen_pk, keygen_vk
    from halo2_tpu_torch.plonk.prover import create_proof
    from halo2_tpu_torch.plonk.verifier import verify_proof
    from halo2_tpu_torch.poly import kzg
    from halo2_tpu_torch.transcript import (Blake2bRead, Blake2bWrite, Keccak256Read,
                                            Keccak256Write, TranscriptError)
    from halo2_tpu_torch.utils.chacha import ChaCha20Rng

    return SimpleNamespace(**locals())


T = _port()
REJECTED = (T.OpeningError, T.Error, T.TranscriptError, AssertionError)
TRANSCRIPTS = {"blake2b": (T.Blake2bWrite, T.Blake2bRead),
               "keccak256": (T.Keccak256Write, T.Keccak256Read)}


def _same_point(tp, jp) -> bool:
    if jp.is_identity():
        return tp.is_identity()
    return not tp.is_identity() and tp.xy == jp.xy


def test_pairing_matches_jax_and_is_bilinear():
    from halo2_tpu import pairing as jpairing
    from halo2_tpu.curves import Bn254G1 as JBn254G1

    rng = random.Random(7)
    r = T.FrBn.MODULUS
    for _ in range(2):
        a, b = rng.randrange(1, r), rng.randrange(1, r)
        P, Q = T.Bn254G1.generator().mul(a), T.pairing.PointG2.generator().mul(b)
        jP, jQ = JBn254G1.generator().mul(a), jpairing.PointG2.generator().mul(b)
        assert (P.xy, Q.xy) == (jP.xy, jQ.xy)
        f = T.pairing.miller_loop(P, Q)
        assert f == jpairing.miller_loop(jP, jQ)
        assert T.pairing.final_exponentiation(f) == jpairing.final_exponentiation(f)
    c = rng.randrange(2, r)
    # e(c P, Q) e(-P, c Q) = 1, and not with the sign dropped
    assert T.pairing.pairing_check([(P.mul(c), Q), (-P, Q.mul(c))])
    assert jpairing.pairing_check([(jP.mul(c), jQ), (-jP, jQ.mul(c))])
    assert not T.pairing.pairing_check([(P.mul(c), Q), (P, Q.mul(c))])


def test_setup_bytes_match_jax_and_read_roundtrips():
    from halo2_tpu.poly.kzg import ParamsKZG as JParamsKZG

    params = T.kzg.ParamsKZG.setup(4, random.Random(MUL_K4_PARAMS_SEED), device="cpu")
    data = params.write()
    assert data == JParamsKZG.setup(4, random.Random(MUL_K4_PARAMS_SEED)).write()
    assert len(data) == 4 + 2 * 16 * 64 + 2 * 128
    back = T.kzg.ParamsKZG.read(data, device="cpu")
    assert back.write() == data and back.g == params.g and back.s_g2 == params.s_g2


def test_committed_k10_params_and_cache_rules(tmp_path, monkeypatch):
    """The committed k = 10 file is the pinned one and `cached` reads it;
    where no file is cached, `cached` makes the JAX package's `cached`
    params (setup from random.Random(0x5E7)) and writes them."""
    from halo2_tpu.poly.kzg import ParamsKZG as JParamsKZG

    path = os.path.join(ROOT, ".params_cache", "kzg-Bn254G1-k10.raw")
    with open(path, "rb") as f:
        data = f.read()
    assert hashlib.sha256(data).hexdigest() == KZG_K10_PARAMS_SHA256
    monkeypatch.delenv("H2_PARAMS_CACHE", raising=False)
    monkeypatch.setattr(T.kzg.ParamsKZG, "_cache", {})
    assert T.kzg.ParamsKZG.cached(10, device="cpu").write() == data
    monkeypatch.setenv("H2_PARAMS_CACHE", str(tmp_path))
    made = T.kzg.ParamsKZG.cached(3, device="cpu")
    want = JParamsKZG.cached(3).write()
    assert made.write() == want
    assert (tmp_path / "kzg-Bn254G1-k3.raw").read_bytes() == want
    if not torch.cuda.is_available():  # the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            T.kzg.ParamsKZG.cached(3)


@pytest.mark.slow  # the JAX package's setup at k = 10 (about 5 s with its native paths)
def test_committed_k10_params_equal_jax():
    from halo2_tpu.poly.kzg import ParamsKZG as JParamsKZG

    assert hashlib.sha256(JParamsKZG.cached(10).write()).hexdigest() == KZG_K10_PARAMS_SHA256


@pytest.fixture(scope="module")
def k4_params():
    """ParamsKZG.setup(4, random.Random(42)) of both packages, and three rows
    of scalars below r (the first holds 0 and r - 1)."""
    from halo2_tpu.poly.kzg import ParamsKZG as JParamsKZG

    jparams = JParamsKZG.setup(4, random.Random(MUL_K4_PARAMS_SEED))
    r = T.FrBn.MODULUS
    rng = np.random.default_rng(5)
    rows = [[int.from_bytes(rng.bytes(32), "little") % r for _ in range(16)] for _ in range(3)]
    rows[0][:2] = [0, r - 1]
    return T.kzg.ParamsKZG.read(jparams.write(), device="cpu"), jparams, rows


def test_single_commits_match_jax_k4(k4_params):
    """commit and commit_lagrange at k = 4 give the JAX package's points (on
    the host MSM at this size; `test_msm_kzg_and_dual_msm[bucket]` sends a
    KZG MSM through the bucket MSM's plain stages)."""
    params, jparams, rows = k4_params
    for row in rows[:2]:
        assert _same_point(params.commit(row), jparams.commit(row))
        assert _same_point(params.commit_lagrange(row), jparams.commit_lagrange(row))


def test_commit_many_matches_jax_k4(k4_params):
    """commit_many, always on the bucket MSM and without a blind row, gives
    the JAX package's points in both bases."""
    import jax.numpy as jnp

    from halo2_tpu.fields import FrBn as JFrBn
    from halo2_tpu.ops.field_jax import FieldCtx as JFieldCtx
    from halo2_tpu.poly.commitment import Blind as JBlind
    from halo2_tpu_torch.interop import limbs_tensor
    from halo2_tpu_torch.poly.commitment import Blind

    params, jparams, rows = k4_params
    r = T.FrBn.MODULUS
    stack = np.stack([np.asarray(JFieldCtx(JFrBn).encode_ints(row)) for row in rows])
    blinds = [3, 0, r - 1]
    for lagrange in (False, True):
        want = jparams.commit_many(jnp.asarray(stack), [JBlind(b) for b in blinds], lagrange)
        got = params.commit_many(limbs_tensor(stack), [Blind(b) for b in blinds], lagrange)
        assert all(_same_point(t, j) for t, j in zip(got, want))


@pytest.mark.parametrize("device_msm_min", [None, 1], ids=["host", "bucket"])
def test_msm_kzg_and_dual_msm(monkeypatch, device_msm_min):
    """MSMKZG holds -g[0] and commitments that may be the identity (a
    commitment to zero): its eval drops identity terms before a device MSM,
    whose bases must be affine, and gives the JAX package's point. DualMSM's
    pairing check holds for e(G, s G2) = e(s G, G2) and fails otherwise."""
    from halo2_tpu.curves import Bn254G1 as JBn254G1
    from halo2_tpu.poly.kzg import MSMKZG as JMSMKZG, ParamsKZG as JParamsKZG
    from halo2_tpu_torch.interop import point
    from halo2_tpu_torch.ops import msm as msm_mod

    if device_msm_min is not None:
        monkeypatch.setattr(msm_mod, "DEVICE_MSM_MIN", device_msm_min)
    jparams = JParamsKZG.setup(4, random.Random(MUL_K4_PARAMS_SEED))
    params = T.kzg.ParamsKZG.read(jparams.write(), device="cpu")
    r = T.FrBn.MODULUS
    rng = random.Random(3)
    jterms = [-jparams.g[0], JBn254G1.identity(), jparams.g[3], jparams.g_lagrange[5],
              JBn254G1.identity()]
    m, jm = params.empty_msm(), JMSMKZG(JBn254G1)
    for jpt in jterms:
        s = rng.randrange(r)
        m.append_term(s, point(jpt))
        jm.append_term(s, jpt)
    assert _same_point(m.eval(), jm.eval())
    m.scale(r - 7)
    jm.scale(r - 7)
    assert _same_point(m.eval(), jm.eval())
    dual = params.accumulator()
    dual.left.append_term(1, params.g[0])
    dual.right.append_term(1, params.g[1])
    assert dual.check()
    dual.right.append_term(1, params.g[0])
    assert not dual.check()


@pytest.mark.parametrize("seed", [5, 9, 13])
def test_shplonk_intermediate_sets_match_jax(seed):
    from halo2_tpu.poly.kzg import construct_intermediate_sets_shplonk as jsets

    rng = random.Random(seed)
    r = T.FrBn.MODULUS
    points = [rng.randrange(r) for _ in range(5)]
    queries = []
    for c in range(rng.randrange(2, 8)):
        for pt in rng.sample(points, rng.randrange(1, 5)):
            queries.append((c, pt, rng.randrange(r)))
    rng.shuffle(queries)
    getters = dict(get_commitment_key=lambda q: q[0], get_point=lambda q: q[1],
                   get_eval=lambda q: q[2])
    assert T.kzg.construct_intermediate_sets_shplonk(queries, **getters) == jsets(queries, **getters)


@pytest.fixture(scope="module")
def mul_k4():
    params = T.kzg.ParamsKZG.setup(4, random.Random(MUL_K4_PARAMS_SEED), device="cpu")
    vk = T.keygen_vk(params, T.MulCircuit(MUL_K4_CONSTANT))
    pk = T.keygen_pk(params, vk, T.MulCircuit(MUL_K4_CONSTANT))
    return params, vk, pk


@pytest.fixture(scope="module")
def mul_k4_proof(mul_k4):
    """proof(multiopen, transcript): each variant's MulCircuit k = 4 proof,
    made once for the module."""
    proofs = {}

    def proof(multiopen, tname):
        if (multiopen, tname) not in proofs:
            params, _vk, pk = mul_k4
            t = TRANSCRIPTS[tname][0](T.Bn254G1)
            T.create_proof(params, pk, [T.MulCircuit(MUL_K4_CONSTANT, MUL_K4_A, MUL_K4_B)],
                           [[[MUL_K4_INSTANCE]]], T.ChaCha20Rng(b"\x2a" * 32), t,
                           multiopen=multiopen)
            proofs[multiopen, tname] = t.finalize()
        return proofs[multiopen, tname]

    return proof


def _verify_mul(mul_k4, proof, multiopen, tname, instance=MUL_K4_INSTANCE):
    params, vk, _pk = mul_k4
    return T.verify_proof(params, vk, [[[instance]]], TRANSCRIPTS[tname][1](T.Bn254G1, proof),
                          multiopen=multiopen)


@pytest.mark.parametrize("multiopen,tname", VARIANTS)
def test_mul_circuit_k4_proof_bytes_match_jax(mul_k4, mul_k4_proof, multiopen, tname):
    """The proof has the JAX package's bytes and verifies; a wrong instance
    and a flipped byte are rejected."""
    proof = mul_k4_proof(multiopen, tname)
    assert hashlib.sha256(proof).hexdigest() == MUL_K4_PROOF_SHA256[multiopen, tname]
    assert _verify_mul(mul_k4, proof, multiopen, tname) is True
    with pytest.raises(REJECTED):
        _verify_mul(mul_k4, proof, multiopen, tname, instance=MUL_K4_INSTANCE + 1)
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    with pytest.raises(REJECTED):
        _verify_mul(mul_k4, bytes(bad), multiopen, tname)


def test_variant_mismatch_rejected(mul_k4, mul_k4_proof):
    """A GWC proof does not verify under SHPLONK, nor the other way round."""
    for made, checked in (("gwc", "shplonk"), ("shplonk", "gwc")):
        with pytest.raises(REJECTED):
            _verify_mul(mul_k4, mul_k4_proof(made, "blake2b"), checked, "blake2b")


def test_other_params_still_raise():
    from halo2_tpu_torch.plonk.prover import _dispatch_scheme

    with pytest.raises(NotImplementedError):
        _dispatch_scheme(object(), None)


@pytest.mark.slow  # the JAX package's KZG prover compiles for minutes on the CPU
def test_mul_circuit_k4_pins_recomputed_from_jax():
    assert _jax_mul_k4_sha256s() == MUL_K4_PROOF_SHA256


class _Recorder:
    """Layouter, region and table in one: keeps each advice value by
    (column, row), for either package's circuits."""

    def __init__(self):
        self.advice = {}

    def assign_region(self, name, fn):
        return fn(self)

    def assign_table(self, name, fn):
        return None

    def assign_advice(self, column, row, value, name):
        self.advice[column, row] = None if value.is_none() else int(value.force_value())
        return self

    def cell(self):
        return None

    def assign_fixed(self, *args):
        pass

    def constrain_equal(self, *args):
        pass


def _witness(circuit):
    rec = _Recorder()
    config = SimpleNamespace(**{name: name for name in ("a", "b", "c", "sa", "sb", "sc", "sm", "sl")})
    circuit.synthesize(config, rec)
    return rec.advice


def test_bench_circuit_field_default_keeps_pasta_witness():
    """BenchCircuit's default field is Pasta's Fp: its witness is the one of
    examples/plonk_bench.py, so the IPA bytes (the MulCircuit golden, the
    pinned k = 10, 14 and 16 proofs) keep theirs. Over FrBn the chain is the
    test-local JAX copy's, wraps mod FrBn, and every row satisfies the gate
    a b + a + b - c = 0 and the copy c[i] = a[i + 1] over FrBn."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "examples")]
    from plonk_bench import bench_circuit_for_k as jbench_circuit_for_k

    k = 9
    fp = _witness(T.bench_circuit_for_k(k))
    assert fp == _witness(jbench_circuit_for_k(k))
    bn = _witness(T.bench_circuit_for_k(k, field=T.FrBn))
    assert bn == _witness(_jax_bench_circuit_frbn(k))
    assert bn != fp
    r = T.FrBn.MODULUS
    rows = (1 << k) - 64
    assert max(bn["a", i] for i in range(rows)) >= 1 << 250  # the chain wrapped mod r
    for i in range(rows):
        a, b, c = bn["a", i], bn["b", i], bn["c", i]
        assert (a * b + a + b - c) % r == 0 and 0 <= b < 1 << 8
        if i + 1 < rows:
            assert bn["a", i + 1] == c
    assert T.bench_circuit_for_k(k).without_witnesses().field is T.bench_circuit_for_k(k).field


@pytest.mark.slow  # about 45 s on two CPU threads: plain bucket MSMs and the NTTs at 2^10
def test_bench_circuit_frbn_k10_proof_bytes_match_jax():
    k = 10
    params = T.kzg.ParamsKZG.cached(k, device="cpu")
    circuit = T.bench_circuit_for_k(k, field=T.FrBn)
    vk = T.keygen_vk(params, circuit.without_witnesses())
    pk = T.keygen_pk(params, vk, circuit.without_witnesses())
    t = T.Blake2bWrite(T.Bn254G1)
    T.create_proof(params, pk, [circuit], [[]], T.ChaCha20Rng(b"\x2a" * 32), t)
    proof = t.finalize()
    assert hashlib.sha256(proof).hexdigest() == BENCH_KZG_K10_PROOF_SHA256
    assert T.verify_proof(params, vk, [[]], T.Blake2bRead(T.Bn254G1, proof)) is True


@pytest.mark.slow
def test_bench_circuit_frbn_k10_pin_recomputed_from_jax():
    assert _jax_bench_k10_sha256() == BENCH_KZG_K10_PROOF_SHA256


# ---------------------------------------------------------------------------
# Kernels 1-4 in their generic form (BN254) on the card
# ---------------------------------------------------------------------------


def _edge_limbs(n: int, p: int, seed: int):
    from halo2_tpu_torch.ops.field import ints_to_limbs

    rng = np.random.default_rng(seed)
    vals = [0, 1, p - 1, 2 * p - 1] + [int.from_bytes(rng.bytes(32), "little") % (2 * p)
                                       for _ in range(n - 4)]
    return torch.as_tensor(ints_to_limbs(vals), device="cuda")


@pytest.mark.gpu
def test_kernel1_generic_form_matches_plain_on_card():
    """Kernel 1 over FrBn (`fe_mul_cc<false>`) bit for bit against its plain
    version at every level of the 2^10, 2^14 and 2^16 plans, both directions,
    on the edge inputs 0, 1, p - 1, 2p - 1; each transform the radix-2 one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    from halo2_tpu_torch.ops import ntt_cg
    from halo2_tpu_torch.ops.field import FieldCtx, from_mont
    from halo2_tpu_torch.ops.ntt import NttPlan

    F = T.FrBn
    ctx = FieldCtx(F)
    p = F.MODULUS
    for log_n in (10, 14, 16):
        n = 1 << log_n
        w = pow(F.ROOT_OF_UNITY, 1 << (F.S - log_n), p)
        for omega in (w, pow(w, -1, p)):
            plan = ntt_cg.CgNttPlan(F, log_n, omega)
            for li, (lv, tab) in enumerate(zip(plan.levels, plan._tables("cuda"))):
                f, g = lv["f"], lv["g"]
                x = _edge_limbs(n, p, log_n + li).reshape(n // (f * g), f, g, 16)
                got = ntt_cg.cg_ntt_level(x, tab["stw"], tab["inter"], ctx, tab["perm"])
                want = ntt_cg.cg_ntt_level_plain(x, tab["stw"], tab["inter"], ctx, tab["perm"])
                torch.cuda.synchronize()
                assert torch.equal(got, want), f"2^{log_n} level {li}"
            a = _edge_limbs(n, p, log_n)
            assert torch.equal(from_mont(plan(a), ctx), from_mont(NttPlan(F, log_n, omega)(a), ctx))


@pytest.mark.gpu
def test_bucket_kernels_generic_form_match_plain_on_card():
    """Kernels 2-4 on BN254's G1 (3b = 9, `fe_mul` and `fe_mul_cc<false>` on
    FqBn) against their plain versions at the KZG k = 14 commit shape (M = 3,
    n = 2^14, c = 4) and at c = 8, kernel 4 bit for bit also on parts that
    hold the identity, P, P and P, -P; each MSM equals msm_host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    from halo2_tpu_torch.ops import msm_bucket
    from halo2_tpu_torch.ops.curve import CurveCtx, PointVec
    from halo2_tpu_torch.ops.field import ints_to_limbs
    from halo2_tpu_torch.ops.msm import MSMBases, msm_host

    curve = T.Bn254G1
    cc = CurveCtx(curve)
    r = curve.SCALAR.MODULUS
    rng = np.random.default_rng(31)
    g = curve.generator()
    n = 1 << 14
    pts = [g.mul(int(rng.integers(1, 1 << 62))) for _ in range(64)] * (n // 64)
    bases = MSMBases(curve, pts, "cuda")
    rows = [[int.from_bytes(rng.bytes(32), "little") % r for _ in range(n)] for _ in range(3)]
    rows[0][:2] = [0, r - 1]
    scal = torch.as_tensor(np.stack([ints_to_limbs(row) for row in rows]), device="cuda")
    for c in (4, 8):
        nwin = -(-r.bit_length() // c)
        db = bases.device_tables(n, "cuda")
        st = scal.transpose(1, 2).contiguous()
        bk = msm_bucket.msm_accum(st, db.px, db.py, c, nwin, 128, cc)
        fk = msm_bucket.msm_fold(bk, cc)
        rk = msm_bucket.msm_lane_reduce(fk, cc)
        for got, want in ((bk, msm_bucket.msm_accum_plain(st, db.px, db.py, c, nwin, 128, cc)),
                          (fk, msm_bucket.msm_fold_plain(bk, cc)),
                          (rk, msm_bucket.msm_lane_reduce_plain(fk, cc))):
            torch.cuda.synchronize()
            assert torch.equal(got, want)  # raw limbs
        ep = fk.clone()
        idv = cc.identity_vec((1,), "cuda")
        ident = torch.stack([idv.x[0], idv.y[0], idv.z[0]])
        ep[:, :, :, 1] = ident
        ep[:, :, :, 64] = ep[:, :, :, 0]  # P + P at the first level
        ep[:, 1, :, 66] = cc.fctx.neg(ep[:, 1, :, 2])  # P + (-P)
        ep[-1] = ident[:, :, None]
        ek = msm_bucket.msm_lane_reduce(ep, cc)
        assert torch.equal(ek, msm_bucket.msm_lane_reduce_plain(ep, cc))
        assert cc.decode_points(PointVec(ek[-1:, 0], ek[-1:, 1], ek[-1:, 2]))[0].is_identity()
    got = msm_bucket.msm_bucket_many(scal, bases, mont=False)
    assert got[0] == msm_host(rows[0], pts, curve)


if __name__ == "__main__":
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import jax

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:] == ["pins"]:
        for key, digest in _jax_mul_k4_sha256s().items():
            print(key, digest, flush=True)
    elif sys.argv[1:] == ["bench10"]:
        print(_jax_bench_k10_sha256(), flush=True)
    else:
        raise SystemExit("usage: python tests/test_torch_kzg.py pins|bench10")
