"""The port's whole proof on the CPU, held to the JAX package's bytes.

MulCircuit at k = 4 must give the VK transcript repr, the pinned-VK sha256
and the proof sha256 of tests/fixtures_golden.json (the JAX package's golden
values), verify, and fail to verify against a wrong public input.
BenchCircuit (examples/plonk_bench.py, seed 42) at k = 10 must give the
proof bytes that the JAX package gives. That sha256 was made once on the
CPU with

    PYTHONPATH=. JAX_PLATFORMS=cpu XLA_FLAGS=--xla_cpu_parallel_codegen_split_count=1 \\
        python tests/test_torch_prove.py

which proves with the JAX package and prints it (about an hour on eight CPU
cores: XLA compiles the prover's programs again after each stage).
"""

import hashlib
import json
import os

import pytest
import torch

from halo2_tpu_torch.circuits import MulCircuit, bench_circuit_for_k
from halo2_tpu_torch.curves import Vesta
from halo2_tpu_torch.plonk.error import OpeningError
from halo2_tpu_torch.helpers import PROCESSED, RAW_BYTES, RAW_BYTES_UNCHECKED
from halo2_tpu_torch.plonk.keygen import ProvingKey, VerifyingKey, keygen_pk, keygen_vk
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.plonk.verifier import verify_proof
from halo2_tpu_torch.poly.ipa import ParamsIPA
from halo2_tpu_torch.transcript import Blake2bRead, Blake2bWrite
from halo2_tpu_torch.utils.chacha import ChaCha20Rng

torch.set_num_threads(2)

GOLDEN = json.load(open(os.path.join(os.path.dirname(__file__), "fixtures_golden.json")))
BENCH_K10_PROOF_SHA256 = "08b4952d1b1cac2b4951ac6097ac2f6a260cddc729bb0d54cb788de8510af1db"


def _prove(params, pk, circuit, instances):
    t = Blake2bWrite(Vesta)
    create_proof(params, pk, [circuit], [instances], ChaCha20Rng(b"\x2a" * 32), t)
    return t.finalize()


def test_mul_circuit_k4_golden_bytes_and_verify():
    params = ParamsIPA.cached(Vesta, 4, device="cpu")
    vk = keygen_vk(params, MulCircuit(7))
    pk = keygen_pk(params, vk, MulCircuit(7))
    assert hex(vk.transcript_repr) == GOLDEN["vk_transcript_repr"]
    assert hashlib.sha256(vk.pinned_repr().encode()).hexdigest() == GOLDEN["vk_pinned_sha256"]
    c = 7 * 4 * 9
    proof = _prove(params, pk, MulCircuit(7, 2, 3), [[c]])
    assert len(proof) == GOLDEN["proof_len"]
    assert hashlib.sha256(proof).hexdigest() == GOLDEN["proof_sha256"]
    assert verify_proof(params, vk, [[[c]]], Blake2bRead(Vesta, proof)) is True
    with pytest.raises(OpeningError):
        verify_proof(params, vk, [[[42]]], Blake2bRead(Vesta, proof))


@pytest.fixture(scope="module")
def k4_keys():
    """MulCircuit k = 4 keys of both packages."""
    from circuits import MulCircuit as JMulCircuit

    from halo2_tpu.curves import Vesta as JVesta
    from halo2_tpu.plonk.keygen import keygen_pk as jkeygen_pk, keygen_vk as jkeygen_vk
    from halo2_tpu.poly.ipa import ParamsIPA as JParamsIPA

    jparams = JParamsIPA.cached(JVesta, 4)
    jvk = jkeygen_vk(jparams, JMulCircuit(7))
    jpk = jkeygen_pk(jparams, jvk, JMulCircuit(7))
    params = ParamsIPA.cached(Vesta, 4, device="cpu")
    vk = keygen_vk(params, MulCircuit(7))
    pk = keygen_pk(params, vk, MulCircuit(7))
    return params, vk, pk, jvk, jpk


@pytest.mark.parametrize("fmt", [PROCESSED, RAW_BYTES, RAW_BYTES_UNCHECKED])
def test_key_bytes_match_jax_and_roundtrip(k4_keys, fmt):
    params, vk, pk, jvk, jpk = k4_keys
    data = vk.to_bytes(fmt)
    assert data == jvk.to_bytes(fmt)
    pk_data = pk.to_bytes(fmt)
    assert pk_data == jpk.to_bytes(fmt)
    vk2 = VerifyingKey.from_bytes(data, MulCircuit, params, fmt)
    assert vk2.transcript_repr == vk.transcript_repr and vk2.to_bytes(fmt) == data
    assert ProvingKey.from_bytes(pk_data, MulCircuit, params, fmt).to_bytes(fmt) == pk_data


@pytest.mark.slow  # about 140 s on two CPU threads: the plain bucket MSM runs every IPA round
def test_bench_circuit_k10_proof_bytes_match_jax():
    k = 10
    params = ParamsIPA.cached(Vesta, k, device="cpu")
    circuit = bench_circuit_for_k(k)
    vk = keygen_vk(params, circuit.without_witnesses())
    pk = keygen_pk(params, vk, circuit.without_witnesses())
    proof = _prove(params, pk, circuit, [])
    assert hashlib.sha256(proof).hexdigest() == BENCH_K10_PROOF_SHA256
    assert verify_proof(params, vk, [[]], Blake2bRead(Vesta, proof)) is True


def _jax_bench_k10_sha256() -> str:
    """Prove BenchCircuit at k = 10 with the JAX package; return the sha256."""
    import sys

    import jax

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [root, os.path.join(root, "examples")]
    jax.config.update("jax_platforms", "cpu")
    from halo2_tpu.utils import measure

    # XLA:CPU runs out of mappable code memory once a few hundred programs
    # have been compiled in one process (tests/conftest.py clears per
    # module for the same reason); drop them at the end of every stage.
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
    from plonk_bench import bench_circuit_for_k as jax_bench_circuit_for_k

    from halo2_tpu.curves import Vesta as JVesta
    from halo2_tpu.plonk.keygen import keygen_pk as jkeygen_pk, keygen_vk as jkeygen_vk
    from halo2_tpu.plonk.prover import create_proof as jcreate_proof
    from halo2_tpu.poly.ipa import ParamsIPA as JParamsIPA
    from halo2_tpu.transcript import Blake2bWrite as JBlake2bWrite
    from halo2_tpu.utils.chacha import ChaCha20Rng as JChaCha20Rng

    params = JParamsIPA.cached(JVesta, 10)
    circuit = jax_bench_circuit_for_k(10)
    vk = jkeygen_vk(params, circuit.without_witnesses())
    pk = jkeygen_pk(params, vk, circuit.without_witnesses())
    jax.clear_caches()
    t = JBlake2bWrite(JVesta)
    jcreate_proof(params, pk, [circuit], [[]], JChaCha20Rng(b"\x2a" * 32), t)
    return hashlib.sha256(t.finalize()).hexdigest()


if __name__ == "__main__":
    print(_jax_bench_k10_sha256())
