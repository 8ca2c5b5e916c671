"""The port's gadgets on the CPU, held to the JAX package.

The Poseidon primitives (Grain constants, MDS matrices, permutation,
sponge) must equal the JAX package's and the reference's test vectors
(tests/fixtures_poseidon.json); the Pow5 chip, PoseidonHash and the
utilities gadgets must give both packages' MockProver the same failure
lists; the port's IPA proof of HashCircuit at k = 7 must have the JAX
package's bytes. The pinned sha256 of the HashCircuit proofs were made
once on the CPU with

    PYTHONPATH=. JAX_PLATFORMS=cpu XLA_FLAGS=--xla_cpu_parallel_codegen_split_count=1 \\
        python tests/test_torch_gadgets.py <k>

which proves HashCircuit([7, 11]) with the JAX package at k = 7
(ChaCha20Rng(b"\\x01" * 32), tests/test_poseidon_gadget.py) or k = 11
(ChaCha20Rng(b"\\x02" * 32), tests/golden_circuits.py) and prints the sha256.
"""

import hashlib
import json
import os
import random
import sys

import pytest
import torch

from halo2_tpu.dev.mock_prover import MockProver as JMockProver
from halo2_tpu.fields import Fp as JFp
from halo2_tpu.frontend import Circuit as JCircuit, Value as JValue
from halo2_tpu.gadgets import poseidon_primitives as jprim, utilities as jutil
from halo2_tpu.plonk import ConstraintSystem as JConstraintSystem
from halo2_tpu_torch.circuits import HashCircuit
from halo2_tpu_torch.curves import Vesta
from halo2_tpu_torch.dev.mock_prover import MockProver
from halo2_tpu_torch.fields import Fp
from halo2_tpu_torch.frontend import Circuit, Value
from halo2_tpu_torch.gadgets import poseidon_primitives as prim, utilities as util
from halo2_tpu_torch.plonk import ConstraintSystem
from halo2_tpu_torch.plonk.error import OpeningError
from halo2_tpu_torch.plonk.keygen import keygen_pk, keygen_vk
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.plonk.verifier import verify_proof
from halo2_tpu_torch.poly.ipa import ParamsIPA
from halo2_tpu_torch.transcript import Blake2bRead, Blake2bWrite
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


SEEDS = {7: b"\x01" * 32, 11: b"\x02" * 32}
# HashCircuit([7, 11]) at k = 7 proved by the JAX package (the command above)
HASH_K7_PROOF_SHA256 = "7f729060844a833b6714c87164d4c5e26bdcd623ec82221e2b5a054f78d010fc"
MSG = [7, 11]
FIXTURES = json.load(open(os.path.join(os.path.dirname(__file__), "fixtures_poseidon.json")))
SPECS = {"fp": (prim.P128Pow5T3Fp, jprim.P128Pow5T3Fp), "fq": (prim.P128Pow5T3Fq, jprim.P128Pow5T3Fq)}


def _render(failures):
    return [(f.kind, str(f)) for f in failures]


# ---------------- primitives ----------------


@pytest.mark.parametrize("name", sorted(SPECS))
def test_constants_match_jax(name):
    spec, jspec = SPECS[name]
    assert spec.constants() == jspec.constants()
    rc, mds, mds_inv = spec.constants()
    assert len(rc) == 64
    p = spec.FIELD.MODULUS
    assert [[sum(mds[i][k] * mds_inv[k][j] for k in range(3)) % p for j in range(3)]
            for i in range(3)] == [[1, 0, 0], [0, 1, 0], [0, 0, 1]]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_permute_and_hash_match_vectors_and_jax(name):
    spec, jspec = SPECS[name]
    for tv in FIXTURES[name]["permute"]:
        assert prim.permute(list(tv["initial"]), spec) == tv["final"]
    for tv in FIXTURES[name]["hash"]:
        got = prim.poseidon_hash(list(tv["input"]), spec, prim.ConstantLength(2))
        assert got == tv["output"]
    rng = random.Random(0x5EED)
    p = spec.FIELD.MODULUS
    for _ in range(4):
        state = [rng.randrange(p) for _ in range(3)]
        assert prim.permute(list(state), spec) == jprim.permute(list(state), jspec)
        msg = state[:2]
        assert (prim.poseidon_hash(msg, spec, prim.ConstantLength(2))
                == jprim.poseidon_hash(msg, jspec, jprim.ConstantLength(2)))


def test_sponge_matches_jax():
    spec, jspec = SPECS["fp"]
    msg = [1, 2, 3, 4, 5]
    sponge = prim.Sponge(spec, prim.ConstantLength(len(msg)).initial_capacity_element())
    jsponge = jprim.Sponge(jspec, jprim.ConstantLength(len(msg)).initial_capacity_element())
    for m in msg + [0]:  # padded to the rate
        sponge.absorb(m)
        jsponge.absorb(m)
    sponge.finish_absorbing()
    jsponge.finish_absorbing()
    assert [sponge.squeeze() for _ in range(3)] == [jsponge.squeeze() for _ in range(3)]


# ---------------- the Pow5 chip and PoseidonHash under MockProver ----------------


@pytest.fixture(scope="module")
def jax_hash_circuit():
    from test_poseidon_gadget import HashCircuit as JHashCircuit

    return JHashCircuit


@pytest.mark.parametrize("wrong", [False, True])
def test_poseidon_hash_gadget_mock_matches_jax(jax_hash_circuit, wrong):
    digest = prim.poseidon_hash(MSG, prim.P128Pow5T3Fp, prim.ConstantLength(2))
    inst = [[(digest + wrong) % prim.P128Pow5T3Fp.FIELD.MODULUS]]
    got = _render(MockProver.run(7, HashCircuit(MSG), inst, device="cpu").verify())
    want = _render(JMockProver.run(7, jax_hash_circuit(MSG), inst).verify())
    assert got == want
    assert bool(got) == wrong


def test_poseidon_hash_gadget_vectorized():
    digest = prim.poseidon_hash(MSG, prim.P128Pow5T3Fp, prim.ConstantLength(2))
    prover = MockProver.run(7, HashCircuit(MSG), [[digest + 1]], device="cpu")
    assert _render(prover.verify(vectorized=True)) == _render(prover.verify(vectorized=False))


# ---------------- the utilities gadgets ----------------


def _swap_circuit(pkg):
    base, V, CS, u, F = pkg

    class SwapCircuit(base):
        def __init__(self, a=None, b=None, swap=None):
            self.a, self.b, self.swap_flag = a, b, swap

        def without_witnesses(self):
            return SwapCircuit()

        @classmethod
        def configure(cls, meta: CS):
            return u.CondSwapChip.configure(meta, [meta.advice_column() for _ in range(5)])

        def synthesize(self, config, layouter):
            chip = u.CondSwapChip(config, F)
            a = u.load_private(layouter, config.a, V.known(self.a))
            chip.swap(layouter, (a, V.known(self.b)), V.known(self.swap_flag))

    return SwapCircuit


def _running_sum_circuit(pkg):
    base, V, CS, u, F = pkg

    class RunningSumCircuit(base):
        WORD_BITS = 12
        WINDOW = 3

        def __init__(self, alpha=None, strict=True):
            self.alpha = alpha
            self.strict = strict

        def without_witnesses(self):
            return RunningSumCircuit(None, self.strict)

        @classmethod
        def configure(cls, meta: CS):
            z = meta.advice_column()
            q = meta.selector()
            constants = meta.fixed_column()
            meta.enable_constant(constants)
            return u.RunningSumConfig.configure(meta, q, z, cls.WINDOW, F)

        def synthesize(self, config, layouter):
            def in_region(region):
                config.witness_decompose(region, 0, V.known(self.alpha), self.strict,
                                         self.WORD_BITS, self.WORD_BITS // self.WINDOW)

            layouter.assign_region("decompose", in_region)

    return RunningSumCircuit


def _lookup_rc_circuit(pkg):
    base, V, CS, u, F = pkg

    class LookupRCCircuit(base):
        K = 4

        def __init__(self, element=None, num_words=3, short_bits=None):
            self.element = element
            self.num_words = num_words
            self.short_bits = short_bits

        def without_witnesses(self):
            return LookupRCCircuit(None, self.num_words, self.short_bits)

        @classmethod
        def configure(cls, meta: CS):
            running_sum = meta.advice_column()
            table_idx = meta.lookup_table_column()
            constants = meta.fixed_column()
            meta.enable_constant(constants)
            return u.LookupRangeCheckConfig.configure(meta, running_sum, table_idx, cls.K,
                                                      F)

        def synthesize(self, config, layouter):
            config.load(layouter)
            value = V.known(self.element)
            if self.short_bits is not None:
                config.witness_short_check(layouter, value, self.short_bits)
            else:
                config.witness_check(layouter, value, self.num_words, True)

    return LookupRCCircuit


PORT = (Circuit, Value, ConstraintSystem, util, Fp)
JAX = (JCircuit, JValue, JConstraintSystem, jutil, JFp)
UTIL_CASES = {
    "cond_swap": (4, _swap_circuit, (11, 22, False), True),
    "cond_swap_swapped": (4, _swap_circuit, (11, 22, True), True),
    "running_sum": (6, _running_sum_circuit, (0xABC,), True),
    "running_sum_overflow": (6, _running_sum_circuit, ((1 << 12) + 5,), False),
    "lookup_range_check": (6, _lookup_rc_circuit, (0xABC,), True),
    "lookup_range_check_overflow": (6, _lookup_rc_circuit, ((1 << 12) + 1,), False),
    "short_range_check": (6, _lookup_rc_circuit, (5, 3, 3), True),
    "short_range_check_fails": (6, _lookup_rc_circuit, (9, 3, 3), False),
}


@pytest.mark.parametrize("case", sorted(UTIL_CASES))
def test_utilities_gadgets_match_jax(case):
    k, make, args, ok = UTIL_CASES[case]
    got = _render(MockProver.run(k, make(PORT)(*args), [], device="cpu").verify())
    want = _render(JMockProver.run(k, make(JAX)(*args), []).verify())
    assert got == want
    assert (got == []) == ok


def test_bit_helpers_match_jax():
    v = 0b1101_0110_1001
    assert util.bitrange_subset(v, 0, 4) == 0b1001
    assert util.decompose_word(v, 12, 3) == jutil.decompose_word(v, 12, 3) == [1, 5, 5, 6]
    assert util.lebs2ip(util.i2lebsp(v, 12)) == v
    assert util.i2lebsp(v, 12) == jutil.i2lebsp(v, 12)


# ---------------- HashCircuit proved by the port ----------------


def test_hash_circuit_k7_proof_has_the_jax_bytes():
    k = 7
    digest = prim.poseidon_hash(MSG, prim.P128Pow5T3Fp, prim.ConstantLength(2))
    params = ParamsIPA.cached(Vesta, k, device="cpu")
    vk = keygen_vk(params, HashCircuit(None))
    pk = keygen_pk(params, vk, HashCircuit(None))
    t = Blake2bWrite(Vesta)
    create_proof(params, pk, [HashCircuit(MSG)], [[[digest]]], ChaCha20Rng(SEEDS[k]), t)
    proof = t.finalize()
    assert hashlib.sha256(proof).hexdigest() == HASH_K7_PROOF_SHA256
    assert verify_proof(params, vk, [[[digest]]], Blake2bRead(Vesta, proof)) is True
    with pytest.raises(OpeningError):
        verify_proof(params, vk, [[[digest + 1]]], Blake2bRead(Vesta, proof))


@pytest.mark.slow  # about two hours on the CPU: XLA compiles the JAX package's prover
def test_hash_circuit_k7_pin_recomputed_from_jax():
    assert _jax_hash_proof_sha256(7) == HASH_K7_PROOF_SHA256


@pytest.mark.slow  # about three hours on the CPU
def test_hash_circuit_k11_pin_recomputed_from_jax():
    """Gating config 2, which chip_smoke.py proves on the card."""
    import chip_smoke

    assert _jax_hash_proof_sha256(11) == chip_smoke.POSEIDON_K11_PROOF_SHA256


# ---------------- the JAX package's proof (the pins) ----------------


def _jax_hash_proof_sha256(k: int) -> str:
    """Prove HashCircuit([7, 11]) at k with the JAX package; return the sha256."""
    import jax

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [root, os.path.join(root, "tests")]
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
    try:
        return _jax_hash_proof(k)
    finally:
        measure.span = base_span


def _jax_hash_proof(k: int) -> str:
    import jax

    from test_poseidon_gadget import HashCircuit as JHashCircuit

    from halo2_tpu.curves import Vesta as JVesta
    from halo2_tpu.gadgets.poseidon_primitives import (
        ConstantLength as JConstantLength,
        P128Pow5T3Fp as JP128Pow5T3Fp,
        poseidon_hash as jposeidon_hash,
    )
    from halo2_tpu.plonk.keygen import keygen_pk as jkeygen_pk, keygen_vk as jkeygen_vk
    from halo2_tpu.plonk.prover import create_proof as jcreate_proof
    from halo2_tpu.plonk.verifier import verify_proof as jverify_proof
    from halo2_tpu.poly.ipa import ParamsIPA as JParamsIPA
    from halo2_tpu.transcript import Blake2bRead as JBlake2bRead, Blake2bWrite as JBlake2bWrite
    from halo2_tpu.utils.chacha import ChaCha20Rng as JChaCha20Rng

    msg = [7, 11]
    expected = jposeidon_hash(msg, JP128Pow5T3Fp, JConstantLength(2))
    params = JParamsIPA.cached(JVesta, k)
    vk = jkeygen_vk(params, JHashCircuit(None))
    pk = jkeygen_pk(params, vk, JHashCircuit(None))
    jax.clear_caches()
    t = JBlake2bWrite(JVesta)
    jcreate_proof(params, pk, [JHashCircuit(msg)], [[[expected]]], JChaCha20Rng(SEEDS[k]), t)
    proof = t.finalize()
    jax.clear_caches()
    assert jverify_proof(params, vk, [[[expected]]], JBlake2bRead(JVesta, proof)) is True
    return hashlib.sha256(proof).hexdigest()


if __name__ == "__main__":
    print(_jax_hash_proof_sha256(int(sys.argv[1])))
