"""The port's Sinsemilla gadgets on the CPU, held to the JAX package.

The host primitives (the S table, padding, HashDomain, CommitDomain, the
MerkleCRH message words) must equal the JAX package's and the reference's
sampled S table (tests/fixtures_sinsemilla_s.json); every test circuit must
give both packages the same constraint system, and both packages'
MockProver the same witness and the same failures, rendered as text. The
MockProver cases are k = 11 (the generator table has 2^10 rows) and are held
to tests/fixtures_torch_sinsemilla.json, written once on the CPU with

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_sinsemilla.py pin

from the JAX package's MockProver (a `slow` twin recomputes it).

Gating config 4 (SinsemillaCircuit, 3 words, bits from random.Random(21),
ChaCha20Rng(b"\\x04" * 32), Vesta params, Blake2b; tests/golden_circuits.py)
is proved on the card by chip_smoke.py at k = 14 and k = 11; both pins,
SINSEMILLA_K1{1,4}_PROOF_SHA256 in chip_smoke.py, are the card's first
proofs, and the port's plain path on the CPU gives the k = 11 one (`slow`).
The JAX package's k = 11 proof, the cross-package check, is made on the CPU
with

    PYTHONPATH=. JAX_PLATFORMS=cpu XLA_FLAGS=--xla_cpu_parallel_codegen_split_count=1 \\
        python tests/test_torch_sinsemilla.py 11

which proves the circuit with the JAX package and prints the sha256.
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

from test_torch_ecc import jax_cs, jax_record, pin_cases, port_cs, port_record  # noqa: E402

import test_sinsemilla_fused as jfused  # noqa: E402
import test_sinsemilla_gadget as jgadget  # noqa: E402
import test_sinsemilla_merkle as jmerkle  # noqa: E402
import torch  # noqa: E402

from halo2_tpu.curves import Pallas as JPallas  # noqa: E402
from halo2_tpu.frontend import Circuit as JCircuit, Value as JValue  # noqa: E402
from halo2_tpu.gadgets import ecc_api as japi, sinsemilla as jsin  # noqa: E402
from halo2_tpu.gadgets import sinsemilla_fused as jsfused, sinsemilla_merkle as jsmerkle  # noqa: E402
from halo2_tpu.gadgets import sinsemilla_primitives as jprim  # noqa: E402
from halo2_tpu_torch import circuits  # noqa: E402
from halo2_tpu_torch.curves import Pallas  # noqa: E402
from halo2_tpu_torch.fields import Fp  # noqa: E402
from halo2_tpu_torch.frontend import Circuit, Value  # noqa: E402
from halo2_tpu_torch.gadgets import ecc_api as api, sinsemilla as sin  # noqa: E402
from halo2_tpu_torch.gadgets import sinsemilla_fused as sfused, sinsemilla_merkle as smerkle  # noqa: E402
from halo2_tpu_torch.gadgets import sinsemilla_primitives as prim  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


FIXTURE = os.path.join(TESTS, "fixtures_torch_sinsemilla.json")
K = prim.K
P = Fp.MODULUS


def _bits(rng, n):
    return [bool(rng.getrandbits(1)) for _ in range(n)]


# ---------------- host primitives ----------------


def test_s_table_matches_fixture_and_jax():
    S = prim.sinsemilla_s()
    assert len(S) == 1 << K
    with open(os.path.join(TESTS, "fixtures_sinsemilla_s.json")) as f:
        sampled = json.load(f)
    for j, (x, y) in sampled.items():
        assert S[int(j)].xy == (int(x, 16), int(y, 16)), j
    assert [pt.xy for pt in S] == [pt.xy for pt in jprim.sinsemilla_s()]
    assert len({pt.xy for pt in S}) == len(S)


def test_constants_and_padding_match_jax():
    assert (prim.K, prim.C, prim.Q_PERSONALIZATION, prim.S_PERSONALIZATION) == (
        jprim.K, jprim.C, jprim.Q_PERSONALIZATION, jprim.S_PERSONALIZATION)
    rng = random.Random(4)
    for n in (0, 1, K - 1, K, K + 1, 3 * K, 5 * K + 7):
        msg = _bits(rng, n)
        assert prim.pad(msg) == jprim.pad(msg)
        assert len(prim.pad(msg)) % K == 0
    for _ in range(8):
        word = _bits(rng, K)
        assert prim.lebs2ip_k(word) == jprim.lebs2ip_k(word)


@pytest.mark.parametrize("n_bits", [K, 2 * K + 3, 3 * K, 52 * K])
def test_hash_domain_matches_jax(n_bits):
    rng = random.Random(n_bits)
    msg = _bits(rng, n_bits)
    for name in ("sinsemilla-gadget-test", "z.cash:Orchard-MerkleCRH"):
        d, jd = prim.HashDomain(name), jprim.HashDomain(name)
        assert d.Q.xy == jd.Q.xy
        assert d.hash_to_point(msg).xy == jd.hash_to_point(msg).xy
        assert d.hash(msg) == jd.hash(msg)


def test_commit_domain_matches_jax():
    rng = random.Random(13)
    d, jd = prim.CommitDomain("test-commit"), jprim.CommitDomain("test-commit")
    assert (d.R.xy, d.M.Q.xy) == (jd.R.xy, jd.M.Q.xy)
    msg = _bits(rng, 2 * K)
    for r in (0, 1, rng.randrange(Pallas.SCALAR.MODULUS)):
        assert d.commit(msg, r).xy == jd.commit(msg, r).xy
        assert d.short_commit(msg, r) == jd.short_commit(msg, r)
    c5, c6 = d.commit(msg, 5), d.commit(msg, 6)
    assert c6 - c5 == d.R


def test_incomplete_addition_failures():
    g = Pallas.generator()
    assert prim.IncompletePoint(Pallas.identity()).add(g).pt is None
    assert prim.IncompletePoint(g).add(g).pt is None
    assert prim.IncompletePoint(g).add(-g).pt is None
    assert prim.IncompletePoint(g).add(g.mul(2)).pt == g.mul(3)


def test_merkle_layer_words_and_crh_match_jax():
    rng = random.Random(3)
    domain, jdomain = smerkle.merkle_crh_domain(), jsmerkle.merkle_crh_domain()
    for l in (0, 5, 31):
        left, right = rng.randrange(1 << 255), rng.randrange(1 << 255)
        words = smerkle.merkle_layer_words(l, left, right)
        assert words == jsmerkle.merkle_layer_words(l, left, right)
        assert len(words) == 52 and all(0 <= w < (1 << K) for w in words)
        msg = sum(w << (K * i) for i, w in enumerate(words))
        assert (msg & ((1 << K) - 1), (msg >> K) & ((1 << 255) - 1), msg >> (K + 255)) == (l, left, right)
        left, right = left % P, right % P
        assert smerkle.merkle_crh(domain, l, left, right) == jsmerkle.merkle_crh(jdomain, l, left, right)
    assert smerkle.merkle_layer_words(1, None, 2) == [None] * 52
    leaf, pos, path, root = circuits.merkle_inputs()
    assert root == jmerkle._host_root(leaf, pos, path)


def test_config4_message_is_golden_circuits_one():
    rng = random.Random(21)
    assert circuits.sinsemilla_bits() == _bits(rng, jgadget.NUM_WORDS * K)
    k, circ, instances, seed = circuits.sinsemilla_k14()
    assert (k, instances, seed, circuits.SINSEMILLA_DOMAIN, circuits.SINSEMILLA_NUM_WORDS) == (
        14, [], b"\x04" * 32, jgadget.DOMAIN, jgadget.NUM_WORDS)
    assert circuits.sinsemilla_k11()[0] == 11


# ---------------- circuits built the same way in both packages ----------------


def _bad_word_circuit(base, chip_cls, value_cls):
    class BadCircuit(base):
        """A word out of range fails the generator lookup."""

        def synthesize(self, config, layouter):
            chip = chip_cls(config)
            chip.load_table(layouter)
            chip.witness_message_words(layouter, [None])

            def in_region(region):
                region.enable_selector(config.q_lookup, 0)
                region.assign_advice(config.word_col, 0, value_cls.known(1 << K), "bad")
                region.assign_advice(config.x_s_col, 0, value_cls.known(1), "x")
                region.assign_advice(config.y_s_col, 0, value_cls.known(1), "y")

            layouter.assign_region("bad word", in_region)

    return BadCircuit


def _bad_fused_circuit(base, chip_cls, domain_cls):
    class Bad(base):
        """One corrupted word must violate the lookup or the secant gates."""

        def synthesize(self, config, layouter):
            chip = chip_cls(config)
            chip.load_table(layouter)
            domain = domain_cls(circuits.FUSED_DOMAIN)
            pieces = chip.witness_message(layouter, self.bits, circuits.FUSED_NUM_WORDS)
            pieces[0].words[3] ^= 1
            chip.hash_to_point(layouter, domain.Q, pieces)

    return Bad


def _commit_circuit(pkg):
    """The in-circuit CommitDomain against the host commit
    (tests/test_sinsemilla_gadget.py::test_commit_domain_in_circuit)."""
    circuit_cls, value_cls, api_mod, sin_mod, prim_mod, pallas = pkg
    domain = prim_mod.CommitDomain("test-commit")
    rng = random.Random(13)
    bits = _bits(rng, 2 * K)
    r = rng.randrange(1, pallas.SCALAR.MODULUS)
    expected = domain.commit(bits, r)

    class CommitCircuit(circuit_cls):
        def __init__(self, known=True):
            self.known = known

        def without_witnesses(self):
            return CommitCircuit(False)

        @classmethod
        def configure(cls, meta):
            advices = [meta.advice_column() for _ in range(10)]
            constants = meta.fixed_column()
            meta.enable_constant(constants)
            ecc_cfg = api_mod.EccGadgetConfig.configure(meta, advices)
            sin_advices = [meta.advice_column() for _ in range(3)]
            return ecc_cfg, sin_mod.SinsemillaChip.configure(meta, sin_advices, ecc_cfg.ecc)

        def synthesize(self, config, layouter):
            ecc_cfg, sin_cfg = config
            chip = sin_mod.SinsemillaChip(sin_cfg)
            chip.load_table(layouter)
            gadget = sin_mod.CommitDomainGadget(chip, api_mod.EccGadgetChip(ecc_cfg), domain)
            rv = value_cls.known(r) if self.known else value_cls.unknown()
            out = gadget.commit(layouter, bits if self.known else None, 2, rv)
            if self.known:
                assert out.point().force_value() == expected

    return CommitCircuit


PORT = (Circuit, Value, api, sin, prim, Pallas)
JAX = (JCircuit, JValue, japi, jsin, jprim, JPallas)


def _fused_bits(seed):
    random.seed(seed)
    return _bits(random, circuits.FUSED_NUM_WORDS * K)


def _merkle(circuit_cls):
    leaf, pos, path, root = circuits.merkle_inputs()
    return circuit_cls(leaf, pos, path, root)


# name -> (k, JAX circuit, port circuit)
PINNED = {
    "hash": (11, lambda: jgadget.SinsemillaCircuit(circuits.sinsemilla_bits()),
             lambda: circuits.SinsemillaCircuit(circuits.sinsemilla_bits())),
    "bad_word": (11, lambda: _bad_word_circuit(jgadget.SinsemillaCircuit, jsin.SinsemillaChip, JValue)(),
                 lambda: _bad_word_circuit(circuits.SinsemillaCircuit, sin.SinsemillaChip, Value)()),
    "commit_domain": (11, lambda: _commit_circuit(JAX)(), lambda: _commit_circuit(PORT)()),
    "fused": (11, lambda: jfused.FusedCircuit(_fused_bits(77)),
              lambda: circuits.FusedCircuit(_fused_bits(77))),
    "fused_bad": (11, lambda: _bad_fused_circuit(jfused.FusedCircuit, jsfused.SinsemillaFusedChip,
                                                 jprim.HashDomain)(_fused_bits(78)),
                  lambda: _bad_fused_circuit(circuits.FusedCircuit, sfused.SinsemillaFusedChip,
                                             prim.HashDomain)(_fused_bits(78))),
    "merkle": (11, lambda: _merkle(jmerkle.MerkleCircuit), lambda: _merkle(circuits.MerkleCircuit)),
}
FAILING = {"bad_word", "fused_bad"}

CS_CIRCUITS = {
    "hash": (circuits.SinsemillaCircuit, jgadget.SinsemillaCircuit),
    "fused": (circuits.FusedCircuit, jfused.FusedCircuit),
    "merkle": (circuits.MerkleCircuit, jmerkle.MerkleCircuit),
    "commit_domain": (lambda: _commit_circuit(PORT), lambda: _commit_circuit(JAX)),
}


@pytest.mark.parametrize("name", sorted(CS_CIRCUITS))
def test_constraint_system_matches_jax(name):
    port_cls, jax_cls = CS_CIRCUITS[name]
    if name == "commit_domain":
        port_cls, jax_cls = port_cls(), jax_cls()
    summary = port_cs(port_cls)
    assert summary == jax_cs(jax_cls)
    assert summary["lookups"] and summary["permutation"]


def _pinned():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(PINNED))
def test_mock_prover_matches_pinned_jax_record(name):
    k, _, port_circuit = PINNED[name]
    want = _pinned()[name]
    assert want["k"] == k and bool(want["failures"]) == (name in FAILING)
    assert {"k": k, **port_record(k, port_circuit())} == want


@pytest.mark.slow  # the JAX package's MockProver on every pinned case
def test_pinned_records_recomputed_from_jax():
    assert {name: {"k": k, **jax_record(k, make())} for name, (k, make, _) in PINNED.items()} == _pinned()


# ---------------- gating config 4 proved by the port ----------------


@pytest.mark.slow  # keygen and a proof at k = 11 on the CPU, about 10 minutes
def test_sinsemilla_k11_proof_has_the_pinned_bytes():
    """The port's plain path on the CPU gives the bytes that its kernels give
    on the card."""
    import chip_smoke

    from halo2_tpu_torch.curves import Vesta
    from halo2_tpu_torch.plonk.keygen import keygen_pk, keygen_vk
    from halo2_tpu_torch.plonk.prover import create_proof
    from halo2_tpu_torch.plonk.verifier import verify_proof
    from halo2_tpu_torch.poly.ipa import ParamsIPA
    from halo2_tpu_torch.transcript import Blake2bRead, Blake2bWrite
    from halo2_tpu_torch.utils.chacha import ChaCha20Rng

    k, circ, instances, seed = circuits.sinsemilla_k11()
    params = ParamsIPA.cached(Vesta, k, device="cpu")
    vk = keygen_vk(params, circ.without_witnesses())
    pk = keygen_pk(params, vk, circ.without_witnesses())
    t = Blake2bWrite(Vesta)
    create_proof(params, pk, [circ], [instances], ChaCha20Rng(seed), t)
    proof = t.finalize()
    assert hashlib.sha256(proof).hexdigest() == chip_smoke.SINSEMILLA_K11_PROOF_SHA256
    assert verify_proof(params, vk, [instances], Blake2bRead(Vesta, proof)) is True


@pytest.mark.slow  # over four hours on the CPU: XLA compiles the JAX package's prover
def test_sinsemilla_k11_pin_recomputed_from_jax():
    import chip_smoke

    assert _jax_sinsemilla_proof_sha256(11) == chip_smoke.SINSEMILLA_K11_PROOF_SHA256


def _jax_sinsemilla_proof_sha256(k: int) -> str:
    """Prove gating config 4 at 2^k rows with the JAX package; return the
    sha256 of the proof."""
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
    try:
        from golden_circuits import _prove_ipa

        from halo2_tpu.curves import Vesta
        from halo2_tpu.plonk.keygen import keygen_pk, keygen_vk
        from halo2_tpu.plonk.verifier import verify_proof
        from halo2_tpu.poly.ipa import ParamsIPA
        from halo2_tpu.transcript import Blake2bRead

        bits = circuits.sinsemilla_bits()
        params = ParamsIPA.cached(Vesta, k)
        vk = keygen_vk(params, jgadget.SinsemillaCircuit(None))
        pk = keygen_pk(params, vk, jgadget.SinsemillaCircuit(None))
        jax.clear_caches()
        proof = _prove_ipa(params, pk, [jgadget.SinsemillaCircuit(bits)], [[]], circuits.SINSEMILLA_SEED)
        jax.clear_caches()
        assert verify_proof(params, vk, [[]], Blake2bRead(Vesta, proof)) is True
        return hashlib.sha256(proof).hexdigest()
    finally:
        measure.span = base_span


if __name__ == "__main__":
    if sys.argv[1] == "pin":
        pin_cases(PINNED, FIXTURE)
        print("wrote", FIXTURE)
    else:
        print(_jax_sinsemilla_proof_sha256(int(sys.argv[1])))
