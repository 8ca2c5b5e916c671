"""The port's SHA-256 gadget on the CPU, held to the JAX package.

The host helpers (padding, the compression oracle, spread arithmetic, the
sigma coefficients) must equal the JAX package's and hashlib's; ShaCircuit
must give both packages the same constraint system, and both packages'
MockProver the same witness at k = 17 (the spread table has 2^16 rows). The
vectorised check at k = 17, satisfied and with a planted fault, is `slow`.

The card's workload, circuits.sha256_k17 (14 blocks of an 887-byte message
from random.Random(17), ChaCha20Rng(b"\\x05" * 32), Vesta params, Blake2b),
is proved by chip_smoke.py. Its verifying key's transcript repr is pinned
in tests/fixtures_torch_sha256.json from the JAX package's keygen_vk on the
CPU, written with

    MSM=host PYTHONPATH=. JAX_PLATFORMS=cpu \\
        XLA_FLAGS=--xla_cpu_parallel_codegen_split_count=1 python tests/test_torch_sha256.py vk

(`.params_cache/ipa-Vesta-k17.raw` must exist; MSM=host sends the commits to
the JAX package's native host MSM, the same group elements as its XLA MSM on
the CPU, which takes far longer at 2^17 points; a `slow` twin recomputes it).
The JAX package's proof at k = 17 is out of reach on the CPU.
"""

import json
import os
import random
import sys

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
sys.path[:0] = [p for p in (ROOT, TESTS) if p not in sys.path]

from test_torch_ecc import jax_cs, port_cs, witness_digest  # noqa: E402

import torch  # noqa: E402

from halo2_tpu.dev.mock_prover import MockProver as JMockProver  # noqa: E402
from halo2_tpu.frontend import Circuit as JCircuit  # noqa: E402
from halo2_tpu.gadgets import sha256 as jsha  # noqa: E402
from halo2_tpu_torch import circuits  # noqa: E402
from halo2_tpu_torch.dev.mock_prover import FailureLocation, MockProver  # noqa: E402
from halo2_tpu_torch.gadgets import sha256 as sha  # noqa: E402

FIXTURE = os.path.join(TESTS, "fixtures_torch_sha256.json")
MESSAGES = [b"", b"abc", b"a" * 55, b"a" * 56, b"a" * 100, bytes(range(256)),
            circuits.sha256_k17_message()]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


class JShaCircuit(JCircuit):
    """The JAX package's copy of `circuits.ShaCircuit` (the block count a
    parameter, which the JAX test's ShaCircuit fixes at one)."""

    def __init__(self, message=None, num_blocks=1):
        self.message = message
        self.num_blocks = num_blocks

    def without_witnesses(self):
        return type(self)(None, self.num_blocks)

    @classmethod
    def configure(cls, meta):
        constants = meta.fixed_column()
        meta.enable_constant(constants)
        return jsha.Table16Chip.configure(meta)

    def synthesize(self, config, layouter):
        chip = jsha.Table16Chip(config)
        chip.load_table(layouter)
        digest = jsha.Sha256(chip).digest_bytes(layouter, self.message, self.num_blocks)
        if self.message is not None:
            assert [d.value for d in digest] == circuits.sha256_digest_words(self.message)


# ---------------- host helpers ----------------


def test_tables_match_jax():
    assert (sha.IV, sha.ROUND_CONSTANTS, sha.MASK32, sha.BLOCK_SIZE, sha.DIGEST_SIZE, sha.P) == (
        jsha.IV, jsha.ROUND_CONSTANTS, jsha.MASK32, jsha.BLOCK_SIZE, jsha.DIGEST_SIZE, jsha.P)
    assert sha._SIGMA_DEFS == jsha._SIGMA_DEFS


@pytest.mark.parametrize("i", range(len(MESSAGES)))
def test_padding_and_compression_match_jax_and_hashlib(i):
    msg = MESSAGES[i]
    blocks = sha.sha256_pad(msg)
    assert blocks == jsha.sha256_pad(msg)
    assert len(blocks) == (len(msg) + 9 + 63) // 64
    assert sha.sha256_host_blocks(blocks) == jsha.sha256_host_blocks(blocks)
    assert sha.sha256_host_blocks(blocks) == circuits.sha256_digest_words(msg)


@pytest.mark.parametrize("x, y", [(0xBEEF, 0x1234), (0, 0xFFFF), (0xFFFF, 0xFFFF), (0xA5A5, 0x5A5A)])
def test_spread_even_odd_roundtrip(x, y):
    s = sha.spread_bits(x) + sha.spread_bits(y)
    assert s == jsha.spread_bits(x) + jsha.spread_bits(y)
    even, odd = sha.even_odd_bits(s, 16)
    assert (even, odd) == jsha.even_odd_bits(s, 16)
    assert even == x ^ y
    assert odd == x & y


@pytest.mark.parametrize("name", sorted(jsha._SIGMA_DEFS))
def test_sigma_coeffs_and_host_match_jax(name):
    """The spread-space sum with the derived coefficients has the sigma value
    as its even bit plane, and both packages agree on coefficients and value."""
    widths, rots, shifts = sha._SIGMA_DEFS[name]
    coeffs = sha._sigma_coeffs(widths, rots, shifts)
    assert coeffs == jsha._sigma_coeffs(widths, rots, shifts)
    rng = random.Random(5)
    for _ in range(20):
        x = rng.randrange(1 << 32)
        total, off = 0, 0
        for w, c in zip(widths, coeffs):
            total += sha.spread_bits((x >> off) & ((1 << w) - 1), w) * c
            off += w
        even, _odd = sha.even_odd_bits(total, 32)
        assert even == sha._sigma_host(x, name) == jsha._sigma_host(x, name)


def test_sha256_k17_workload():
    """The card's message pads to 14 blocks, the most that fit at k = 17."""
    k, circ, instances, seed = circuits.sha256_k17()
    assert (k, instances, seed) == (17, [], b"\x05" * 32)
    assert len(circ.message) == 887 and circ.num_blocks == 14
    assert len(sha.sha256_pad(circ.message)) == 14
    assert circ.without_witnesses().num_blocks == 14


# ---------------- the circuit ----------------


def test_constraint_system_matches_jax():
    port = port_cs(circuits.ShaCircuit)
    assert port == jax_cs(JShaCircuit)
    assert port["columns"][:3] == [9, 6, 0]
    assert [g[0] for g in port["gates"]] == ["linear combination"]
    assert [lk[0] for lk in port["lookups"]] == ["spread range"]
    assert port["degree"] == 7


def test_witness_at_k17_matches_jax():
    """MockProver.run of one block (b"abc") assigns the same cells, copies
    and challenges in both packages; the digest check in synthesize holds."""
    port = MockProver.run(17, circuits.ShaCircuit(b"abc"), [], device="cpu")
    jax = JMockProver.run(17, JShaCircuit(b"abc"), [])
    assert witness_digest(port) == witness_digest(jax)
    assert len(port.regions) == len(jax.regions)


def test_wrong_digest_is_caught_in_synthesize(monkeypatch):
    monkeypatch.setattr(circuits, "sha256_digest_words", lambda m: [0] * 8)
    with pytest.raises(AssertionError):
        MockProver.run(17, circuits.ShaCircuit(b"abc"), [], device="cpu")


@pytest.mark.slow  # about 20 s each side: the vectorised check over 2^17 rows on the CPU
def test_vectorised_check_at_k17_with_a_planted_fault():
    prover = MockProver.run(17, circuits.ShaCircuit(b"abc"), [], device="cpu")
    assert prover.verify(vectorized=True) == []
    # the JAX test's plant: the first advice-0 cell that is not 0 or 1, plus one
    for row, v in enumerate(prover.advice[0]):
        if isinstance(v, tuple) and v[0] == "assigned" and v[1] not in (0, 1):
            prover.advice[0][row] = ("assigned", (v[1] + 1) % prover.p)
            break
    failures = prover.verify(vectorized=True)
    assert failures
    where = f"[{FailureLocation.find(prover.regions, row)}]"
    assert any(where in str(f) for f in failures)


# ---------------- the VK pin ----------------


def _jax_vk_repr() -> str:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from halo2_tpu.curves import Vesta as JVesta
    from halo2_tpu.plonk.keygen import keygen_vk as jkeygen_vk
    from halo2_tpu.poly.ipa import ParamsIPA as JParamsIPA

    k, circ, _, _ = circuits.sha256_k17()
    params = JParamsIPA.cached(JVesta, k)
    return hex(jkeygen_vk(params, JShaCircuit(None, circ.num_blocks)).transcript_repr)


def pinned_vk_repr():
    """The JAX package's VK transcript repr of sha256_k17, or None before it
    has been pinned."""
    if not os.path.exists(FIXTURE):
        return None
    with open(FIXTURE) as f:
        return json.load(f).get("vk_k17_transcript_repr")


@pytest.mark.slow  # about 5 min: keygen_vk of 14 blocks at k = 17, its commits on msm_host
def test_port_vk_has_the_pinned_jax_repr(monkeypatch):
    """The card's check of the VK, on the CPU: the port's keygen_vk of the
    card's workload gives the JAX package's transcript repr."""
    from halo2_tpu_torch.curves import Vesta
    from halo2_tpu_torch.plonk.keygen import keygen_vk
    from halo2_tpu_torch.poly.ipa import ParamsIPA

    monkeypatch.setenv("MSM", "host")
    k, circ, _, _ = circuits.sha256_k17()
    vk = keygen_vk(ParamsIPA.cached(Vesta, k, device="cpu"), circ.without_witnesses())
    assert hex(vk.transcript_repr) == pinned_vk_repr()


@pytest.mark.slow  # keygen_vk of 14 blocks at k = 17 by the JAX package on the CPU
def test_pinned_vk_recomputed_from_jax(monkeypatch):
    monkeypatch.setenv("MSM", "host")
    assert pinned_vk_repr() is not None
    assert _jax_vk_repr() == pinned_vk_repr()


if __name__ == "__main__":
    if sys.argv[1:] != ["vk"]:
        sys.exit("usage: python tests/test_torch_sha256.py vk")
    repr_hex = _jax_vk_repr()
    with open(FIXTURE, "w") as f:
        json.dump({"vk_k17_transcript_repr": repr_hex}, f, indent=1)
        f.write("\n")
    print(repr_hex)
