"""The reference tests of the main path that the port had no counterpart
for, run on the port on the CPU and held to the JAX package.

- The k = 5 plonk_api VK equals the Rust reference's pinned VK
  (tests/fixtures_plonk_api_vk.txt: params w, fixed and permutation
  commitments, the constraint system's shape, the domain, the pinned repr).
- Lookups, second-phase challenges and a shuffle, circuit params, the V1
  floor planner and equal fixed commitments (IPA, and KZG with SHPLONK and
  GWC): each circuit's VK transcript repr and proof sha256 equal the JAX
  package's (pinned below), the proof verifies, and the failure cases fail
  as the reference tests require; MockProver reports what the JAX package's
  MockProver reports.

The pins were made once on the CPU with

    PYTHONPATH=. JAX_PLATFORMS=cpu XLA_FLAGS=--xla_cpu_parallel_codegen_split_count=1 \\
        python tests/test_torch_parity.py

which proves every case with the JAX package and prints PINS; the `slow`
test recomputes them.
"""

import hashlib
import os
import random
import re
import sys

import pytest
import torch

from halo2_tpu_torch import circuits as pc
from halo2_tpu_torch.curves import Bn254G1, Vesta
from halo2_tpu_torch.dev.mock_prover import MockProver
from halo2_tpu_torch.fields import Fp, FrBn
from halo2_tpu_torch.frontend.floor_planner import RegionShape, _first_fit_region
from halo2_tpu_torch.plonk import ConstraintSystem
from halo2_tpu_torch.plonk.error import ConstraintSystemFailure, Error, OpeningError
from halo2_tpu_torch.plonk.expression import ADVICE, Column
from halo2_tpu_torch.plonk.keygen import keygen_pk, keygen_vk
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.plonk.verifier import verify_proof
from halo2_tpu_torch.poly.ipa import ParamsIPA
from halo2_tpu_torch.poly.kzg import ParamsKZG
from halo2_tpu_torch.transcript import Blake2bRead, Blake2bWrite, TranscriptError
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


SHUFFLE_A = [5, 9, 13, 21]
SHUFFLE_B = [13, 5, 21, 9]
SUM_VALUES = [5, 7, 11]
MUL_C = 7 * 4 * 9

# name -> (k, scheme, keygen circuit, proved circuit, instances, rng seed),
# each circuit a function of the package's circuit classes
CASES = {
    "lookup": (5, "ipa", lambda m: m.RangeCheckCircuit(None),
               lambda m: m.RangeCheckCircuit([1, 5, 7, 0, 3]), [], b"\x11" * 32),
    "shuffle": (5, "ipa", lambda m: m.ShuffleCircuit(None, None),
                lambda m: m.ShuffleCircuit(SHUFFLE_A, SHUFFLE_B), [], b"\x21" * 32),
    "shuffle_not_a_permutation": (5, "ipa", lambda m: m.ShuffleCircuit(None, None),
                                  lambda m: m.ShuffleCircuit(SHUFFLE_A, [13, 5, 21, 10]), [],
                                  b"\x22" * 32),
    "circuit_params": (4, "ipa", lambda m: m.SumCircuit(3, SUM_VALUES),
                       lambda m: m.SumCircuit(3, SUM_VALUES), [[sum(SUM_VALUES)]], b"\x11" * 32),
    "v1_floor_planner": (4, "ipa", lambda m: m.MulCircuitV1(7), lambda m: m.MulCircuitV1(7, 2, 3),
                         [[MUL_C]], b"\x03" * 32),
    "duplicate_fixed_ipa": (4, "ipa", lambda m: m.DupFixedCircuit(m.Fp, seed=3),
                            lambda m: m.DupFixedCircuit(m.Fp, seed=3), [], b"\x2a" * 32),
    "duplicate_fixed_kzg_shplonk": (4, "shplonk", lambda m: m.DupFixedCircuit(m.FrBn, seed=3),
                                    lambda m: m.DupFixedCircuit(m.FrBn, seed=3), [], b"\x2a" * 32),
    "duplicate_fixed_kzg_gwc": (4, "gwc", lambda m: m.DupFixedCircuit(m.FrBn, seed=3),
                                lambda m: m.DupFixedCircuit(m.FrBn, seed=3), [], b"\x2a" * 32),
}
KZG_PARAMS_SEED = 99  # ParamsKZG.setup(4, random.Random(99)), as the reference test
# name -> (hex VK transcript repr, proof sha256) of the JAX package (the command above)
PINS = {
    'lookup': ('0x32ba0aa3b8cae67b8c74497e7944f8ed418836365f4b66b7d0d4c669958c3bae', 'c41804197605ab6c3e8e550d45bab07efb5d3f154ad2d6de6686e9d3a85d47a3'),
    'shuffle': ('0x14143a5422e4c4bba252783ae6295b848f0f157bc0ec45c114576705197f46a1', 'd420287d5b07dad1b836e2cff35e47a6aebe35201bf5953e2e34edb4b8f8477a'),
    'shuffle_not_a_permutation': ('0x14143a5422e4c4bba252783ae6295b848f0f157bc0ec45c114576705197f46a1', 'b4841e2ffde6b2e3fd40907cf02ce64b4ee5f446424ae5788a3c1e561ae4a481'),
    'circuit_params': ('0x2749c4b19d01a72f28ce2c7269404cb077a43353990e305339d19e77a7603661', '9e8ac0830963da39561c851645ec21af775d1e1179f9889bf476b025917b1760'),
    'v1_floor_planner': ('0x392d3b99df66f047958ec81e8e8910112d1f3a838f2407835492c4239e41b7b', '5e84855b0ab210ec347259c170f8ed08a597c6349fc7c1ba8caa0abcf5fb67ad'),
    'duplicate_fixed_ipa': ('0x148ef25857905f6c0991d16c4d555d921e258a990d77cf6feed634238fb79ed8', 'a77cf50655c9ec7f77186b51a6e16cc9c99cd54f78e370155c976425e5839f48'),
    'duplicate_fixed_kzg_shplonk': ('0x2f35454f920f65827cc61703286bf5c952e483f16bfad20b0df4cbd620b9a6b6', 'f2cb85272e079849fb68d0f8fa4284c0c3fa0e15cfb27bc0f512eea3e76b6aec'),
    'duplicate_fixed_kzg_gwc': ('0x2f35454f920f65827cc61703286bf5c952e483f16bfad20b0df4cbd620b9a6b6', '0c3682b58b0cc5190a2b6d51de9d412f23333b887aaaf31514fceeede94c47af'),
}


class _PortCircuits:
    """The port's circuit classes under the names `CASES` uses."""

    RangeCheckCircuit = pc.RangeCheckCircuit
    ShuffleCircuit = pc.ShuffleCircuit
    SumCircuit = pc.SumCircuit
    MulCircuitV1 = pc.MulCircuitV1
    DupFixedCircuit = pc.DupFixedCircuit
    Fp = Fp
    FrBn = FrBn


def _port_params(k, scheme):
    if scheme == "ipa":
        return ParamsIPA.cached(Vesta, k, device="cpu")
    return ParamsKZG.setup(k, random.Random(KZG_PARAMS_SEED), device="cpu")


def _curve(scheme):
    return Vesta if scheme == "ipa" else Bn254G1


def _multiopen(scheme):
    return None if scheme == "ipa" else scheme


@pytest.fixture(scope="module")
def port_proofs():
    """name -> (params, vk, proof) of the port, each made once."""
    made, keys = {}, {}

    def get(name):
        if name not in made:
            k, scheme, keygen_circuit, circuit, instances, seed = CASES[name]
            key = (k, scheme, type(keygen_circuit(_PortCircuits)).__name__)
            if key not in keys:
                params = _port_params(k, scheme)
                vk = keygen_vk(params, keygen_circuit(_PortCircuits))
                keys[key] = params, vk, keygen_pk(params, vk, keygen_circuit(_PortCircuits))
            params, vk, pk = keys[key]
            t = Blake2bWrite(_curve(scheme))
            create_proof(params, pk, [circuit(_PortCircuits)], [instances], ChaCha20Rng(seed), t,
                         multiopen=_multiopen(scheme))
            made[name] = params, vk, t.finalize()
        return made[name]

    return get


def _verify(name, params, vk, proof, instances=None):
    k, scheme, _, _, case_instances, _ = CASES[name]
    return verify_proof(params, vk, [case_instances if instances is None else instances],
                        Blake2bRead(_curve(scheme), proof), multiopen=_multiopen(scheme))


@pytest.mark.parametrize("name", sorted(CASES))
def test_proof_matches_jax(port_proofs, name):
    params, vk, proof = port_proofs(name)
    assert (hex(vk.transcript_repr), hashlib.sha256(proof).hexdigest()) == PINS[name]
    if name == "shuffle_not_a_permutation":
        with pytest.raises((OpeningError, Error, TranscriptError, ValueError)):
            _verify(name, params, vk, proof)
    else:
        assert _verify(name, params, vk, proof) is True


def test_lookup_corrupt_proof_rejected(port_proofs):
    params, vk, proof = port_proofs("lookup")
    bad = bytearray(proof)
    bad[7] ^= 0x40
    with pytest.raises((OpeningError, Error, TranscriptError, ValueError)):
        _verify("lookup", params, vk, bytes(bad))


def test_lookup_out_of_range_witness_fails_to_prove(port_proofs):
    params, vk, _ = port_proofs("lookup")
    pk = keygen_pk(params, vk, pc.RangeCheckCircuit(None))
    with pytest.raises(ConstraintSystemFailure):
        create_proof(params, pk, [pc.RangeCheckCircuit([1, 200, 0, 0, 0])], [[]],
                     ChaCha20Rng(b"\x12" * 32), Blake2bWrite(Vesta))


def test_circuit_params_wrong_instance_fails_to_verify(port_proofs):
    params, vk, proof = port_proofs("circuit_params")
    with pytest.raises(OpeningError):
        _verify("circuit_params", params, vk, proof, [[sum(SUM_VALUES) + 1]])


def test_duplicate_fixed_commitments_are_equal_points(port_proofs):
    _, vk, _ = port_proofs("duplicate_fixed_ipa")
    assert len({c.xy for c in vk.fixed_commitments}) < len(vk.fixed_commitments)


# ---------------- MockProver on the same circuits, against the JAX package ----------------


def _jax_circuits():
    import test_circuit_params as tcp
    import test_duplicate_commitments as tdc
    import test_lookup_and_phases as tlp
    import test_v1_floor_planner as tv1

    from halo2_tpu.fields import Fp as JFp, FrBn as JFrBn

    class _JaxCircuits:
        RangeCheckCircuit = tlp.RangeCheckCircuit
        ShuffleCircuit = tlp.ShuffleCircuit
        SumCircuit = tcp.SumCircuit
        MulCircuitV1 = tv1.MulCircuitV1
        DupFixedCircuit = tdc.DupFixedCircuit
        Fp = JFp
        FrBn = JFrBn

    return _JaxCircuits


MOCK_CASES = {
    "lookup": (5, lambda m: m.RangeCheckCircuit([1, 5, 7, 0, 3]), [], True),
    "lookup_out_of_range": (5, lambda m: m.RangeCheckCircuit([1, 200, 0, 0, 0]), [], False),
    "shuffle": (5, lambda m: m.ShuffleCircuit(SHUFFLE_A, SHUFFLE_B), [], True),
    "shuffle_not_a_permutation": (5, lambda m: m.ShuffleCircuit(SHUFFLE_A, [13, 5, 21, 10]), [],
                                  False),
    "circuit_params_2": (4, lambda m: m.SumCircuit(2, [1, 2]), [[3]], True),
    "circuit_params_2_wrong": (4, lambda m: m.SumCircuit(2, [1, 2]), [[4]], False),
    "circuit_params_3": (4, lambda m: m.SumCircuit(3, [1, 2, 3]), [[6]], True),
    "circuit_params_3_wrong": (4, lambda m: m.SumCircuit(3, [1, 2, 3]), [[7]], False),
    "v1_floor_planner": (4, lambda m: m.MulCircuitV1(7, 2, 3), [[MUL_C]], True),
    "duplicate_fixed_poison_zero": (4, lambda m: m.DupFixedCircuit(m.Fp, seed=3), [], True),
}


@pytest.mark.parametrize("name", sorted(MOCK_CASES))
def test_mock_prover_matches_jax(name):
    from halo2_tpu.dev.mock_prover import MockProver as JMockProver

    k, circuit, instances, ok = MOCK_CASES[name]
    got = MockProver.run(k, circuit(_PortCircuits), instances, device="cpu").verify(vectorized=False)
    want = JMockProver.run(k, circuit(_jax_circuits()), instances).verify(vectorized=False)
    assert [(f.kind, str(f)) for f in got] == [(f.kind, str(f)) for f in want]
    assert (got == []) == ok
    if name.startswith("lookup"):
        assert ok or any(f.kind == "lookup" for f in got)


def test_circuit_params_change_circuit_shape():
    widths = {}
    for width in (2, 3):
        cs = ConstraintSystem()
        pc.SumCircuit.configure_with_params(cs, width)
        widths[width] = cs.num_advice_columns
    assert widths == {2: 2, 3: 3}


def test_v1_slot_in_reference_vector():
    """The reference's test_slot_in (v1/strategy.rs:228-265)."""

    def shape(idx, cols, rows):
        s = RegionShape(idx)
        s.columns = {("column", Column(ADVICE, c)) for c in cols}
        s.row_count = rows
        return s

    allocs, starts = {}, []
    for s in (shape(0, [0, 1], 15), shape(1, [2], 10), shape(2, [2, 0], 10)):
        cols = sorted(s.columns, key=lambda rc: (rc[1].index,))
        starts.append(_first_fit_region(allocs, cols, s.row_count, 0, None))
    assert starts == [0, 0, 15]


# ---------------- the k = 5 plonk_api VK against the Rust reference ----------------

_FIXTURE = open(os.path.join(os.path.dirname(__file__), "fixtures_plonk_api_vk.txt")).read()


def _pinned_points(section: str):
    block = _FIXTURE.split(section)[1]
    return [(int(x, 16), int(y, 16)) for x, y in re.findall(r"\(0x([0-9a-f]+), 0x([0-9a-f]+)\)", block)]


@pytest.fixture(scope="module")
def plonk_api_vk():
    _, _, lookup_table = pc.plonk_api_inputs()
    params = ParamsIPA.cached(Vesta, 5, device="cpu")
    return params, keygen_vk(params, pc.PlonkApiCircuit(None, lookup_table))


def test_plonk_api_vk_matches_rust_fixture(plonk_api_vk):
    params, vk = plonk_api_vk
    fixed = _pinned_points("fixed_commitments: [")
    assert (params.w.xy[0], params.w.xy[1]) == fixed[0]  # sf is never assigned: [1] W
    assert [(c.xy[0], c.xy[1]) if not c.is_identity() else (0, 0)
            for c in vk.fixed_commitments] == fixed[:7]
    assert [(c.xy[0], c.xy[1]) for c in vk.permutation.commitments] == \
        _pinned_points("permutation: VerifyingKey {")[:12]
    assert (vk.domain.k, vk.domain.extended_k) == (5, 7)
    assert vk.domain.omega == int(re.search(r"omega: 0x([0-9a-f]+)", _FIXTURE).group(1), 16)
    assert vk.pinned_repr(pretty=True) == _FIXTURE
    compact = vk.pinned_repr(pretty=False)
    assert "\n" not in compact and compact.startswith("PinnedVerificationKey {")


def test_plonk_api_cs_shape_matches_rust_fixture(plonk_api_vk):
    cs = plonk_api_vk[1].cs
    assert (cs.num_fixed_columns, cs.num_advice_columns, cs.num_instance_columns,
            cs.num_selectors) == (7, 5, 1, 0)
    assert [(c.index, r.i) for c, r in cs.advice_queries] == [
        (1, 0), (2, 0), (3, 0), (4, 1), (0, -1), (0, 0), (4, 0)]
    assert [(c.index, r.i) for c, r in cs.fixed_queries] == [
        (6, 0), (0, 0), (2, 0), (3, 0), (4, 0), (1, 0), (5, 0)]
    assert [(c.index, r.i) for c, r in cs.instance_queries] == [(0, 0)]
    assert [(c.kind, c.index) for c in cs.permutation.columns] == [
        ("advice", 1), ("advice", 2), ("advice", 3), ("fixed", 0), ("advice", 0), ("advice", 4),
        ("instance", 0), ("fixed", 1), ("fixed", 2), ("fixed", 3), ("fixed", 4), ("fixed", 5)]


# ---------------- the JAX package's values (the pins) ----------------


def _jax_pins():
    """name -> (hex VK transcript repr, proof sha256) of the JAX package."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from halo2_tpu.curves import Bn254G1 as JBn254G1, Vesta as JVesta
    from halo2_tpu.plonk.keygen import keygen_pk as jkeygen_pk, keygen_vk as jkeygen_vk
    from halo2_tpu.plonk.prover import create_proof as jcreate_proof
    from halo2_tpu.poly.ipa import ParamsIPA as JParamsIPA
    from halo2_tpu.poly.kzg import ParamsKZG as JParamsKZG
    from halo2_tpu.transcript import Blake2bWrite as JBlake2bWrite
    from halo2_tpu.utils.chacha import ChaCha20Rng as JChaCha20Rng

    m = _jax_circuits()
    out = {}
    for name, (k, scheme, keygen_circuit, circuit, instances, seed) in CASES.items():
        if scheme == "ipa":
            params = JParamsIPA.cached(JVesta, k)
        else:
            params = JParamsKZG.setup(k, random.Random(KZG_PARAMS_SEED))
        vk = jkeygen_vk(params, keygen_circuit(m))
        pk = jkeygen_pk(params, vk, keygen_circuit(m))
        t = JBlake2bWrite(JVesta if scheme == "ipa" else JBn254G1)
        jcreate_proof(params, pk, [circuit(m)], [instances], JChaCha20Rng(seed), t,
                      multiopen=_multiopen(scheme))
        out[name] = (hex(vk.transcript_repr), hashlib.sha256(t.finalize()).hexdigest())
        jax.clear_caches()
        print(name, out[name], file=sys.stderr, flush=True)
    return out


@pytest.mark.slow  # about 40 minutes: XLA compiles the JAX package's prover for each circuit
def test_pins_recomputed_from_jax():
    assert _jax_pins() == PINS


if __name__ == "__main__":
    sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    os.path.dirname(os.path.abspath(__file__))]
    print("PINS = {")
    for name, pin in _jax_pins().items():
        print(f"    {name!r}: {pin!r},")
    print("}")
