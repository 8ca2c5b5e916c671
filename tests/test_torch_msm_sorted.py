"""The port's sorted-bucket MSM (halo2_tpu_torch.ops.msm_sorted) against the
JAX package on the CPU.

On CPU tensors `msm_sorted_accum`, `msm_sorted_fold` and `msm_sorted_horner`
run their plain torch versions: the same stages, skip rule and additions that
the CUDA kernels run on the card. The oracles are the JAX package's recoding,
capacity classes, pre-stage overflow flag and host Pippenger (`msm_host`),
and its golden MulCircuit bytes. Scalars and bases are made from numpy seeds
and handed to both packages; points are compared as affine points, exactly.
"""

import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_tpu.curves import Pallas as JPallas, Vesta as JVesta
from halo2_tpu.ops import msm_sorted as jms
from halo2_tpu.ops.limbs import ints_to_limbs as jints_to_limbs
from halo2_tpu.ops.msm import msm_host as jmsm_host
from halo2_tpu_torch.circuits import MulCircuit
from halo2_tpu_torch.curves import Vesta
from halo2_tpu_torch.interop import curve_of, msm_bases, point
from halo2_tpu_torch.ops import msm as msm_mod
from halo2_tpu_torch.ops import msm_sorted as ms
from halo2_tpu_torch.ops.curve import CurveCtx, PointVec, _zero_reps, padd, pdouble
from halo2_tpu_torch.ops.field import ints_to_limbs
from halo2_tpu_torch.plonk.keygen import keygen_pk, keygen_vk
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.plonk.verifier import verify_proof
from halo2_tpu_torch.poly.ipa import ParamsIPA
from halo2_tpu_torch.transcript import Blake2bRead, Blake2bWrite
from halo2_tpu_torch.utils.chacha import ChaCha20Rng

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CURVES = pytest.mark.parametrize("jcurve", [JPallas, JVesta], ids=["Pallas", "Vesta"])


def rand_scalars(q: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % q for _ in range(n)]


def edge_scalars(q: int, n: int, seed: int):
    """n - 6 random scalars and the edges of tests/test_msm_sorted.py:
    0, 1, q - 1 (a carry through every window), 2^15 (a side-list digit in
    window 0, as -2^15 with a carry), a side-list digit in window 3, 2^16 - 1."""
    return rand_scalars(q, n - 6, seed) + [
        0, 1, q - 1, 1 << 15, ((1 << 15) << (16 * 3)) % q, (1 << 16) - 1]


def host_bases(jcurve, n: int, seed: int):
    """n affine points of the JAX package: random multiples of the generator."""
    rng = np.random.default_rng(seed)
    g = jcurve.generator()
    return [g.mul(int.from_bytes(rng.bytes(16), "little") + 1) for _ in range(n)]


def canon(vals) -> torch.Tensor:
    return torch.as_tensor(ints_to_limbs(vals))


def same_point(tp, jp) -> bool:
    if jp.is_identity():
        return tp.is_identity()
    return not tp.is_identity() and tp.xy == jp.xy


@CURVES
def test_recode_signed_matches_jax(jcurve):
    q = jcurve.SCALAR.MODULUS
    vals = edge_scalars(q, 70, seed=1) + [(1 << 255) % q, q - (1 << 15)]
    nw = ms._num_windows(q)
    got = ms._recode_signed(canon(vals), nw)
    want = np.asarray(jms._recode_signed(jnp.asarray(jints_to_limbs(vals)), nw))
    assert np.array_equal(got.numpy(), want)
    assert int(got.abs().max()) <= 1 << 15
    for i, v in enumerate(vals):
        assert sum(int(got[w, i]) << (16 * w) for w in range(nw)) == v


@pytest.mark.parametrize("n", [17, 300, (1 << 16) + 1, 1 << 20])
def test_windows_and_cap_classes_match_jax(n):
    for jcurve in (JPallas, JVesta):
        q = jcurve.SCALAR.MODULUS
        assert ms._num_windows(q) == jms._num_windows(q) == 16
        assert ms._cap_classes(n, ms.LANES, ms.KB, q) == jms._cap_classes(n, jms.DEF_W, jms.DEF_KB, q)
    assert (ms.LANES, ms.KB, ms.SIDE_CAP) == (jms.DEF_W, jms.DEF_KB, jms.SIDE_CAP)


@pytest.mark.parametrize("kind", ["edge", "all_equal"])
def test_prestage_sorts_by_lane_and_flags_like_jax(kind):
    """Every lane's run of entries holds exactly its points with the right
    bucket and sign, the side list holds the |e| = 2^15 points, zero digits
    are gone, and the overflow flag is the JAX pre-stage's."""
    q = JVesta.SCALAR.MODULUS
    n = 256
    vals = edge_scalars(q, n, seed=2) if kind == "edge" else [rand_scalars(q, 1, 3)[0]] * n
    nw = ms._num_windows(q)
    classes = ms._cap_classes(n, ms.LANES, ms.KB, q)
    entries, gstart, overflow = ms.prestage(canon(vals), nw, classes)
    e = ms._recode_signed(canon(vals), nw).numpy()
    for w in range(nw):
        got = {}
        for lane in range(ms.LANES + 1):
            for pos in range(int(gstart[w, lane]), int(gstart[w, lane + 1])):
                ent = int(entries[w, pos])
                got[ent >> 6] = (lane, ent & 31, (ent >> 5) & 1)
        want = {i: (abs(int(d)) // ms.KB, abs(int(d)) % ms.KB, int(d < 0))
                for i, d in enumerate(e[w]) if d != 0}
        assert got == want, w
    limbs = jnp.asarray(jints_to_limbs(vals))
    rows = jnp.zeros((n, 16), jnp.uint32)
    jflag = jms._prestage_fn(n, nw, classes, jms.DEF_W, jms.DEF_KB)(limbs, rows, rows)[-1]
    assert bool(overflow) == bool(np.asarray(jflag)) == (kind == "all_equal")


@pytest.mark.parametrize("n", [24, 70])
@CURVES
def test_sorted_msm_matches_jax_msm_host(jcurve, n):
    q = jcurve.SCALAR.MODULUS
    jpts = host_bases(jcurve, n + 1, seed=n)  # one base more than scalars
    vals = edge_scalars(q, n, seed=n + 1)
    got = ms.msm_sorted(canon(vals), msm_bases(jcurve, jpts))
    assert same_point(got, jmsm_host(vals, jpts[:n], jcurve))


@pytest.mark.parametrize("kind", ["all_equal", "all_small"])
def test_structured_scalars_overflow_and_msm_still_exact(kind, monkeypatch):
    """Structured scalars overflow a lane: msm_sorted raises BucketOverflow
    and msm() gives the exact result all the same, by the bucket MSM."""
    monkeypatch.setattr(msm_mod, "SORTED_MSM_MIN", 16)
    monkeypatch.setattr(msm_mod, "DEVICE_MSM_MIN", 16)
    monkeypatch.setattr(msm_mod, "ROUTES", msm_mod.Counter())
    q = JPallas.SCALAR.MODULUS
    n = 40
    jpts = host_bases(JPallas, n, seed=4)
    rng = np.random.default_rng(5)
    vals = ([rand_scalars(q, 1, 6)[0]] * n if kind == "all_equal"
            else [int(v) for v in rng.integers(1, ms.KB, n)])
    bases = msm_bases(JPallas, jpts)
    with pytest.raises(ms.BucketOverflow):
        ms.msm_sorted(canon(vals), bases)
    want = jmsm_host(vals, jpts, JPallas)
    assert same_point(msm_mod.msm(vals, bases, site="t"), want)
    route = "overflow" if kind == "all_equal" else "small_scalars"
    assert dict(msm_mod.ROUTES) == {("t", route): 1}


def test_msm_routes_large_scalars_to_sorted_and_selectors_past_it(monkeypatch):
    monkeypatch.setattr(msm_mod, "SORTED_MSM_MIN", 16)
    monkeypatch.setattr(msm_mod, "DEVICE_MSM_MIN", 16)
    monkeypatch.setattr(msm_mod, "ROUTES", msm_mod.Counter())
    q = JVesta.SCALAR.MODULUS
    n = 20
    jpts = host_bases(JVesta, n, seed=7)
    pts = [point(p) for p in jpts]
    big = rand_scalars(q, n, seed=8)
    selector = [i % 2 for i in range(n)]
    assert same_point(msm_mod.msm(big, pts, device="cpu", site="big"), jmsm_host(big, jpts, JVesta))
    assert same_point(msm_mod.msm(selector, pts, device="cpu", site="sel"),
                      jmsm_host(selector, jpts, JVesta))
    # below the threshold neither route is counted
    msm_mod.msm(big[:15], pts[:15], device="cpu", site="small_n")
    assert dict(msm_mod.ROUTES) == {("big", "sorted"): 1, ("sel", "small_scalars"): 1}


def test_mul_circuit_k4_golden_bytes_through_sorted_msm(monkeypatch):
    """With both thresholds below 2^4 + 1, keygen's sigma commits, the
    vanishing argument's random commit and the verifier's final MSM take the
    sorted MSM; the VK and proof bytes stay the JAX package's golden ones."""
    monkeypatch.setattr(msm_mod, "SORTED_MSM_MIN", 16)
    monkeypatch.setattr(msm_mod, "DEVICE_MSM_MIN", 16)
    monkeypatch.setattr(msm_mod, "ROUTES", msm_mod.Counter())
    golden = json.load(open(os.path.join(ROOT, "tests", "fixtures_golden.json")))
    params = ParamsIPA.cached(Vesta, 4, device="cpu")
    vk = keygen_vk(params, MulCircuit(7))
    pk = keygen_pk(params, vk, MulCircuit(7))
    assert hex(vk.transcript_repr) == golden["vk_transcript_repr"]
    c = 7 * 4 * 9
    tr = Blake2bWrite(Vesta)
    create_proof(params, pk, [MulCircuit(7, 2, 3)], [[[c]]], ChaCha20Rng(b"\x2a" * 32), tr)
    proof = tr.finalize()
    assert hashlib.sha256(proof).hexdigest() == golden["proof_sha256"]
    assert verify_proof(params, vk, [[[c]]], Blake2bRead(Vesta, proof)) is True
    routes = dict(msm_mod.ROUTES)
    for site in ("commit_lagrange", "commit", "MSMIPA.eval"):
        assert routes.get((site, "sorted"), 0) >= 1, routes
    assert not any(route == "overflow" for _, route in routes)


def test_k16_params_extend_the_k14_params():
    """The committed k = 16 params (written by the JAX package's
    ParamsIPA.cached(Vesta, 16)) share g[:2^14], w and u with the k = 14 file:
    both hash "Halo2-Parameters" to the curve, index by index."""
    k14 = open(os.path.join(ROOT, ".params_cache", "ipa-Vesta-k14.raw"), "rb").read()
    k16 = open(os.path.join(ROOT, ".params_cache", "ipa-Vesta-k16.raw"), "rb").read()
    n14, n16 = 1 << 14, 1 << 16
    assert int.from_bytes(k16[:4], "little") == 16 and len(k16) == 4 + 64 * (2 * n16 + 2)
    assert k16[4 : 4 + 64 * n14] == k14[4 : 4 + 64 * n14]
    assert k16[4 + 128 * n16 :] == k14[4 + 128 * n14 :]  # w, u
    curve = curve_of(JVesta)
    for i in (0, n16 - 1, 2 * n16 + 1):  # g[0], g[-1], u decode on the curve
        curve.from_bytes_uncompressed(k16[4 + 64 * i : 4 + 64 * (i + 1)])


def test_skip_rule_and_doubling():
    """The skip rule returns the other operand for an identity in any lazy
    form (0, p, 2p, 3p), and the doubling equals the addition to itself."""
    curve = curve_of(JVesta)
    cc = CurveCtx(curve)
    jpts = host_bases(JVesta, 3, seed=9)
    pv = cc.encode_points([point(p) for p in jpts], "cpu")
    assert [a.xy for a in cc.decode_points(pdouble(pv, cc))] == \
        [a.xy for a in cc.decode_points(padd(pv, pv, cc))]
    assert [a.xy for a in cc.decode_points(ms.dbl_skip(pv, cc))] == \
        [(p.mul(2)).xy for p in jpts]
    zero = _zero_reps(cc, "cpu")
    assert zero.shape[0] == 4  # 3p < 2^256 on Pasta
    ident = type(pv)(pv.x[:1].expand(4, 16), pv.y[:1].expand(4, 16), zero)
    a = type(pv)(*(t[1:2].expand(4, 16) for t in pv))
    for out in (ms.add_skip(a, ident, cc), ms.add_skip(ident, a, cc)):
        assert all(torch.equal(x, y) for x, y in zip(out, a))
    assert torch.equal(ms.dbl_skip(ident, cc).z, zero)
    added = ms.add_affine_skip(ident, pv.x[:1].expand(4, 16), pv.y[:1].expand(4, 16), cc)
    assert torch.equal(added.z, cc.fctx.one("cpu").expand(4, 16))


@pytest.mark.gpu
def test_sorted_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    q = JVesta.SCALAR.MODULUS
    n = 3000
    jpts = host_bases(JVesta, n, seed=10)
    vals = edge_scalars(q, n, seed=11)
    bases = msm_bases(JVesta, jpts, "cuda")
    cc = bases.cc
    px, py = bases.device_rows()
    entries, gstart, overflow = ms.prestage(canon(vals).cuda(), 16, ms._cap_classes(n, ms.LANES, ms.KB, q))
    assert not bool(overflow)
    bk = ms.msm_sorted_accum(entries, gstart, px, py, cc)
    wk = ms.msm_sorted_fold(bk, entries, gstart, px, py, cc)
    tk = ms.msm_sorted_horner(wk, cc)
    torch.cuda.synchronize()
    for got, want in (
        (bk, ms.msm_sorted_accum_plain(entries, gstart, px, py, cc)),
        (wk, ms.msm_sorted_fold_plain(bk, entries, gstart, px, py, cc)),
        (tk, ms.msm_sorted_horner_plain(wk, cc)),
    ):
        ctx = cc.fctx
        assert torch.equal(ctx.from_mont(got.reshape(-1, 16)), ctx.from_mont(want.reshape(-1, 16)))
    assert same_point(ms.msm_sorted(canon(vals).cuda(), bases), jmsm_host(vals, jpts, JVesta))


def horner_windows(case: str, device="cpu"):
    """16 projective window sums (16, 3, 16) of the port's Vesta for kernel 7's
    edge cases, and the host point sum_w 2^(16 w) W_w they must give."""
    g = Vesta.generator()
    rng = np.random.default_rng(sum(map(ord, case)))
    pts = [g.mul(int(rng.integers(1, 1 << 62))) for _ in range(16)]
    ident = Vesta.identity()
    if case == "identity_windows":  # the top window, a run below it and the bottom
        for w in (15, 14, 9, 8, 7, 0):
            pts[w] = ident
    elif case == "all_identity":
        pts = [ident] * 16
    elif case == "equal_windows":  # acc = 2^16 W_15 meets W_14 = 2^16 W_15: P + P
        pts[14] = pts[15].mul(1 << 16)
    elif case == "opposite_windows":  # acc = 2^16 W_15 meets -(2^16 W_15): the identity
        pts[14] = -pts[15].mul(1 << 16)
    cc = CurveCtx(Vesta)
    pv = cc.encode_points(pts, device)
    # projective: scale each point by its own lambda (Z != 1), and give one
    # identity the other zero representative Z = p
    lam = cc.fctx.consts([int(rng.integers(2, 1 << 62)) for _ in range(16)], device)
    wins = torch.stack([cc.fctx.mul(t, lam) for t in pv], dim=1)
    if case == "identity_windows":
        wins[9, 2] = torch.as_tensor(ints_to_limbs([Vesta.p()]))[0].to(device)
    want = ident
    for w in range(15, -1, -1):
        want = want.mul(1 << 16) + pts[w]
    return wins.contiguous(), want


HORNER_CASES = ("identity_windows", "all_identity", "equal_windows", "opposite_windows")


def test_horner_plain_edge_windows():
    """The plain Horner step (kernel 7's plain version) on identity, equal and
    opposite windows, against host point arithmetic: the four cases as one
    batch of chains, and the identity windows alone, which give the same limbs."""
    cc = CurveCtx(Vesta)
    cases = [horner_windows(case) for case in HORNER_CASES]
    got = ms.msm_sorted_horner_plain(torch.stack([w for w, _ in cases], 1), cc)
    assert cc.decode_points(PointVec(got[:, 0], got[:, 1], got[:, 2])) == [want for _, want in cases]
    assert torch.equal(ms.msm_sorted_horner_plain(cases[0][0], cc), got[0])


@pytest.mark.gpu
def test_horner_kernel_edge_windows_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    cc = CurveCtx(Vesta)
    for case in HORNER_CASES + ("random",):
        wins, _ = horner_windows(case, "cuda")
        got = ms.msm_sorted_horner(wins, cc)
        want = ms.msm_sorted_horner_plain(wins, cc)
        torch.cuda.synchronize()
        assert torch.equal(got, want), case
