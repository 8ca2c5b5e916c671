"""The port's bucket MSM (halo2_tpu_torch.ops.msm_bucket) against the JAX
package's host Pippenger (`halo2_tpu.ops.msm.msm_host`) on the CPU.

On CPU tensors `msm_accum`, `msm_fold` and `msm_lane_reduce` run their plain
torch versions: the same bucket pipeline, digit extraction and complete
additions that the CUDA kernels run on the card. Bases and scalars are made
from a seed and handed to both packages through `halo2_tpu_torch.interop`;
results are compared as affine points, exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_tpu.curves import Pallas as JPallas, Vesta as JVesta
from halo2_tpu.ops.field_jax import FieldCtx as JFieldCtx
from halo2_tpu.ops.msm import msm_host as jmsm_host
from halo2_tpu.poly.commitment import Blind as JBlind
from halo2_tpu.poly.ipa import ParamsIPA as JParamsIPA
from halo2_tpu_torch.curves import JAC_IDENTITY, jac_add, jac_double
from halo2_tpu_torch.interop import curve_of, limbs_tensor, msm_bases, point
from halo2_tpu_torch.ops import msm_bucket
from halo2_tpu_torch.ops.curve import CurveCtx, PointVec
from halo2_tpu_torch.ops.field import FieldCtx, ints_to_limbs
from halo2_tpu_torch.ops.msm import msm, msm_host
from halo2_tpu_torch.poly.commitment import Blind
from halo2_tpu_torch.poly.ipa import ParamsIPA

torch.set_num_threads(2)


def host_bases(jcurve, n: int, seed: int):
    """n distinct affine points of the JAX package: random multiples of the generator."""
    rng = np.random.default_rng(seed)
    g = jcurve.generator()
    return [g.mul(int.from_bytes(rng.bytes(16), "little") + 1) for _ in range(n)]


def scalars(q: int, M: int, n: int, seed: int):
    """M rows of n scalars < q; row 0 holds 0 and q - 1 among them."""
    rng = np.random.default_rng(seed)
    rows = [[int.from_bytes(rng.bytes(32), "little") % q for _ in range(n)] for _ in range(M)]
    rows[0][0] = 0
    rows[0][1 % n] = q - 1
    return rows


def same_point(tp, jp) -> bool:
    if jp.is_identity():
        return tp.is_identity()
    return not tp.is_identity() and tp.xy == jp.xy


@pytest.mark.parametrize("n", [4, 300])
@pytest.mark.parametrize("jcurve", [JPallas, JVesta], ids=["Pallas", "Vesta"])
def test_bucket_msm_matches_jax_msm_host(jcurve, n):
    q = jcurve.SCALAR.MODULUS
    M = 3
    jpts = host_bases(jcurve, n, seed=n)
    rows = scalars(q, M, n, seed=n + 1)
    bases = msm_bases(jcurve, jpts)
    canon = limbs_tensor(np.stack([ints_to_limbs(r) for r in rows]))
    got = msm_bucket.msm_bucket_many(canon, bases, mont=False)
    assert len(got) == M
    for r, tp in zip(rows, got):
        assert same_point(tp, jmsm_host(r, jpts, jcurve))
    # Montgomery input gives the same points
    sctx = FieldCtx(curve_of(jcurve).SCALAR)
    mont = torch.stack([sctx.consts(r, "cpu") for r in rows])
    got_m = msm_bucket.msm_bucket_many(mont, bases, mont=True)
    assert [p.xy for p in got_m] == [p.xy for p in got]


def _horner(wins, c, curve):
    p = curve.p()
    acc = JAC_IDENTITY
    for w in reversed(wins):
        for _ in range(c):
            acc = jac_double(acc, p)
        acc = jac_add(acc, w.jacobian(), p)
    return curve.from_jacobian(acc)


@pytest.mark.parametrize("c,T", [(4, 2), (8, 4)])
def test_bucket_stages_both_window_widths(c, T):
    """The three stages at c = 4 and at c = 8 (the main path takes c = 8 only
    from 2^15 points on), composed by hand and combined by Horner."""
    jcurve = JVesta
    curve = curve_of(jcurve)
    cc = CurveCtx(curve)
    q = jcurve.SCALAR.MODULUS
    n, M = 24, 2
    jpts = host_bases(jcurve, n, seed=5)
    rows = scalars(q, M, n, seed=6)
    nwin = -(-q.bit_length() // c)
    db = msm_bases(jcurve, jpts).device_tables(n, "cpu")
    scal = limbs_tensor(np.stack([ints_to_limbs(r) for r in rows])).transpose(1, 2).contiguous()
    buckets = msm_bucket.msm_accum(scal, db.px, db.py, c, nwin, T, cc)
    assert tuple(buckets.shape) == (M * nwin, 1 << c, 3, 16, T)
    parts = msm_bucket.msm_fold(buckets, cc)
    assert tuple(parts.shape) == (M * nwin, 3, 16, T)
    sums = msm_bucket.msm_lane_reduce(parts, cc)
    assert tuple(sums.shape) == (M * nwin, 3, 16)
    wins = cc.decode_points(PointVec(sums[:, 0], sums[:, 1], sums[:, 2]))
    for m, r in enumerate(rows):
        got = _horner(wins[m * nwin : (m + 1) * nwin], c, curve)
        assert same_point(got, jmsm_host(r, jpts, jcurve))


def test_bases_reject_identity_and_pad_with_generator():
    curve = curve_of(JVesta)
    pts = [point(p) for p in host_bases(JVesta, 3, seed=7)]
    db = msm_bucket.DeviceBases(curve, pts, 8, "cpu")
    assert tuple(db.px.shape) == (16, 8)
    g = curve.generator().xy
    r = FieldCtx(curve.BASE).r_int
    assert [int(v) for v in db.px[:, 7]] == list(ints_to_limbs([g[0] * r % curve.p()])[0])
    with pytest.raises(ValueError, match="affine"):
        msm_bucket.DeviceBases(curve, pts + [curve.identity()], 8, "cpu")


def test_msm_dispatch_drops_identity_bases():
    curve = curve_of(JPallas)
    jpts = host_bases(JPallas, 5, seed=8)
    pts = [point(p) for p in jpts]
    s = scalars(curve.SCALAR.MODULUS, 1, 6, seed=9)[0]
    want = jmsm_host(s[:5], jpts, JPallas)
    assert same_point(msm(s, pts + [curve.identity()], curve, device="cpu"), want)
    with pytest.raises(ValueError, match="device"):
        msm(s, pts, curve)
    assert same_point(msm_host(s[:5], pts, curve), want)


def test_commit_many_matches_jax_k4():
    jparams = JParamsIPA.cached(JVesta, 4)
    params = ParamsIPA.cached(curve_of(JVesta), 4, device="cpu")
    sctx = JFieldCtx(JVesta.SCALAR)
    q = JVesta.SCALAR.MODULUS
    rows = scalars(q, 3, 16, seed=10)
    stack = np.stack([np.asarray(sctx.encode_ints(r)) for r in rows])
    blinds = [11, 0, q - 5]
    for lagrange in (False, True):
        want = jparams.commit_many(jnp.asarray(stack), [JBlind(b) for b in blinds], lagrange)
        got = params.commit_many(limbs_tensor(stack), [Blind(b) for b in blinds], lagrange)
        assert all(same_point(t, j) for t, j in zip(got, want))


@pytest.mark.gpu
def test_bucket_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    jcurve = JVesta
    curve = curve_of(jcurve)
    cc = CurveCtx(curve)
    q = jcurve.SCALAR.MODULUS
    n, M = 512, 2
    jpts = host_bases(jcurve, n, seed=11)
    rows = scalars(q, M, n, seed=12)
    bases = msm_bases(jcurve, jpts, "cuda")
    for c in (4, 8):
        nwin = -(-q.bit_length() // c)
        db = bases.device_tables(n, "cuda")
        scal = limbs_tensor(np.stack([ints_to_limbs(r) for r in rows]), "cuda")
        scal = scal.transpose(1, 2).contiguous()
        bk = msm_bucket.msm_accum(scal, db.px, db.py, c, nwin, 128, cc)
        fk = msm_bucket.msm_fold(bk, cc)
        rk = msm_bucket.msm_lane_reduce(fk, cc)
        torch.cuda.synchronize()
        for got, want in (
            (bk, msm_bucket.msm_accum_plain(scal, db.px, db.py, c, nwin, 128, cc)),
            (fk, msm_bucket.msm_fold_plain(bk, cc)),
            (rk, msm_bucket.msm_lane_reduce_plain(fk, cc)),
        ):
            ctx = cc.fctx
            assert torch.equal(ctx.from_mont(got.reshape(-1, 16)), ctx.from_mont(want.reshape(-1, 16)))
    got = msm_bucket.msm_bucket_many(limbs_tensor(np.stack([ints_to_limbs(r) for r in rows]), "cuda"),
                                     bases, mont=False)
    for r, tp in zip(rows, got):
        assert same_point(tp, jmsm_host(r, jpts, jcurve))
