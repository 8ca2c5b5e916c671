"""The sorted MSM's pre-stage, accumulation and fold (halo2_tpu_torch.ops.
msm_sorted, kernels 5 and 6) on the CPU, at small n.

The pre-stage sorts each window's points by bucket and then by index; the
accumulation must still give the buckets of the first port bit for bit (its
schedule, one lane at a time in ascending index, is kept here as the
reference); the fold makes other additions than the first port's scans, so
its window sums are compared as group elements with sum_b b * S_b +
2^15 * side computed on host points from the same bucket tensor. The whole
MSM is held to the JAX package's `msm_host`. Scalars and bases come from
numpy seeds.
"""

import numpy as np
import pytest
import torch

from halo2_tpu.curves import Pallas as JPallas, Vesta as JVesta
from halo2_tpu.ops.msm import msm_host as jmsm_host
from halo2_tpu_torch.interop import curve_of, msm_bases
from halo2_tpu_torch.ops import msm_sorted as ms
from halo2_tpu_torch.ops.curve import PointVec, add_affine_skip, pick, put
from halo2_tpu_torch.ops.field import NLIMBS, ints_to_limbs
from halo2_tpu_torch.ops.msm import msm_host

torch.set_num_threads(2)

CURVES = {"Pallas": JPallas, "Vesta": JVesta}


def host_bases(jcurve, n: int, seed: int):
    rng = np.random.default_rng(seed)
    g = jcurve.generator()
    return [g.mul(int.from_bytes(rng.bytes(16), "little") + 1) for _ in range(n)]


def scalars(kind: str, q: int, n: int, seed: int):
    """n scalars below q: uniform; uniform with the edges 0, 1, q - 1, 2^15
    (a side-list digit in window 0), a side-list digit in window 3 and
    2^16 - 1; below 2^128 (windows 9-15 empty, window 8 at most a carry);
    all zero; or top-window-heavy (q - 1 minus 200 random bits: every point
    in one bucket of window 15 and few buckets of window 12-14)."""
    rng = np.random.default_rng(seed)

    def below(bits):
        return [int.from_bytes(rng.bytes(32), "little") % (1 << bits) for _ in range(n)]

    if kind == "uniform":
        return [v % q for v in below(256)]
    if kind == "edge":
        return [v % q for v in below(256)][: n - 6] + [
            0, 1, q - 1, 1 << 15, ((1 << 15) << (16 * 3)) % q, (1 << 16) - 1]
    if kind == "below_2^128":
        return below(128)
    if kind == "zero":
        return [0] * n
    assert kind == "top_heavy"
    return [q - 1 - v for v in below(200)]


def stages(jcurve, kind: str, n: int, seed: int):
    curve = curve_of(jcurve)
    q = curve.SCALAR.MODULUS
    vals = scalars(kind, q, n, seed)
    bases = msm_bases(jcurve, host_bases(jcurve, n, seed + 1))
    canon = torch.as_tensor(ints_to_limbs(vals))
    entries, gstart, _ = ms.prestage(canon, 16, ms._cap_classes(n, ms.LANES, ms.KB, q))
    px, py = bases.device_rows("cpu")
    return vals, bases, canon, entries, gstart, px, py


def parent_accum(canon, px, py, cc):
    """The first port's accumulation: entries sorted by (lane, index), each
    (window, lane) adding its points in that order into its KB buckets."""
    n = canon.shape[0]
    e = ms._recode_signed(canon, 16).long()
    lane = torch.where(e == 0, ms.LANES + 1, e.abs() // ms.KB)
    key = torch.sort((lane << 21) | torch.arange(n), dim=1).values
    order = key & ((1 << 21) - 1)
    gstart = torch.searchsorted((key >> 21).contiguous(),
                                torch.arange(ms.LANES + 2).expand(16, ms.LANES + 2).contiguous())
    es = torch.gather(e, 1, order)
    entries = (order << 6) | ((es < 0).long() << 5) | (es.abs() % ms.KB)
    b = cc.identity_vec((16 * ms.LANES * ms.KB,), "cpu")
    start = gstart[:, : ms.LANES]
    cnt = gstart[:, 1 : ms.LANES + 1] - start
    for r in range(int(cnt.max())):
        w, ln = (cnt > r).nonzero(as_tuple=True)
        ent = entries[w, start[w, ln] + r]
        x, y = ms._base(px, py, ent >> 6, (ent >> 5) & 1, cc)
        flat = (w * ms.LANES + ln) * ms.KB + (ent & (ms.KB - 1))
        put(b, flat, add_affine_skip(pick(b, flat), x, y, cc))
    return torch.stack(list(b), -2).reshape(16, ms.LANES, ms.KB, 3, NLIMBS)


def host_window_sums(buckets, entries, gstart, bases):
    """sum_b b * S_b + 2^15 * (-sum of the side list) per window, on host
    points decoded from the buckets that hold one."""
    cc, curve = bases.cc, bases.curve
    flat = buckets.reshape(16, -1, 3, NLIMBS)
    out = []
    for w in range(16):
        occ = (flat[w, :, 2] != 0).any(-1).nonzero(as_tuple=True)[0]
        pts = cc.decode_points(PointVec(*flat[w, occ].unbind(-2)))
        weights = occ.tolist()
        beg, end = int(gstart[w, ms.LANES]), int(gstart[w, ms.LANES + 1])
        for pos in range(beg, min(end, beg + ms.SIDE_CAP)):
            pts.append(-bases.host_points[int(entries[w, pos]) >> 6])
            weights.append(1 << 15)
        out.append(msm_host(weights, pts, curve))
    return out


@pytest.mark.parametrize("curve,n", [("Pallas", 70), ("Vesta", 300)])
def test_prestage_sorts_each_lane_by_bucket_then_index(curve, n):
    """Per window the kept entries are exactly the nonzero digits, in strictly
    ascending (|e|, index), so each lane's run is sorted by bucket and then
    by index; each entry carries its digit's bucket and sign, and gstart
    puts it in its lane (lane W: the side list)."""
    _, _, canon, entries, gstart, _, _ = stages(CURVES[curve], "edge", n, seed=n)
    e = ms._recode_signed(canon, 16).long()
    for w in range(16):
        m = int(gstart[w, ms.LANES + 1])
        assert m == int((e[w] != 0).sum())
        run = entries[w, :m].long()
        src = run >> 6
        d = e[w, src]
        key = d.abs() * n + src
        assert bool((key[1:] > key[:-1]).all())
        assert torch.equal(run & (ms.KB - 1), d.abs() % ms.KB)
        assert torch.equal((run >> 5) & 1, (d < 0).long())
        pos = torch.arange(m, dtype=torch.int32)
        lane = torch.searchsorted(gstart[w].contiguous(), pos, right=True) - 1
        assert torch.equal(lane.long(), d.abs() // ms.KB)


@pytest.mark.parametrize("curve,n", [("Pallas", 70), ("Vesta", 300)])
def test_accum_plain_is_the_first_ports_buckets_bit_for_bit(curve, n):
    _, bases, canon, entries, gstart, px, py = stages(CURVES[curve], "edge", n, seed=n + 5)
    got = ms.msm_sorted_accum(entries, gstart, px, py, bases.cc)
    assert torch.equal(got, parent_accum(canon, px, py, bases.cc))


@pytest.mark.parametrize("curve,kind,n", [
    ("Vesta", "uniform", 300), ("Pallas", "edge", 70), ("Vesta", "below_2^128", 70),
    ("Pallas", "zero", 70), ("Vesta", "top_heavy", 70)])
def test_fold_plain_is_the_weighted_bucket_sum(curve, kind, n):
    _, bases, _, entries, gstart, px, py = stages(CURVES[curve], kind, n, seed=n + 9)
    buckets = ms.msm_sorted_accum(entries, gstart, px, py, bases.cc)
    wins = ms.msm_sorted_fold(buckets, entries, gstart, px, py, bases.cc)
    got = bases.cc.decode_points(PointVec(*wins.unbind(-2)))
    assert got == host_window_sums(buckets, entries, gstart, bases)
    if kind in ("below_2^128", "zero"):
        assert all(p.is_identity() for p in got[9 if kind != "zero" else 0 :])


@pytest.mark.parametrize("geometry", [(2, 256), (5, 32)])
def test_fold_plain_other_geometries_same_sums(geometry, monkeypatch):
    """The extremes of the geometries msm_ab.py sweeps: other additions, the
    same group elements."""
    _, bases, _, entries, gstart, px, py = stages(JVesta, "edge", 24, seed=11)
    buckets = ms.msm_sorted_accum(entries, gstart, px, py, bases.cc)
    want = bases.cc.decode_points(PointVec(*ms.msm_sorted_fold(
        buckets, entries, gstart, px, py, bases.cc).unbind(-2)))
    monkeypatch.setattr(ms, "FOLD_GEOMETRY", geometry)
    got = bases.cc.decode_points(PointVec(*ms.msm_sorted_fold(
        buckets, entries, gstart, px, py, bases.cc).unbind(-2)))
    assert got == want


@pytest.mark.parametrize("geometry", [(1, 128), (4, 96), (5, 16), (3, 64)])
def test_fold_rejects_geometries_without_1_to_32_blocks(geometry, monkeypatch):
    monkeypatch.setattr(ms, "FOLD_GEOMETRY", geometry)
    with pytest.raises(ValueError):
        ms._fold_geometry()


def test_msm_sorted_matches_jax_msm_host_at_300():
    vals, bases, canon, *_ = stages(JPallas, "edge", 300, seed=21)
    jpts = host_bases(JPallas, 300, seed=22)
    got = ms.msm_sorted(canon, bases)
    want = jmsm_host(vals, jpts, JPallas)
    assert got.xy == want.xy


@pytest.mark.gpu
def test_sorted_kernels_match_plain_on_card_below_2_127():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    n = 3000
    rng = np.random.default_rng(23)
    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.int64)
    limbs[:, 7] %= 0x7FFF
    limbs[:, 8:] = 0
    limbs[:5] = 0
    canon = torch.as_tensor(limbs.astype(np.int32), device="cuda")
    bases = msm_bases(JVesta, host_bases(JVesta, n, seed=24), "cuda")
    cc = bases.cc
    px, py = bases.device_rows()
    q = JVesta.SCALAR.MODULUS
    entries, gstart, _ = ms.prestage(canon, 16, ms._cap_classes(n, ms.LANES, ms.KB, q))
    bk = ms.msm_sorted_accum(entries, gstart, px, py, cc)
    wk = ms.msm_sorted_fold(bk, entries, gstart, px, py, cc)
    torch.cuda.synchronize()
    assert torch.equal(bk, ms.msm_sorted_accum_plain(entries, gstart, px, py, cc))
    ctx = cc.fctx
    assert torch.equal(ctx.from_mont(wk.reshape(-1, 16)),
                       ctx.from_mont(ms.msm_sorted_fold_plain(bk, entries, gstart, px, py, cc)
                                     .reshape(-1, 16)))
