"""The bucket MSM's segmented fold (kernel 3's plain version,
`halo2_tpu_torch.ops.msm_bucket.msm_fold_plain`) against the fold it replaced,
and the bucket pipeline against the JAX package's `msm_host`, on the CPU.

The fold cuts each lane's 2^c buckets into segments and makes other additions
than the old serial running/total suffix sums, so the projective coordinates
differ: the two are compared as group elements (affine points). The old
formula is kept here as the reference.
"""

import numpy as np
import pytest
import torch

from halo2_tpu.curves import Vesta as JVesta
from halo2_tpu.ops.msm import msm_host as jmsm_host
from halo2_tpu_torch.curves import JAC_IDENTITY, Vesta, jac_add, jac_double
from halo2_tpu_torch.interop import curve_of, limbs_tensor, msm_bases
from halo2_tpu_torch.ops import msm_bucket
from halo2_tpu_torch.ops.curve import CurveCtx, PointVec, padd
from halo2_tpu_torch.ops.field import ints_to_limbs

torch.set_num_threads(2)

CC = CurveCtx(Vesta)


def old_fold(buckets: torch.Tensor, cc: CurveCtx) -> torch.Tensor:
    """The fold before the segments: per lane, run += S_b and total += run
    for b = B - 1 .. 1 with the complete addition."""
    B = buckets.shape[2]
    run = cc.identity_vec(buckets.shape[:2], buckets.device)
    total = run
    for b in range(B - 1, 0, -1):
        run = padd(run, PointVec(*buckets[:, :, b].unbind(-2)), cc)
        total = padd(total, run, cc)
    return msm_bucket._from_lane_major(total)


def decode(parts: torch.Tensor):
    pv = msm_bucket._to_lane_major(parts)  # (rows, T, 16) each
    return [p.xy for p in CC.decode_points(PointVec(*(t.reshape(-1, 16) for t in pv)))]


def bucket_tensor(occupied: np.ndarray, seed: int) -> torch.Tensor:
    """(rows, T, B, 3, 16) buckets: the exact identity where `occupied` is
    False, else one of a few random points with a random projective Z."""
    rows, T, B = occupied.shape
    rng = np.random.default_rng(seed)
    g = Vesta.generator()
    pool = CC.encode_points([g.mul(int(rng.integers(1, 1 << 62))) for _ in range(7)], "cpu")
    lam = CC.fctx.to_mont(torch.as_tensor(
        ints_to_limbs([int(rng.integers(1, 1 << 62)) for _ in range(rows * B * T)])))
    pick = torch.as_tensor(rng.integers(0, 7, size=rows * B * T))
    pts = PointVec(*(CC.fctx.mul(t[pick], lam) for t in pool))
    idv = CC.identity_vec((rows * B * T,), "cpu")
    occ = torch.as_tensor(occupied.reshape(-1))[:, None]
    pts = PointVec(*(torch.where(occ, p, i) for p, i in zip(pts, idv)))
    return torch.stack(list(pts), 1).reshape(rows, T, B, 3, 16)


def occupancy(case: str, B: int, rng) -> np.ndarray:
    rows, T = 2, 4
    occ = rng.random((rows, T, B)) < 0.6
    occ[:, :, 0] = False  # bucket 0 is the identity
    if case == "all_empty_lane":
        occ[0, 1] = False
        occ[1] = False
    elif case == "single_bucket":
        occ[:] = False
        occ[0, :, 5] = True
        occ[1, 2, B - 2] = True
    elif case == "top_only":
        occ[:] = False
        occ[:, :, B - 1] = True
    return occ


@pytest.mark.parametrize("case", ["random", "all_empty_lane", "single_bucket", "top_only"])
@pytest.mark.parametrize("c", [4, 8])
def test_segmented_fold_equals_old_fold(c, case):
    B = 1 << c
    occ = occupancy(case, B, np.random.default_rng(c * 10 + len(case)))
    buckets = bucket_tensor(occ, seed=c + len(case))
    want = decode(old_fold(buckets, CC))
    for l in sorted({msm_bucket.FOLD_LOG_SEGMENT[c], c - 3, min(c, 4)}):  # default, S = 8, L = 16
        assert decode(msm_bucket.msm_fold_plain(buckets, CC, l)) == want, f"l={l}"
    # the wrapper takes the default segment
    assert decode(msm_bucket.msm_fold(buckets, CC)) == want


def test_fold_rejects_bad_segments():
    buckets = bucket_tensor(np.zeros((1, 2, 16), dtype=bool), seed=0)
    for l in (-1, 5):
        with pytest.raises(ValueError, match="segment"):
            msm_bucket.msm_fold_plain(buckets, CC, l)
    with pytest.raises(ValueError, match="segment"):  # 256 buckets in 64 segments
        msm_bucket.msm_fold_plain(bucket_tensor(np.zeros((1, 1, 256), dtype=bool), seed=0), CC, 2)


def horner(wins, c):
    p = Vesta.p()
    acc = JAC_IDENTITY
    for w in reversed(wins):
        for _ in range(c):
            acc = jac_double(acc, p)
        acc = jac_add(acc, w.jacobian(), p)
    return Vesta.from_jacobian(acc)


@pytest.mark.parametrize("c", [4, 8])
def test_bucket_pipeline_edge_scalars_match_jax_msm_host(c):
    """Stages 1-3 at window width c on scalars that stress the edges: a zero
    row, q - 1, a lane whose points all share one digit, the top window's
    bits only, and the generator padding of the bases (digit 0)."""
    q = JVesta.SCALAR.MODULUS
    n, T = 21, 4  # n_pad = 24: three padded points
    rng = np.random.default_rng(c)
    g = JVesta.generator()
    jpts = [g.mul(int(rng.integers(1, 1 << 62))) for _ in range(n)]
    nwin = -(-q.bit_length() // c)
    top = (q.bit_length() - 1) // c * c  # first bit of the top window, below bit 254
    rows = [
        [0] * n,
        [q - 1] * 3 + [int.from_bytes(rng.bytes(32), "little") % q for _ in range(n - 3)],
        [(1 << c) - 1 if i % T == 1 else 3 for i in range(n)],  # lane 1: top bucket of window 0
        [int(rng.integers(1, 1 << (254 - top))) << top for _ in range(n)],
    ]
    db = msm_bases(JVesta, jpts).device_tables(24, "cpu")
    scal = limbs_tensor(np.stack([ints_to_limbs(r) for r in rows])).transpose(1, 2)
    scal = torch.nn.functional.pad(scal, (0, 24 - n)).contiguous()
    curve = curve_of(JVesta)
    cc = CurveCtx(curve)
    buckets = msm_bucket.msm_accum(scal, db.px, db.py, c, nwin, T, cc)
    sums = msm_bucket.msm_lane_reduce(msm_bucket.msm_fold(buckets, cc), cc)
    wins = cc.decode_points(PointVec(sums[:, 0], sums[:, 1], sums[:, 2]))
    for m, r in enumerate(rows):
        got = horner(wins[m * nwin : (m + 1) * nwin], c)
        want = jmsm_host(r, jpts, JVesta)
        assert (got.xy if not got.is_identity() else None) == (None if want.is_identity() else want.xy)


@pytest.mark.gpu
@pytest.mark.parametrize("M,n", [(3, (1 << 14) + 1), (2, 1 << 15)], ids=["c4-k14-commit", "c8-M2"])
def test_bucket_kernels_match_plain_on_card_at_main_path_shapes(M, n):
    """Kernels 2 and 3 against their plain versions, bit for bit, at the
    shapes `chip_smoke.py` times: c = 4 (the k = 14 commit) and c = 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    from halo2_tpu_torch.ops.msm import MSMBases

    rng = np.random.default_rng(n)
    g = Vesta.generator()
    pool = [g.mul(int(rng.integers(1, 1 << 62))) for _ in range(64)]
    bases = MSMBases(Vesta, [pool[i % 64] for i in range(n)], "cuda")
    c, nwin, T, n_pad = msm_bucket.msm_geometry(Vesta, n, "cuda")
    limbs = rng.integers(0, 1 << 16, size=(M, n_pad, 16), dtype=np.int64)
    limbs[..., 15] &= 0x3FFF
    limbs[:, n:] = 0
    limbs[0, : n // 2] = 0  # a zero half, as in an IPA round
    scal = torch.as_tensor(limbs.astype(np.int32), device="cuda").transpose(1, 2).contiguous()
    db = bases.device_tables(n_pad, "cuda")
    bk = msm_bucket.msm_accum(scal, db.px, db.py, c, nwin, T, CC)
    assert torch.equal(bk, msm_bucket.msm_accum_plain(scal, db.px, db.py, c, nwin, T, CC))
    assert torch.equal(msm_bucket.msm_fold(bk, CC), msm_bucket.msm_fold_plain(bk, CC))
