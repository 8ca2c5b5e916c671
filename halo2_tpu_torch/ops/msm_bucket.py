"""Bucket (Pippenger) MSM over shared affine bases: kernels 2-4.

Counterpart of `halo2_tpu/ops/msm_pallas.py`. M MSMs share one base table;
each scalar is cut into nwin unsigned c-bit windows (c = 4 below 2^15
points, else 8) read straight from its canonical 16-bit limbs. Three stages,
each a hand-written CUDA kernel (`csrc/msm_bucket.cu`) with a plain torch
version beside it that computes the same tensors:

1. `msm_accum` (replaces `_accum_fn`): row = (msm, window), T lanes per
   row; lane t owns 2^c buckets and adds base i (i = t mod T) into bucket
   digit_i with the complete mixed addition, from the identity, in ascending
   i. Digit 0 is skipped, so bucket 0 stays the identity. The kernel sorts a
   block's digits by bucket and sums each bucket in registers; the additions
   per bucket and their order are the plain version's, so the bucket tensor
   is bit for bit the same.
2. `msm_fold` (replaces `_fold_fn`): per lane sum_b b * S_b, cut into
   S = 2^c / L segments of L = 2^l buckets (`FOLD_LOG_SEGMENT`): in each a
   running/total suffix sum gives W_j = sum_r r * S_{jL+r} and Sum_j; then
   sum_b b * S_b = sum_j W_j + L * sum_{j >= 1} U_j with U_j = sum_{i >= j}
   Sum_i, by a suffix scan over segments, l doublings and a tree. Every
   addition follows the skip rule (`ops/curve.py` add_skip): the plain version
   makes the kernel's additions in the kernel's order, with the segments as
   a batch dimension.
3. `msm_lane_reduce` (replaces `_lane_reduce_fn`): tree sum of the T lane
   partials of each row (T a power of two): at level s = T/2, ..., 1, lane
   i < s takes the complete addition of lanes i and i + s. The kernel runs
   each addition on 4 lanes of a warp at the first level and on 8 at the
   others, and gives the plain version's coordinates bit for bit.

The window sums come back to the host once (`CurveCtx.decode_points`) and
are combined by Horner over windows with c doublings per step, as
`msm_pallas.py:447-456` does. On CUDA a row has T = 128 lanes. The plain
versions run the same stages with at most 8 lanes on the CPU: there a lane
is no thread, and every lane adds its fold's additions, which 128 lanes
would make the bulk of a small MSM's work.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; it counts one launch in `LAUNCHES` per call (each
is one kernel launch). None of the kernels has a library counterpart: no
PyTorch call computes a bucket MSM.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Type

import torch

from ..curves import JAC_IDENTITY, Curve, Point, jac_add, jac_double
from . import _build
from .curve import CurveCtx, PointVec, add_skip, dbl_skip, padd, padd_mixed
from .field import NLIMBS, FieldCtx, from_mont, ints_to_limbs

LANES = 128
CPU_LANES = 8
# Kernel 2 gives a block about this many points (G lanes of n_pad / T points),
# in at most ACCUM_SMEM_TARGET bytes of shared memory where G > 1 allows, so
# that three blocks fit an H100 SM; no block can have more than ACCUM_SMEM_MAX.
ACCUM_POINTS_PER_BLOCK = 16384
ACCUM_SMEM_TARGET = 75 * 1024
ACCUM_SMEM_MAX = 232448
# log2 of the fold's segment length L per window width c.
FOLD_LOG_SEGMENT = {4: 4, 8: 5}
# Threads a block of kernel 4 (a row a block; 4 lanes an addition at the
# first level, 8 at the others; from `tools/msm_ab.py --sweep`).
LANE_REDUCE_THREADS = 256
LAUNCHES = {"msm_accum": 0, "msm_fold": 0, "msm_lane_reduce": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {
    "msm_accum": (_P, _P, _P, _P, _I, _I, ctypes.c_longlong, _I, _I, _I, _P, _P),
    "msm_fold": (_P, _P, _I, _I, _I, _I, _P, _P),
    "msm_lane_reduce": (_P, _P, _I, _I, _I, _P, _P),
}


def msm_geometry(curve: Type[Curve], n: int, device):
    """(c, nwin, T, n_pad) for an MSM over n points on `device`."""
    bits = curve.SCALAR.MODULUS.bit_length()
    c = 8 if n >= (1 << 15) else 4
    nwin = (bits + c - 1) // c
    if torch.device(device).type == "cuda":
        T = LANES
    else:  # about 8 points per lane, at most CPU_LANES lanes
        T = min(CPU_LANES, 1 << (max(1, n // 8) - 1).bit_length())
    n_pad = ((n + T - 1) // T) * T
    return c, nwin, T, n_pad


def _consts(cc: CurveCtx):
    return _build.field_consts(cc.fctx.p_int, cc.b3_mont)


# ---------------- layout helpers ----------------
# buckets (rows, T, B, 3, 16) keep each bucket's 48 limbs together, so a
# thread of kernel 2 writes a bucket as 192 contiguous bytes and a thread of
# kernel 3 reads it so; parts (rows, 3, 16, T) keep lanes innermost. The plain
# versions work on (..., T, 16) point tensors and convert.


def _to_lane_major(t: torch.Tensor) -> PointVec:
    """(..., 3, 16, T) -> PointVec of (..., T, 16)."""
    t = t.transpose(-1, -2)
    return PointVec(t[..., 0, :, :], t[..., 1, :, :], t[..., 2, :, :])


def _from_lane_major(pv: PointVec) -> torch.Tensor:
    """PointVec of (..., T, 16) -> (..., 3, 16, T) contiguous."""
    return torch.stack(list(pv), dim=-3).transpose(-1, -2).contiguous()


# ---------------- kernel 2: bucket accumulation ----------------


def msm_accum_plain(scal: torch.Tensor, px: torch.Tensor, py: torch.Tensor, c: int, nwin: int,
                    T: int, cc: CurveCtx) -> torch.Tensor:
    M, _, n_pad = scal.shape
    B = 1 << c
    rows = M * nwin
    dev = scal.device
    idv = cc.identity_vec((rows, B, T), dev)
    bx, by, bz = idv.x.clone(), idv.y.clone(), idv.z.clone()
    w = torch.arange(nwin, device=dev)
    limb_idx = (w * c) >> 4
    shift = ((w * c) & 15).view(1, nwin, 1)
    r_idx = torch.arange(rows, device=dev)[:, None].expand(rows, T)
    t_idx = torch.arange(T, device=dev)[None, :].expand(rows, T)
    for s in range(n_pad // T):
        sl = slice(s * T, (s + 1) * T)
        limbs = scal[:, limb_idx, sl]  # (M, nwin, T)
        d = ((limbs >> shift) & (B - 1)).reshape(rows, T).long()
        cur = PointVec(bx[r_idx, d, t_idx], by[r_idx, d, t_idx], bz[r_idx, d, t_idx])
        X2 = px[:, sl].t().unsqueeze(0).expand(rows, T, NLIMBS)
        Y2 = py[:, sl].t().unsqueeze(0).expand(rows, T, NLIMBS)
        new = padd_mixed(cur, X2, Y2, cc)
        keep = (d != 0).unsqueeze(-1)
        for store, val, old in ((bx, new.x, cur.x), (by, new.y, cur.y), (bz, new.z, cur.z)):
            store[r_idx, d, t_idx] = torch.where(keep, val, old)
    return torch.stack([bx, by, bz], dim=-2).transpose(1, 2).contiguous()  # (rows, T, B, 3, 16)


def accum_block(n_pad: int, T: int, c: int):
    """(G, shared bytes) of one kernel-2 block: G lanes (a power of two
    dividing T) of P = n_pad / T points, their digits, counts and sorted list
    (`accum_smem` in csrc/msm_bucket.cu)."""
    P = n_pad // T
    G = 1 << max(0, (ACCUM_POINTS_PER_BLOCK // max(P, 1)).bit_length() - 1)
    G = min(G, T, (1 << 15) >> c)  # a sorted item holds the key g * 2^c + d in 15 bits
    while G > 1 and 4 * (G * (1 << c) + 1) + 5 * G * P > ACCUM_SMEM_TARGET:
        G //= 2
    return G, 4 * (G * (1 << c) + 1) + 5 * G * P


def msm_accum(scal: torch.Tensor, px: torch.Tensor, py: torch.Tensor, c: int, nwin: int,
              T: int, cc: CurveCtx) -> torch.Tensor:
    """scal (M, 16, n_pad) canonical limbs; px/py (16, n_pad) affine
    Montgomery bases -> buckets (M * nwin, T, 2^c, 3, 16)."""
    if not _build.on_card(scal, "msm_accum"):
        return msm_accum_plain(scal, px, py, c, nwin, T, cc)
    M, _, n_pad = scal.shape
    if c not in (4, 8) or n_pad % T or T > 1024 or T & (T - 1):
        raise ValueError(f"msm_accum: bad geometry c={c} T={T} n_pad={n_pad}")
    G, smem = accum_block(n_pad, T, c)
    if n_pad // T >= 1 << 17 or smem > ACCUM_SMEM_MAX:
        raise ValueError(f"msm_accum: {n_pad // T} points per lane do not fit a block")
    _build.check_tensor(scal, (M, NLIMBS, n_pad), "scal", scal.device)
    _build.check_tensor(px, (NLIMBS, n_pad), "px", scal.device)
    _build.check_tensor(py, (NLIMBS, n_pad), "py", scal.device)
    rows = M * nwin
    out = torch.empty((rows, T, 1 << c, 3, NLIMBS), dtype=torch.int32, device=scal.device)
    lib = _build.load("msm_bucket", _SIG)
    err = lib.msm_accum(scal.data_ptr(), px.data_ptr(), py.data_ptr(), out.data_ptr(), rows,
                        nwin, n_pad, T, c, G, ctypes.byref(_consts(cc)),
                        torch.cuda.current_stream(scal.device).cuda_stream)
    _build.check(err, "msm_accum")
    LAUNCHES["msm_accum"] += 1
    return out


# ---------------- kernel 3: bucket fold ----------------


def _fold_log_segment(B: int, l):
    """l, checked: 2^l divides B into at most 32 segments (one warp's lanes)."""
    if l is None:
        l = FOLD_LOG_SEGMENT[B.bit_length() - 1]
    if not 0 <= l < B.bit_length() or B >> l > 32:
        raise ValueError(f"msm_fold: segment 2^{l} does not cut {B} buckets into 1-32")
    return l


def msm_fold_plain(buckets: torch.Tensor, cc: CurveCtx, l=None) -> torch.Tensor:
    """The kernel's additions in the kernel's order; `l` other than the
    default only to hold other segment lengths to the same sums."""
    rows, T, B, _, _ = buckets.shape
    l = _fold_log_segment(B, l)
    L, S = 1 << l, B >> l
    seg = buckets.reshape(rows, T, S, L, 3, NLIMBS)
    run = cc.identity_vec((rows, T, S), buckets.device)
    tot = run
    for r in range(L - 1, 0, -1):  # running and total suffix sums: tot = W_j
        run = add_skip(run, PointVec(*seg[:, :, :, r].unbind(-2)), cc)
        tot = add_skip(tot, run, cc)
    run = add_skip(run, PointVec(*seg[:, :, :, 0].unbind(-2)), cc)  # Sum_j
    d = 1
    while d < S:  # suffix scan: U_j = sum_{i >= j} Sum_i
        head = add_skip(PointVec(*(t[:, :, : S - d] for t in run)),
                        PointVec(*(t[:, :, d:] for t in run)), cc)
        run = PointVec(*(torch.cat([h, t[:, :, S - d :]], 2) for h, t in zip(head, run)))
        d *= 2
    idv = cc.identity_vec((rows, T, 1), buckets.device)
    run = PointVec(*(torch.cat([i, t[:, :, 1:]], 2) for i, t in zip(idv, run)))  # U_0 dropped
    for _ in range(l):
        run = dbl_skip(run, cc)
    x = add_skip(tot, run, cc)
    d = S // 2
    while d >= 1:  # tree over segments into segment 0
        x = add_skip(PointVec(*(t[:, :, :d] for t in x)),
                     PointVec(*(t[:, :, d : 2 * d] for t in x)), cc)
        d //= 2
    return _from_lane_major(PointVec(*(t[:, :, 0] for t in x)))  # (rows, 3, 16, T)


def msm_fold(buckets: torch.Tensor, cc: CurveCtx) -> torch.Tensor:
    """buckets (rows, T, B, 3, 16) -> per-lane sum_b b * S_b, (rows, 3, 16, T),
    in segments of 2^FOLD_LOG_SEGMENT[c] buckets."""
    if not _build.on_card(buckets, "msm_fold"):
        return msm_fold_plain(buckets, cc)
    rows, T, B, _, _ = buckets.shape
    l = _fold_log_segment(B, None)
    _build.check_tensor(buckets, (rows, T, B, 3, NLIMBS), "buckets", buckets.device, align=16)
    out = torch.empty((rows, 3, NLIMBS, T), dtype=torch.int32, device=buckets.device)
    lib = _build.load("msm_bucket", _SIG)
    err = lib.msm_fold(buckets.data_ptr(), out.data_ptr(), rows, B, T, l,
                       ctypes.byref(_consts(cc)),
                       torch.cuda.current_stream(buckets.device).cuda_stream)
    _build.check(err, "msm_fold")
    LAUNCHES["msm_fold"] += 1
    return out


# ---------------- kernel 4: lane reduction ----------------


def msm_lane_reduce_plain(parts: torch.Tensor, cc: CurveCtx) -> torch.Tensor:
    pv = _to_lane_major(parts)  # (rows, T, 16) each
    s = parts.shape[-1] // 2
    while s >= 1:
        head = PointVec(*(t[:, :s] for t in pv))
        tail = PointVec(*(t[:, s : 2 * s] for t in pv))
        pv = padd(head, tail, cc)
        s //= 2
    return torch.stack([t[:, 0] for t in pv], dim=1).contiguous()  # (rows, 3, 16)


def msm_lane_reduce(parts: torch.Tensor, cc: CurveCtx) -> torch.Tensor:
    """parts (rows, 3, 16, T) -> lane totals (rows, 3, 16)."""
    if not _build.on_card(parts, "msm_lane_reduce"):
        return msm_lane_reduce_plain(parts, cc)
    rows, _, _, T = parts.shape
    if T > 1024 or T & (T - 1):
        raise ValueError(f"msm_lane_reduce: T = {T} must be a power of two <= 1024")
    if LANE_REDUCE_THREADS % 32 or not 32 <= LANE_REDUCE_THREADS <= 256:
        raise ValueError(f"msm_lane_reduce: {LANE_REDUCE_THREADS} threads a block, not a "
                         "multiple of 32 in [32, 256]")
    _build.check_tensor(parts, (rows, 3, NLIMBS, T), "parts", parts.device)
    out = torch.empty((rows, 3, NLIMBS), dtype=torch.int32, device=parts.device)
    lib = _build.load("msm_bucket", _SIG)
    err = lib.msm_lane_reduce(parts.data_ptr(), out.data_ptr(), rows, T, LANE_REDUCE_THREADS,
                              ctypes.byref(_consts(cc)),
                              torch.cuda.current_stream(parts.device).cuda_stream)
    _build.check(err, "msm_lane_reduce")
    LAUNCHES["msm_lane_reduce"] += 1
    return out


# ---------------- the batched MSM ----------------


class DeviceBases:
    """Transposed affine base tables (16, n_pad) for the bucket MSM, padded
    with the generator (whose zero digits land in the skipped bucket 0)."""

    def __init__(self, curve: Type[Curve], points: Sequence[Point], n_pad: int, device):
        points = list(points)[:n_pad]
        cc = CurveCtx(curve)
        p, r = curve.p(), cc.fctx.r_int
        g = curve.generator().xy
        xs, ys = [], []
        for pt in points:
            if pt.is_identity():
                raise ValueError("bucket MSM bases must be affine (identity given)")
            xs.append(pt.xy[0] * r % p)
            ys.append(pt.xy[1] * r % p)
        pad = n_pad - len(points)
        xs.extend([g[0] * r % p] * pad)
        ys.extend([g[1] * r % p] * pad)
        self.n_pad = n_pad
        self.px = torch.as_tensor(ints_to_limbs(xs), device=device).t().contiguous()
        self.py = torch.as_tensor(ints_to_limbs(ys), device=device).t().contiguous()


def window_sums(scal: torch.Tensor, bases, mont: bool = True, plain: bool = False) -> torch.Tensor:
    """Device stages of the MSM: (M, n, 16) scalars -> (M * nwin, 3, 16)
    projective window sums; `plain` runs the stages' plain versions on any
    device (the route MSM=jax of `ops/msm.py`)."""
    curve = bases.curve
    M, n, _ = scal.shape
    c, nwin, T, n_pad = msm_geometry(curve, n, scal.device)
    db = bases.device_tables(n_pad, scal.device)
    canon = from_mont(scal, FieldCtx(curve.SCALAR)) if mont else scal
    canon = torch.nn.functional.pad(canon.transpose(1, 2), (0, n_pad - n)).contiguous()
    cc = bases.cc
    if plain:
        buckets = msm_accum_plain(canon, db.px, db.py, c, nwin, T, cc)
        return msm_lane_reduce_plain(msm_fold_plain(buckets, cc), cc)
    buckets = msm_accum(canon, db.px, db.py, c, nwin, T, cc)
    parts = msm_fold(buckets, cc)
    return msm_lane_reduce(parts, cc)


def msm_bucket_many(scal: torch.Tensor, bases, mont: bool = True, plain: bool = False) -> List[Point]:
    """M MSMs over shared bases: scal (M, n, 16) limb tensors (Montgomery
    when mont=True, canonical [0, q) otherwise) -> M Points, the same group
    elements as `msm_host`; `plain` as in `window_sums`."""
    curve = bases.curve
    M, n, _ = scal.shape
    c, nwin, _, _ = msm_geometry(curve, n, scal.device)
    sums = window_sums(scal, bases, mont, plain)
    wins = bases.cc.decode_points(PointVec(sums[:, 0], sums[:, 1], sums[:, 2]))
    p = curve.p()
    out = []
    for m in range(M):
        acc = JAC_IDENTITY
        for w in range(nwin - 1, -1, -1):
            for _ in range(c):
                acc = jac_double(acc, p)
            acc = jac_add(acc, wins[m * nwin + w].jacobian(), p)
        out.append(curve.from_jacobian(acc))
    return out
