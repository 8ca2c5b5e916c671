"""Sorted-bucket MSM: signed 16-bit windows, points sorted by bucket: kernels 5-7.

Counterpart of `halo2_tpu/ops/msm_sorted.py`, Pippenger's bucket method
(`halo2_proofs/src/arithmetic.rs:41-198`) for one MSM of n >= 2^16 points:

* **c = 16 signed windows = the scalar's own limbs.** Balanced recoding maps
  limb w to a digit e_w in [-2^15, 2^15] with a carry into the next limb;
  the bucket is |e_w| and the sign negates the point's y.
* **Pre-stage** (`prestage`, torch sort and gather; XLA code in the JAX
  package, not a Pallas kernel): per window, the points are sorted by bucket
  and, within a bucket, by point index (lane l owns the KB = 32 buckets
  [KB l, KB l + KB), W = 1024 lanes, so the list is also sorted by lane),
  zero digits sort past the side lane and are discarded, and |e| = 2^15
  forms a side list. Lane counts above the Poisson capacities of
  `_cap_classes`, or a side list above SIDE_CAP, set the overflow flag: the
  same MSMs overflow as in the JAX package, and `ops/msm.py` sends them to
  the unsorted bucket MSM.
* Three stages, each a hand-written CUDA kernel (`csrc/msm_sorted.cu`) with
  its plain torch version beside it:
  1. `msm_sorted_accum` (replaces `_accum_fn`): a block per (window, G
     lanes) cuts its sorted entries into runs of whole buckets, one a
     thread, and sums each bucket in registers from the identity in
     ascending point index (so the buckets are the first port's, bit for
     bit); every bucket is written once, empty ones as the identity.
  2. `msm_sorted_fold` (replaces `_fold_fn`): per window sum_b b * S_b over
     the 2^15 buckets plus 2^15 * side sum, by running sums over segments of
     2^l buckets (the side list is bucket 2^15 of the top segment), a
     suffix scan and a tree per block, and the same formula over the blocks
     of a window in a second pass.
  3. `msm_sorted_horner` (replaces `_horner_fn`): sum_w 2^(16 w) * win_w.

Every addition follows one skip rule (an identity operand is not added; a
point added into an empty bucket is copied), in the same order in the kernels
and the plain versions, so both give the same projective coordinates and the
plain versions do work only for the buckets that hold points. The MSM reads
back once: the result's coordinates and the overflow flag together.

Each wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors. No PyTorch call computes a bucket MSM.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from ..curves import Point
from . import _build
from .curve import CurveCtx, PointVec, add_affine_skip, add_skip, dbl_skip, is_identity, pick, put
from .field import NLIMBS, from_mont, limbs_to_ints, sub_mod

BUCKET_BITS = 15  # buckets by |e|, e in [-2^15, 2^15]
SIDE_CAP = 128  # slots for |e| = 2^15 points per window
LANES = 1024  # W: lanes per window
KB = (1 << BUCKET_BITS) // LANES  # buckets per lane, 32
KEY_BITS = 21  # the sort key is |e| << 21 | index
# Launch geometry, the fastest of a sweep on an H100 at n = 2^16 + 1
# (`tools/msm_ab.py --sorted --sweep`; PERF.md): kernel 5 takes
# ACCUM_GEOMETRY = (lanes, threads) a block, kernel 6 FOLD_GEOMETRY = (l,
# threads), segments of 2^l buckets, one a thread. msm_sorted_fold_plain reads
# FOLD_GEOMETRY too, since the fold's additions depend on it.
ACCUM_GEOMETRY = (32, 128)
FOLD_GEOMETRY = (4, 64)
LAUNCHES = {"msm_sorted_accum": 0, "msm_sorted_fold": 0, "msm_sorted_horner": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIG = {
    "msm_sorted_accum": (_P, _P, _P, _P, _P, _I, _L, _I, _I, _P, _P),
    "msm_sorted_fold": (_P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _P, _P),
    "msm_sorted_horner": (_P, _P, _I, _P, _P),
}


class BucketOverflow(RuntimeError):
    """A lane or side list over capacity (structured scalars), a 17-window
    curve, more than 2^21 points or an identity base: the caller takes the
    unsorted bucket MSM."""


def _cap_for(n: int, w: int) -> int:
    lam = max(1.0, n / float(w))
    return int(math.ceil((lam + 6.0 * math.sqrt(lam) + 8.0) / 8.0)) * 8


def _num_windows(q: int) -> int:
    # the top recoded digit fits window 15 iff (q-1)'s top limb + carry
    # stays below 2^15 (true for Pasta; secp256k1 needs 17)
    return 16 if ((q - 1) >> 240) + 1 < (1 << 15) else 17


def _cap_classes(n: int, w_lanes: int, kb: int, q: int):
    """Windows grouped by lane capacity, [(first_window, n_windows, cap), ...].

    Digits of windows 0..14 are uniform over [-2^15, 2^15], so a lane holds
    Poisson(n / W) points; the top window's digit is bounded by q's top limb
    (0x4000 for Pasta), which puts its points on the first R_top buckets, so
    its capacity scales by 2^15 / R_top."""
    nw = _num_windows(q)
    cap_uni = _cap_for(n, w_lanes)
    r_top = ((q - 1) >> 240) + 2  # top recoded digit range incl. carry
    lam_top = max(1.0, n * kb / float(r_top))
    cap_top = int(math.ceil((lam_top + 6.0 * math.sqrt(lam_top) + 8.0) / 8.0)) * 8
    assert nw == 16, "17-window curves take the unsorted kernel"
    return ((0, 15, cap_uni), (15, 1, cap_top))


# ---------------- pre-stage: recode, sort by bucket ----------------


def _recode_signed(limbs: torch.Tensor, nw: int) -> torch.Tensor:
    """(n, 16) canonical limbs -> (nw, n) int32 balanced digits."""
    carry = torch.zeros(limbs.shape[0], dtype=torch.int32, device=limbs.device)
    es = []
    for w in range(16):
        t = limbs[:, w].to(torch.int32) + carry
        big = t >= (1 << 15)
        es.append(torch.where(big, t - (1 << 16), t))
        carry = big.to(torch.int32)
    if nw > 16:
        es.append(carry)
    return torch.stack(es[:nw])


def prestage(canon: torch.Tensor, nw: int, classes) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n, 16) canonical scalar limbs -> entries (nw, n) int32, the points of
    each window sorted by bucket |e| and then by index, as src << 6 |
    (e < 0) << 5 | |e| mod KB; gstart (nw, W + 2) int32, the first sorted
    position of each lane, the side list at [W, W + 1); and the 0-d overflow
    flag. torch has no uint32 sort, so the key (|e| << 21 | index, below
    2^37) is int64."""
    n = canon.shape[0]
    dev = canon.device
    e = _recode_signed(canon, nw).long()
    bucket = e.abs()
    # zero digits sort to a discard lane past the side lane: real columns are
    # often mostly zeros and would overflow lane 0, but add nothing
    bucket = torch.where(bucket == 0, (LANES + 1) * KB, bucket)
    key = torch.sort((bucket << KEY_BITS) | torch.arange(n, device=dev), dim=1).values
    order = key & ((1 << KEY_BITS) - 1)
    queries = torch.arange(LANES + 2, device=dev).expand(nw, LANES + 2).contiguous()
    lane_shift = KEY_BITS + KB.bit_length() - 1  # key >> lane_shift = |e| // KB
    gstart = torch.searchsorted((key >> lane_shift).contiguous(), queries)
    gcnt = gstart[:, 1 : LANES + 1] - gstart[:, :LANES]
    side_cnt = gstart[:, LANES + 1] - gstart[:, LANES]
    caps = torch.as_tensor([cap for (_, cnt, cap) in classes for _ in range(cnt)], device=dev)
    overflow = ((gcnt.amax(1) > caps) | (side_cnt > SIDE_CAP)).any()
    es = torch.gather(e, 1, order)
    entries = (order << 6) | ((es < 0).long() << 5) | (es.abs() % KB)
    return entries.to(torch.int32), gstart.to(torch.int32), overflow


def _base(px: torch.Tensor, py: torch.Tensor, src: torch.Tensor, neg: torch.Tensor, cc: CurveCtx):
    x = px[src]
    y = py[src]
    return x, torch.where(neg.bool()[:, None], sub_mod(torch.zeros_like(y), y, cc.fctx), y)


def _points(t: torch.Tensor) -> PointVec:
    """(..., 3, 16) -> PointVec of (..., 16) views."""
    return PointVec(t[..., 0, :], t[..., 1, :], t[..., 2, :])


def _stack(pv: PointVec) -> torch.Tensor:
    return torch.stack(list(pv), dim=-2).contiguous()


# ---------------- kernel 5: sorted accumulation ----------------


def msm_sorted_accum_plain(entries, gstart, px, py, cc: CurveCtx) -> torch.Tensor:
    """Each bucket from the identity, its points in the order of the lane's
    run (ascending index within a bucket): the kernel's additions."""
    nw, _ = entries.shape
    dev = entries.device
    b = cc.identity_vec((nw * LANES * KB,), dev)
    start = gstart[:, :LANES].long()
    cnt = gstart[:, 1 : LANES + 1].long() - start
    for r in range(int(cnt.max()) if cnt.numel() else 0):
        w, lane = (cnt > r).nonzero(as_tuple=True)
        e = entries[w, start[w, lane] + r].long()
        x, y = _base(px, py, e >> 6, (e >> 5) & 1, cc)
        flat = (w * LANES + lane) * KB + (e & (KB - 1))
        put(b, flat, add_affine_skip(pick(b, flat), x, y, cc))
    return _stack(b).reshape(nw, LANES, KB, 3, NLIMBS)


def msm_sorted_accum(entries, gstart, px, py, cc: CurveCtx) -> torch.Tensor:
    """entries (nw, n), gstart (nw, W + 2) from `prestage`; px/py (rows >= n,
    16) affine Montgomery bases -> buckets (nw, W, KB, 3, 16)."""
    if not _build.on_card(entries, "msm_sorted_accum"):
        return msm_sorted_accum_plain(entries, gstart, px, py, cc)
    nw, n = entries.shape
    dev = entries.device
    _check_inputs(entries, gstart, px, py)
    lanes, threads = ACCUM_GEOMETRY
    if not 1 <= lanes <= 32 or lanes & (lanes - 1) or threads % 32 or not 32 <= threads <= 128:
        raise ValueError(f"msm_sorted_accum: geometry {ACCUM_GEOMETRY} not (2^i <= 32, 32-128 threads)")
    out = torch.empty((nw, LANES, KB, 3, NLIMBS), dtype=torch.int32, device=dev)
    lib = _build.load("msm_sorted", _SIG)
    err = lib.msm_sorted_accum(entries.data_ptr(), gstart.data_ptr(), px.data_ptr(), py.data_ptr(),
                               out.data_ptr(), nw, n, lanes, threads, ctypes.byref(_consts(cc)),
                               torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "msm_sorted_accum")
    LAUNCHES["msm_sorted_accum"] += 1
    return out


def _consts(cc: CurveCtx):
    return _build.field_consts(cc.fctx.p_int, cc.b3_mont)


def _check_inputs(entries, gstart, px, py) -> None:
    nw, n = entries.shape
    dev = entries.device
    _build.check_tensor(entries, (nw, n), "entries", dev)
    _build.check_tensor(gstart, (nw, LANES + 2), "gstart", dev)
    _build.check_tensor(px, (px.shape[0], NLIMBS), "px", dev, align=16)
    _build.check_tensor(py, tuple(px.shape), "py", dev, align=16)
    if px.shape[0] < n:
        raise ValueError(f"msm_sorted: {n} scalars but {px.shape[0]} bases")


# ---------------- kernel 6: fold ----------------


def _fold_geometry() -> Tuple[int, int]:
    """FOLD_GEOMETRY, checked: whole warps, at most 256 threads a block, and
    1-32 blocks a window (the second pass is one warp a window)."""
    l, threads = FOLD_GEOMETRY
    segs = (1 << BUCKET_BITS) >> l
    if threads % 32 or not 32 <= threads <= 256 or segs % threads or not 1 <= segs // threads <= 32:
        raise ValueError(f"msm_sorted_fold: geometry {FOLD_GEOMETRY} gives no 1-32 blocks a window")
    return l, threads


def _side_sums(entries, gstart, px, py, cc: CurveCtx) -> PointVec:
    """(nw,) sum of each window's side list (at most SIDE_CAP points, y
    negated), from the identity in slot order."""
    nw = entries.shape[0]
    beg = gstart[:, LANES].long()
    cnt = (gstart[:, LANES + 1].long() - beg).clamp(max=SIDE_CAP)
    acc = cc.identity_vec((nw,), entries.device)
    for t in range(int(cnt.max())):
        w = (cnt > t).nonzero(as_tuple=True)[0]
        e = entries[w, beg[w] + t].long()
        x, y = _base(px, py, e >> 6, torch.ones_like(e), cc)
        put(acc, w, add_affine_skip(pick(acc, w), x, y, cc))
    return acc


def _warp_scan(x: PointVec, cc: CurveCtx) -> PointVec:
    """Suffix sums over the last point axis (32 lanes), x_j += x_{j + d} for
    d = 1, 2, 4, 8, 16 where j + d < 32: the kernels' shuffle scan."""
    for d in (1, 2, 4, 8, 16):
        head = add_skip(PointVec(*(t[..., : 32 - d, :] for t in x)),
                        PointVec(*(t[..., d:, :] for t in x)), cc)
        x = PointVec(*(torch.cat([h, t[..., 32 - d :, :]], -2) for h, t in zip(head, x)))
    return x


def _warp_tree(x: PointVec, cc: CurveCtx) -> PointVec:
    """Lane 0's sum over the last point axis (32 lanes): x_j += x_{j + d} for
    d = 16, 8, 4, 2, 1 where j < d, the kernels' shuffle tree."""
    for d in (16, 8, 4, 2, 1):
        x = add_skip(PointVec(*(t[..., :d, :] for t in x)),
                     PointVec(*(t[..., d : 2 * d, :] for t in x)), cc)
    return PointVec(*(t[..., 0, :] for t in x))


def _weigh(tot: PointVec, run: PointVec, log_w: int, cc: CurveCtx) -> PointVec:
    """sum_j tot_j + 2^log_w sum_{j >= 1} U_j with U the suffix sums of run,
    over 32 lanes on the last point axis: scan, lane 0 dropped, log_w
    doublings, one addition, tree."""
    u = _warp_scan(run, cc)
    idv = cc.identity_vec(u.x.shape[:-2] + (1,), u.x.device)
    u = PointVec(*(torch.cat([i, t[..., 1:, :]], -2) for i, t in zip(idv, u)))
    for _ in range(log_w):
        u = dbl_skip(u, cc)
    return _warp_tree(add_skip(tot, u, cc), cc)


def msm_sorted_fold_plain(buckets, entries, gstart, px, py, cc: CurveCtx) -> torch.Tensor:
    """The kernel's additions in the kernel's order, with segments, warps and
    blocks as batch dimensions; segments without a point and blocks that are
    all the exact identity (which give the exact identity) are skipped."""
    nw = buckets.shape[0]
    dev = buckets.device
    l, threads = _fold_geometry()
    L, J = 1 << l, (1 << BUCKET_BITS) >> l  # segment length, segments a window
    nbk, nwarp = J // threads, threads // 32
    seg = _points(buckets.reshape(nw, J, L, 3, NLIMBS))
    side = _side_sums(entries, gstart, px, py, cc)
    # first pass, segments: running sum and total from the top down; the side
    # list is bucket 2^15 = r = L of each window's top segment
    run = cc.identity_vec((nw, J), dev)
    tot = cc.identity_vec((nw, J), dev)
    occ = ~is_identity(seg.z, cc).all(-1)
    occ[:, J - 1] |= ~is_identity(side.z, cc)
    w, j = occ.nonzero(as_tuple=True)
    if w.numel():
        idm = cc.identity_vec((w.numel(),), dev)
        top = (j == J - 1)[:, None]
        r_run = add_skip(idm, PointVec(*(torch.where(top, s[w], i) for s, i in zip(side, idm))), cc)
        r_tot = add_skip(idm, r_run, cc)
        for r in range(L - 1, 0, -1):
            r_run = add_skip(r_run, PointVec(*(t[w, j, r] for t in seg)), cc)
            r_tot = add_skip(r_tot, r_run, cc)
        put(run, (w, j), add_skip(r_run, PointVec(*(t[w, j, 0] for t in seg)), cc))
        put(tot, (w, j), r_tot)
    # first pass, blocks of `threads` segments in warps of 32: (T, Sum) each
    blk_run = PointVec(*(t.reshape(nw * nbk, nwarp, 32, NLIMBS) for t in run))
    blk_tot = PointVec(*(t.reshape(nw * nbk, nwarp, 32, NLIMBS) for t in tot))
    T = cc.identity_vec((nw * nbk,), dev)
    S = cc.identity_vec((nw * nbk,), dev)
    idl = cc.identity_vec((), dev)
    g = torch.stack([(t != i).flatten(1).any(1) for t, i in zip(blk_run + blk_tot, idl + idl)])
    g = g.any(0).nonzero(as_tuple=True)[0]
    if g.numel():
        x = _warp_scan(pick(blk_run, g), cc)  # (m, nwarp, 32)
        above = [cc.identity_vec((g.numel(),), dev)]  # sums of the warps above, top down
        for k in range(nwarp - 1, 0, -1):
            above.insert(0, add_skip(above[0], PointVec(*(t[:, k, 0] for t in x)), cc))
        above = PointVec(*(torch.stack(c, 1)[:, :, None].expand(-1, -1, 32, -1)
                           for c in zip(*above)))
        u = add_skip(x, above, cc)  # U_i over the block
        put(S, g, PointVec(*(t[:, 0, 0] for t in u)))
        u = PointVec(*(t.clone() for t in u))
        put(u, (slice(None), 0, 0), cc.identity_vec((g.numel(),), dev))
        for _ in range(l):
            u = dbl_skip(u, cc)
        r = _warp_tree(add_skip(pick(blk_tot, g), u, cc), cc)  # (m, nwarp)
        acc = PointVec(*(t[:, 0] for t in r))
        for k in range(1, nwarp):
            acc = add_skip(acc, PointVec(*(t[:, k] for t in r)), cc)
        put(T, g, acc)
    # second pass: the blocks of a window, padded to a warp, at weight threads * L
    pad = cc.identity_vec((nw, 32 - nbk), dev)
    tw, sw = (PointVec(*(torch.cat([t.reshape(nw, nbk, NLIMBS), p], 1) for t, p in zip(v, pad)))
              for v in (T, S))
    lw = (threads << l).bit_length() - 1
    return _stack(_weigh(tw, sw, lw, cc))  # (nw, 3, 16)


def msm_sorted_fold(buckets, entries, gstart, px, py, cc: CurveCtx) -> torch.Tensor:
    """buckets (nw, W, KB, 3, 16) + the side lists -> window sums (nw, 3, 16):
    sum_b b * S_b + 2^15 * (side sum, y negated)."""
    if not _build.on_card(buckets, "msm_sorted_fold"):
        return msm_sorted_fold_plain(buckets, entries, gstart, px, py, cc)
    nw, n = entries.shape
    dev = buckets.device
    _check_inputs(entries, gstart, px, py)
    _build.check_tensor(buckets, (nw, LANES, KB, 3, NLIMBS), "buckets", dev, align=16)
    l, threads = _fold_geometry()
    nbk = ((1 << BUCKET_BITS) >> l) // threads
    part = torch.empty((nw, nbk, 2, 3, NLIMBS), dtype=torch.int32, device=dev)
    out = torch.empty((nw, 3, NLIMBS), dtype=torch.int32, device=dev)
    lib = _build.load("msm_sorted", _SIG)
    err = lib.msm_sorted_fold(buckets.data_ptr(), entries.data_ptr(), gstart.data_ptr(),
                              px.data_ptr(), py.data_ptr(), part.data_ptr(), out.data_ptr(),
                              nw, n, l, threads, ctypes.byref(_consts(cc)),
                              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "msm_sorted_fold")
    LAUNCHES["msm_sorted_fold"] += 1
    return out


# ---------------- kernel 7: Horner over windows ----------------


def msm_sorted_horner_plain(wins: torch.Tensor, cc: CurveCtx) -> torch.Tensor:
    """Plain version of kernel 7: wins (nw, ..., 3, 16) -> (..., 3, 16), each
    index of the dimensions after the first its own chain (a batch of MSMs)."""
    nw = wins.shape[0]
    acc = _points(wins[nw - 1 : nw])
    for w in range(nw - 2, -1, -1):
        for _ in range(16):
            acc = dbl_skip(acc, cc)
        acc = add_skip(acc, _points(wins[w : w + 1]), cc)
    return _stack(acc)[0]


def msm_sorted_horner(wins: torch.Tensor, cc: CurveCtx) -> torch.Tensor:
    """wins (nw, 3, 16) -> sum_w 2^(16 w) * wins_w, (3, 16)."""
    if not _build.on_card(wins, "msm_sorted_horner"):
        return msm_sorted_horner_plain(wins, cc)
    nw = wins.shape[0]
    _build.check_tensor(wins, (nw, 3, NLIMBS), "wins", wins.device, align=16)
    out = torch.empty((3, NLIMBS), dtype=torch.int32, device=wins.device)
    lib = _build.load("msm_sorted", _SIG)
    err = lib.msm_sorted_horner(wins.data_ptr(), out.data_ptr(), nw, ctypes.byref(_consts(cc)),
                                torch.cuda.current_stream(wins.device).cuda_stream)
    _build.check(err, "msm_sorted_horner")
    LAUNCHES["msm_sorted_horner"] += 1
    return out


# ---------------- the MSM ----------------


def msm_sorted(canon: torch.Tensor, bases) -> Point:
    """One MSM: (n, 16) canonical scalar limbs x `bases` (an ops.msm.MSMBases)
    -> host Point. Raises BucketOverflow where the JAX package does; the
    overflow flag comes back with the result in one readback."""
    curve = bases.curve
    q = curve.SCALAR.MODULUS
    n = canon.shape[0]
    nw = _num_windows(q)
    if nw != 16:
        raise BucketOverflow("17-window curve: the unsorted kernel handles it")
    if n > 1 << KEY_BITS:
        raise BucketOverflow(f"n={n} exceeds the 2^21 points the sort key holds")
    try:
        px, py = bases.device_rows(canon.device)
    except ValueError as e:  # an identity base: the kernels need affine points
        raise BucketOverflow(str(e)) from e
    entries, gstart, overflow = prestage(canon, nw, _cap_classes(n, LANES, KB, q))
    cc = bases.cc
    buckets = msm_sorted_accum(entries, gstart, px, py, cc)
    wins = msm_sorted_fold(buckets, entries, gstart, px, py, cc)
    total = msm_sorted_horner(wins, cc)
    host = torch.cat([from_mont(total, cc.fctx).reshape(-1),
                      overflow.to(torch.int32).reshape(1)]).cpu()
    if int(host[-1]):
        raise BucketOverflow("bucket capacity exceeded (structured scalars)")
    X, Y, Z = limbs_to_ints(host[:-1].reshape(3, NLIMBS))
    if Z == 0:
        return Point(curve, None)
    p = curve.p()
    zinv = pow(Z, -1, p)
    return Point(curve, (X * zinv % p, Y * zinv % p))
