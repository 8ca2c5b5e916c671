"""Kernel F: the two programs of an IPA opening round on n lanes.

Counterpart of the jitted `emit` and `fold` of `_ipa_round_fns` in
`halo2_tpu/poly/ipa/__init__.py:356, 386`, which are shape-stable: the live
length m is a value and lanes >= m are masked. `round_emit` and
`round_fold` run kernel F (`csrc/ipa_round.cu`) for a CUDA tensor and their
plain versions (`*_plain`, torch on kernel A's field ops) for a CPU
tensor, and raise for any other device; on the card a round is three
device kernels (emit and its tail, fold) and reads nothing back. Their
outputs lie in [0, 2p) and equal the plain versions' as values mod p: the
MSM that takes the emitted scalars reads them through `from_mont`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .field import NLIMBS, FieldCtx, add_mod, mont_mul
from .polyeval import tree_sum

LANE_THREADS = 256  # csrc/ipa_round.cu kLaneThreads
LAUNCHES = {"ipa_round": 0}  # kernel F's device kernels

_P = ctypes.c_void_p
_SIG = {"ipa_round": (ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                      ctypes.c_longlong, ctypes.c_int, _P, _P)}


def launch_args(pprime: torch.Tensor, b: torch.Tensor, s_mult: torch.Tensor, m: int, *scalars):
    """(n, blocks, tensors) of one launch: the lane tensors (n, 16) and the
    scalars (16,) or (2, 16) as the kernel reads them (int32, contiguous,
    on one device, 16-byte aligned), after checking that m is a power of
    two in [2, n]."""
    n = pprime.shape[0]
    if m < 2 or m > n or m & (m - 1):
        raise ValueError(f"ipa_round: m = {m} is not a power of two in [2, {n}]")
    dev = pprime.device
    out = []
    for t, shape in [(pprime, (n, NLIMBS)), (b, (n, NLIMBS)), (s_mult, (n, NLIMBS))] + [
            (s, tuple(s.shape)) for s in scalars]:
        t = t.to(torch.int32).contiguous()
        _build.check_tensor(t, shape, "ipa_round operand", dev, align=16)
        out.append(t)
    return n, -(-n // LANE_THREADS), out


def _launch(emit: bool, n: int, blocks: int, pp, b, s, z, rands, u, uinv, out, partial, m: int,
            ctx: FieldCtx):
    lib = _build.load("ipa_round", _SIG)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.ipa_round(int(emit), ptr(pp), ptr(b), ptr(s), ptr(z), ptr(rands), ptr(u), ptr(uinv),
                        ptr(out), ptr(partial), n, m, blocks, ctypes.byref(_build.field_consts(ctx.p_int)),
                        torch.cuda.current_stream(pp.device).cuda_stream)
    _build.check(err, "ipa_round emit" if emit else "ipa_round fold")
    LAUNCHES["ipa_round"] += 2 if emit else 1


def round_emit(pprime, b, s_mult, m: int, z_mont, rands, ctx: FieldCtx) -> torch.Tensor:
    """-> (2, n+2, 16) Montgomery scalars over bases g ++ [u, w]:
    row 0 = L_j (w_l coefficients, z*<p'_hi, b_lo> on u, l_rand on w),
    row 1 = R_j. Lanes >= m of p' and b are zero."""
    if not _build.on_card(pprime, "round_emit"):
        return round_emit_plain(pprime, b, s_mult, m, z_mont, rands, ctx)
    n, blocks, (pp, bb, s, z, r) = launch_args(pprime, b, s_mult, m, z_mont.reshape(NLIMBS),
                                               rands.reshape(2, NLIMBS))
    out = torch.empty((2, n + 2, NLIMBS), dtype=torch.int32, device=pp.device)
    partial = torch.empty((2, blocks, NLIMBS), dtype=torch.int32, device=pp.device)
    _launch(True, n, blocks, pp, bb, s, z, r, None, None, out, partial, m, ctx)
    return out


def round_emit_plain(pprime, b, s_mult, m: int, z_mont, rands, ctx: FieldCtx) -> torch.Tensor:
    n = pprime.shape[0]
    half = m // 2
    lane = torch.arange(n, device=pprime.device)
    j = lane & (m - 1)
    hi = (j & half) != 0
    zero = torch.zeros_like(s_mult)

    def gat(v, idx):
        return v[idx.clamp(0, n - 1)]

    wl = torch.where(hi[:, None], zero, mont_mul(s_mult, gat(pprime, half + j), ctx))
    wr = torch.where(hi[:, None], mont_mul(s_mult, gat(pprime, torch.where(hi, j - half, 0)), ctx),
                     zero)
    first = (lane < half)[:, None]
    vl = torch.where(first, mont_mul(gat(pprime, lane + half), b, ctx), zero)
    vr = torch.where(first, mont_mul(pprime, gat(b, lane + half), ctx), zero)
    tail_l = torch.stack([mont_mul(z_mont, tree_sum(vl, ctx, 0), ctx), rands[0]])
    tail_r = torch.stack([mont_mul(z_mont, tree_sum(vr, ctx, 0), ctx), rands[1]])
    return torch.stack([torch.cat([wl, tail_l]), torch.cat([wr, tail_r])])


def round_fold(pprime, b, s_mult, m: int, u_mont, uinv_mont, ctx: FieldCtx):
    """p' <- p'_lo + u^-1 p'_hi ; b <- b_lo + u b_hi ; s_mult <- u * s_mult on
    lanes with the half-bit set."""
    if not _build.on_card(pprime, "round_fold"):
        return round_fold_plain(pprime, b, s_mult, m, u_mont, uinv_mont, ctx)
    n, blocks, (pp, bb, s, u, uinv) = launch_args(pprime, b, s_mult, m, u_mont.reshape(NLIMBS),
                                                  uinv_mont.reshape(NLIMBS))
    out = torch.empty((3, n, NLIMBS), dtype=torch.int32, device=pp.device)
    _launch(False, n, blocks, pp, bb, s, None, None, u, uinv, out, None, m, ctx)
    return out[0], out[1], out[2]


def round_fold_plain(pprime, b, s_mult, m: int, u_mont, uinv_mont, ctx: FieldCtx):
    n = pprime.shape[0]
    half = m // 2
    lane = torch.arange(n, device=pprime.device)
    idx = (lane + half).clamp(0, n - 1)
    first = (lane < half)[:, None]
    hi_sel = ((lane & half) != 0)[:, None]
    zero = torch.zeros_like(pprime)
    ppn = add_mod(pprime, mont_mul(pprime[idx], uinv_mont, ctx), ctx)
    bn = add_mod(b, mont_mul(b[idx], u_mont, ctx), ctx)
    return (
        torch.where(first, ppn, zero),
        torch.where(first, bn, zero),
        torch.where(hi_sel, mont_mul(s_mult, u_mont, ctx), s_mult),
    )
