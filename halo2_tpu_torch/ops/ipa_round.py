"""Kernel F: the rounds of an IPA opening on n lanes.

Counterpart of the jitted `emit` and `fold` of `_ipa_round_fns` in
`halo2_tpu/poly/ipa/__init__.py:356, 386`, which are shape-stable: the live
length m is a value and lanes >= m are masked. `round_emit`, `round_fold`
and `round_fold_emit` (one round's fold and the next round's emit) run
kernel F (`csrc/ipa_round.cu`) for a CUDA tensor and their plain versions
(`*_plain`, torch on kernel A's field ops) for a CPU tensor, and raise for
any other device; on the card each call is one device kernel and reads
nothing back, so an opening of k rounds is k + 1 of them. Their outputs lie
in [0, 2p) and equal the plain versions' as values mod p: the MSM that
takes the emitted scalars reads them through `from_mont`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .field import NLIMBS, FieldCtx, add_mod, mont_mul
from .polyeval import tree_sum

LANE_THREADS = 128  # csrc/ipa_round.cu kRoundThreads (it rejects other blocks)
LAUNCHES = {"ipa_round": 0}  # kernel F's device kernels

_P = ctypes.c_void_p
_SIG = {"ipa_round": (ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _P, _P)}


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


def _launch(fold: bool, emit: bool, pprime, b, s_mult, m: int, ctx: FieldCtx, z=None, rands=None, u=None,
            uinv=None):
    """One launch of kernel F: (folded (3, n, 16) or None, scalars (2, n + 2,
    16) or None)."""
    n, blocks, (pp, bb, s, *sc) = launch_args(
        pprime, b, s_mult, m, *([u.reshape(NLIMBS), uinv.reshape(NLIMBS)] if fold else []),
        *([z.reshape(NLIMBS), rands.reshape(2, NLIMBS)] if emit else []))
    u, uinv = sc[:2] if fold else (None, None)
    z, rands = sc[-2:] if emit else (None, None)
    dev = pp.device
    folded = torch.empty((3, n, NLIMBS), dtype=torch.int32, device=dev) if fold else None
    scal = partial = counter = None
    if emit:
        scal = torch.empty((2, n + 2, NLIMBS), dtype=torch.int32, device=dev)
        partial = torch.empty((2, blocks, 8), dtype=torch.int32, device=dev)
        counter = _build.completion_counter(dev)
    lib = _build.load("ipa_round", _SIG)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.ipa_round(int(fold), int(emit), ptr(pp), ptr(bb), ptr(s), ptr(z), ptr(rands), ptr(u), ptr(uinv),
                        ptr(folded), ptr(scal), ptr(partial), ptr(counter), n, m, blocks,
                        ctypes.byref(_build.field_consts(ctx.p_int)), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"ipa_round fold={int(fold)} emit={int(emit)}")
    LAUNCHES["ipa_round"] += 1
    return folded, scal


def round_emit(pprime, b, s_mult, m: int, z_mont, rands, ctx: FieldCtx) -> torch.Tensor:
    """-> (2, n+2, 16) Montgomery scalars over bases g ++ [u, w]:
    row 0 = L_j (w_l coefficients, z*<p'_hi, b_lo> on u, l_rand on w),
    row 1 = R_j. Lanes >= m of p' and b are zero."""
    if not _build.on_card(pprime, "round_emit"):
        return round_emit_plain(pprime, b, s_mult, m, z_mont, rands, ctx)
    return _launch(False, True, pprime, b, s_mult, m, ctx, z=z_mont, rands=rands)[1]


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
    folded = _launch(True, False, pprime, b, s_mult, m, ctx, u=u_mont, uinv=uinv_mont)[0]
    return folded[0], folded[1], folded[2]


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


def round_fold_emit(pprime, b, s_mult, m: int, u_mont, uinv_mont, z_mont, rands, ctx: FieldCtx):
    """round_fold at m, then round_emit of the folded lanes at m / 2 (m >= 4):
    one round's fold and the next round's emit, (p', b, s_mult, scalars).
    On the card one launch: each lane's emit recomputes the folded values it
    reads from the unfolded ones."""
    if m < 4:
        raise ValueError(f"round_fold_emit: m = {m} leaves no round to emit")
    if not _build.on_card(pprime, "round_fold_emit"):
        return round_fold_emit_plain(pprime, b, s_mult, m, u_mont, uinv_mont, z_mont, rands, ctx)
    folded, scal = _launch(True, True, pprime, b, s_mult, m, ctx, z=z_mont, rands=rands, u=u_mont,
                           uinv=uinv_mont)
    return folded[0], folded[1], folded[2], scal


def round_fold_emit_plain(pprime, b, s_mult, m: int, u_mont, uinv_mont, z_mont, rands, ctx: FieldCtx):
    pprime, b, s_mult = round_fold_plain(pprime, b, s_mult, m, u_mont, uinv_mont, ctx)
    return pprime, b, s_mult, round_emit_plain(pprime, b, s_mult, m // 2, z_mont, rands, ctx)
