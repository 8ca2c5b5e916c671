"""Mixed-radix (four-step) NTT with radix-2 column transforms: kernel 8.

Counterpart of `halo2_tpu/ops/ntt_pallas.py` (`PallasNttPlan`, the engine of
`NTT=pallas`). A size-n transform is split into levels of size
f = 2^min(log size, 8): n = f * g, then g recursively with the root raised
to the f. With j = j1 * g + j2 and one column per (b, j2),

    Y[k1, j2]        = (sum_j1 w_f^(j1 k1) x[j1 g + j2]) * root^(k1 j2)
    X[k1 + f k2]     = NTT_g over j2 of Y[k1, :]

Level L sees the data as a (B, f, g) array (B the product of the earlier
levels' f), as the constant-geometry plan does (`ops/ntt_cg.py`), and runs
`mr_col_ntt` down every column (b, j2) over j1: the rows j1 are read in
bit-reversed order, log2(f) radix-2 decimation-in-time stages (stage s
pairs rows m = 2^s apart and multiplies by w_2m^pos; stage 0's twiddles are
all 1, so it multiplies nothing) leave the rows in natural k1 order, and the
inter-level twiddle root^(k1 j2) is applied when g > 1. Row k1 of column
(b, j2) is written to (b, k1, j2), which read as (B f, f', g') is the next
level's input; the last level (g = 1) writes row k1 of column b to
k1 * B + perm[b], perm the digit reversal over the earlier radices
(`ntt_cg.digit_reversal`), which leaves X[k1 + f0 k2 + ...] in natural
order. So a transform is its levels' launches and nothing else, through
`CgNttPlan.__call__`'s loop with this plan's own level function.

Column (b, j2) takes inter-level twiddle row j2 of a (g, f, 16) table. The
TPU's 128-lane tiling of that table (`ntt_pallas.py:326-343, 376-389`) is
not carried over: its comment records wrong transforms when the second
factor exceeded 2^8; here the period is g whatever the batch.

Kernel 8 (`csrc/ntt_mr.cu`) replaces `ntt_pallas.py::_col_ntt_kernel`; its
note says what bounds it and what its design does about that.
`mr_col_ntt` launches it for a CUDA tensor and runs `mr_col_ntt_plain`, the
same arithmetic in torch, for a CPU tensor. Both take the rows in natural
order and bit-reverse them themselves (the kernel as it loads a column).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .field import NLIMBS, FieldCtx, add_mod, ints_to_limbs, mont_mul, sub_mod
from .ntt import bitrev_perm
from .ntt_cg import CgNttPlan, digit_reversal

LAUNCHES = {"mr_col_ntt": 0}

# Threads a block of kernel 8 at most: f/2 a column, so a block holds
# max(1, LEVEL_THREADS / (f/2)) columns (from `tools/msm_ab.py --ntt --sweep`).
LEVEL_THREADS = 32

_SIG = {
    "mr_col_ntt": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    )
}


def mr_col_ntt_plain(x: torch.Tensor, stw: torch.Tensor, inter: Optional[torch.Tensor],
                     ctx: FieldCtx, perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch version of kernel 8, the same contract (`mr_col_ntt`)."""
    B, f, g, _ = x.shape
    log_f = f.bit_length() - 1
    cols = x.transpose(1, 2).reshape(B * g, f, NLIMBS)
    cols = cols[:, torch.as_tensor(bitrev_perm(log_f), device=x.device)]
    for s in range(log_f):
        m = 1 << s
        blocks = cols.reshape(B * g, f // (2 * m), 2, m, NLIMBS)
        lo, hi = blocks[:, :, 0], blocks[:, :, 1]
        t = hi if s == 0 else mont_mul(hi, stw[s].reshape(f // (2 * m), m, NLIMBS), ctx)
        cols = torch.stack([add_mod(lo, t, ctx), sub_mod(lo, t, ctx)], dim=2).reshape(cols.shape)
    if inter is not None:
        cols = mont_mul(cols, inter.repeat(B, 1, 1), ctx)  # column (b, j2) takes row j2
    if perm is None:
        return cols.reshape(B, g, f, NLIMBS).transpose(1, 2).contiguous()
    out = torch.empty((f, B, NLIMBS), dtype=x.dtype, device=x.device)
    out[:, perm.long()] = cols.transpose(0, 1)
    return out


def mr_col_ntt(x: torch.Tensor, stw: torch.Tensor, inter: Optional[torch.Tensor],
               ctx: FieldCtx, perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One mixed-radix level down every column (b, j2) of x (B, f, g, 16) int32.

    stw: (log f, f/2, 16) stage twiddles, stage s holding its m = 2^s base
    twiddles repeated f/2m times; inter: (g, f, 16) inter-level twiddles
    (column (b, j2) takes inter[j2], row k1 natural) or None. Returns
    (B, f, g, 16) with row k1 of each column in natural order; with perm
    ((B,) int32, g = 1) returns (f, B, 16) with row k1 of column b at
    [k1, perm[b]]. Launches kernel 8 on a CUDA tensor; runs the plain version
    on a CPU tensor."""
    if not _build.on_card(x, "mr_col_ntt"):
        return mr_col_ntt_plain(x, stw, inter, ctx, perm)
    B, f, g, _ = x.shape
    log_f, log_g = f.bit_length() - 1, g.bit_length() - 1
    if f != 1 << log_f or log_f < 1 or log_f > 10 or g != 1 << log_g:
        raise ValueError(f"mr_col_ntt: f = {f} must be a power of two in [2, 1024], "
                         f"and g = {g} a power of two")
    _build.check_tensor(x, (B, f, g, NLIMBS), "x", x.device, align=16)
    _build.check_tensor(stw, (log_f, f // 2, NLIMBS), "stw", x.device, align=16)
    if inter is not None:
        _build.check_tensor(inter, (g, f, NLIMBS), "inter", x.device, align=16)
    if perm is not None:
        if g != 1:
            raise ValueError("mr_col_ntt: perm is for the last level (g = 1)")
        _build.check_tensor(perm, (B,), "perm", x.device)
    lib = _build.load("ntt_mr", _SIG)
    y = torch.empty((f, B, NLIMBS) if perm is not None else (B, f, g, NLIMBS),
                    dtype=torch.int32, device=x.device)
    err = lib.mr_col_ntt(
        x.data_ptr(), y.data_ptr(), stw.data_ptr(),
        inter.data_ptr() if inter is not None else None,
        perm.data_ptr() if perm is not None else None,
        B * g, log_f, log_g, LEVEL_THREADS, ctypes.byref(_build.field_consts(ctx.p_int)),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "mr_col_ntt")
    LAUNCHES["mr_col_ntt"] += 1
    return y


class MrNttPlan(CgNttPlan):
    """Mixed-radix NTT (NTT=pallas); (n, 16) -> (n, 16) Montgomery limbs.

    Levels as `PallasNttPlan._plan_levels` (`ntt_pallas.py:299-352`); the
    plan cache, the device tables and the loop over levels are CgNttPlan's,
    the level function its own."""

    MAX_LOG_F = 8

    def _plan_levels(self):
        p, r = self.ctx.p_int, self.ctx.r_int
        levels = []
        size, root = self.n, self.omega
        while size > 1:
            log_f = min(size.bit_length() - 1, self.MAX_LOG_F)
            f = 1 << log_f
            g = size // f
            w_f = pow(root, g, p)
            vals = []
            for s in range(log_f):
                m = 1 << s
                w_m = pow(w_f, f >> (s + 1), p)
                base = [1]
                for _ in range(m - 1):
                    base.append(base[-1] * w_m % p)
                vals.extend(base * (f // (2 * m)))
            stw = ints_to_limbs([v * r % p for v in vals]).reshape(log_f, f // 2, NLIMBS)
            inter = None
            if g > 1:
                # inter[j2, k1] = root^(k1 * j2) in Montgomery form
                wks = [pow(root, k1, p) for k1 in range(f)]
                cur = [r] * f
                rows = []
                for _j2 in range(g):
                    rows.extend(cur)
                    cur = [c * w % p for c, w in zip(cur, wks)]
                inter = ints_to_limbs(rows).reshape(g, f, NLIMBS)
            levels.append(dict(f=f, g=g, stw=stw, inter=inter, perm=None))
            size = g
            root = pow(root, f, p)
        if levels:
            levels[-1]["perm"] = digit_reversal([lv["f"] for lv in levels[:-1]])
        self.levels = levels

    def _level(self, x, stw, inter, perm):
        return mr_col_ntt(x, stw, inter, self.ctx, perm)
