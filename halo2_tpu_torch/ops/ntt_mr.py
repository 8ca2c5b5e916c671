"""Mixed-radix (four-step) NTT with radix-2 column transforms: kernel 8.

Counterpart of `halo2_tpu/ops/ntt_pallas.py` (`PallasNttPlan`, the engine of
`NTT=pallas`). A size-n transform is split into levels of size
f = 2^min(log size, 8): n = f * g, then g recursively with the root raised
to the f. With j = j1 * g + j2 and one column per (b, j2),

    Y[k1, j2]        = (sum_j1 w_f^(j1 k1) x[j1 g + j2]) * root^(k1 j2)
    X[k1 + f k2]     = NTT_g over j2 of Y[k1, :]

Each level runs `mr_col_ntt` on every column: the rows j1 are read in
bit-reversed order, log2(f) radix-2 decimation-in-time stages (stage s
pairs rows m = 2^s apart and multiplies by w_2m^pos; stage 0's twiddles are
all 1, so it multiplies nothing) leave the rows in natural k1 order, and
the inter-level twiddle root^(k1 j2) is applied when g > 1. The four-step
recursion (`MrNttPlan._ntt_cols`) runs the transposes between levels in
torch, as the constant-geometry plan did before its kernel took them over.

Layout between levels: columns outermost, (cols, f, 16) int32. Column c
takes inter-level twiddle row j2 = c mod g of an (g, f, 16) table. The
TPU's 128-lane tiling of that table (`ntt_pallas.py:326-343, 376-389`) is
not carried over: its comment records wrong transforms when the second
factor exceeded 2^8; here the period is g whatever the batch.

Kernel 8 (`csrc/ntt_mr.cu`) replaces `ntt_pallas.py::_col_ntt_kernel`.
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
from .ntt_cg import CgNttPlan

LAUNCHES = {"mr_col_ntt": 0}

_SIG = {
    "mr_col_ntt": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p,
    )
}


def mr_col_ntt_plain(x: torch.Tensor, stw: torch.Tensor, inter: Optional[torch.Tensor],
                     ctx: FieldCtx) -> torch.Tensor:
    """Plain torch version of kernel 8: x (cols, f, 16), rows j1 natural ->
    rows k1 natural, times inter[c mod g] when inter is given."""
    cols, f, _ = x.shape
    log_f = f.bit_length() - 1
    x = x[:, torch.as_tensor(bitrev_perm(log_f), device=x.device)]
    for s in range(log_f):
        m = 1 << s
        blocks = x.reshape(cols, f // (2 * m), 2, m, NLIMBS)
        lo, hi = blocks[:, :, 0], blocks[:, :, 1]
        t = hi if s == 0 else mont_mul(hi, stw[s].reshape(f // (2 * m), m, NLIMBS), ctx)
        x = torch.stack([add_mod(lo, t, ctx), sub_mod(lo, t, ctx)], dim=2).reshape(cols, f, NLIMBS)
    if inter is not None:
        idx = torch.arange(cols, device=x.device) % inter.shape[0]
        x = mont_mul(x, inter[idx], ctx)
    return x


def mr_col_ntt(x: torch.Tensor, stw: torch.Tensor, inter: Optional[torch.Tensor],
               ctx: FieldCtx) -> torch.Tensor:
    """One mixed-radix level over every column of x (cols, f, 16) int32.

    stw: (log f, f/2, 16) stage twiddles, stage s holding its m = 2^s base
    twiddles repeated f/2m times; inter: (g, f, 16) inter-level twiddles
    (column c takes inter[c mod g]) or None. Launches kernel 8 on a CUDA
    tensor; runs the plain version on a CPU tensor."""
    if not _build.on_card(x, "mr_col_ntt"):
        return mr_col_ntt_plain(x, stw, inter, ctx)
    cols, f, _ = x.shape
    log_f = f.bit_length() - 1
    if f != 1 << log_f or log_f < 1 or log_f > 10:
        raise ValueError(f"mr_col_ntt: f = {f} must be a power of two in [2, 1024]")
    _build.check_tensor(x, (cols, f, NLIMBS), "x", x.device)
    _build.check_tensor(stw, (log_f, f // 2, NLIMBS), "stw", x.device)
    g = 1
    if inter is not None:
        g = inter.shape[0]
        _build.check_tensor(inter, (g, f, NLIMBS), "inter", x.device)
    lib = _build.load("ntt_mr", _SIG)
    y = torch.empty_like(x)
    err = lib.mr_col_ntt(
        x.data_ptr(), y.data_ptr(), stw.data_ptr(),
        inter.data_ptr() if inter is not None else None,
        cols, log_f, g, ctypes.byref(_build.field_consts(ctx.p_int)),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "mr_col_ntt")
    LAUNCHES["mr_col_ntt"] += 1
    return y


class MrNttPlan(CgNttPlan):
    """Mixed-radix NTT (NTT=pallas); (n, 16) -> (n, 16) Montgomery limbs.

    Levels as `PallasNttPlan._plan_levels` (`ntt_pallas.py:299-352`); the
    plan cache and device tables are CgNttPlan's, the recursion its own."""

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
            levels.append(dict(f=f, g=g, stw=stw, inter=inter))
            size = g
            root = pow(root, f, p)
        self.levels = levels

    def _ntt_cols(self, x: torch.Tensor, level_idx: int, tabs) -> torch.Tensor:
        """x: (B, size, 16) -> NTT of every row block, natural in/out order."""
        lvl, tab = self.levels[level_idx], tabs[level_idx]
        f, g = lvl["f"], lvl["g"]
        B = x.shape[0]
        # split j = j1*g + j2; one column per (b, j2) holding the f values j1
        cols = x.reshape(B, f, g, NLIMBS).transpose(1, 2).reshape(B * g, f, NLIMBS).contiguous()
        y = mr_col_ntt(cols, tab["stw"], tab["inter"], self.ctx)
        if g == 1:
            return y.reshape(B, f, NLIMBS)
        # (b, j2, k1) -> (b, k1, j2): the remaining g-point transforms over j2
        z = y.reshape(B, g, f, NLIMBS).transpose(1, 2).reshape(B * f, g, NLIMBS)
        z = self._ntt_cols(z, level_idx + 1, tabs)  # (B*f, g[k2], 16)
        # X[k2 * f + k1]
        return z.reshape(B, f, g, NLIMBS).transpose(1, 2).reshape(B, g * f, NLIMBS)

    def __call__(self, a: torch.Tensor) -> torch.Tensor:
        if tuple(a.shape) != (self.n, NLIMBS):
            raise ValueError(f"{type(self).__name__}: expected ({self.n}, 16), got {tuple(a.shape)}")
        tabs = self._tables(a.device)
        return self._ntt_cols(a.reshape(1, self.n, NLIMBS), 0, tabs).reshape(self.n, NLIMBS)
