"""Constant-geometry (Pease) NTT: the level structure and kernel 1.

Counterpart of `halo2_tpu/ops/ntt_pallas2.py`. A size-n transform is split
into levels of size f <= 2^MAX_LOG_F (n = f * g, then g recursively, the
four-step split of the reference's `fft/parallel.rs:195-255`). Level L sees
the data as a (B, f, g) array (B the product of the earlier levels' f) and
runs `cg_ntt_level`: a size-f constant-geometry NTT down every column
(b, j2) over j1,

    y[2i]   = x[i] + tw_s[i] * x[i + f/2]
    y[2i+1] = x[i] - tw_s[i] * x[i + f/2]        i < f/2,  log2(f) stages,

followed by the inter-level twiddle root^(k1 * j2). The iteration takes
natural-order input and emits bit-reversed slots (slot i holds DFT index
rev(i), verified in `_cg_stage_tables`); the level writes slot i to row
k1 = rev(i), so its (B, f, g) output is in natural k1 order and is, read as
(B f, f', g'), the next level's input. The last level (g = 1) writes row k1
of column b to k1 * B + perm[b], perm the digit reversal of b over the
earlier levels' radices, which leaves X[k1 + f0 k2 + f0 f1 k3 + ...] in
natural order. A transform is its levels' launches and nothing else.

Kernel 1 (`csrc/ntt_cg.cu`) replaces `ntt_pallas2.py::_cg_kernel`; its note
says what bounds it and what its design does about that. `cg_ntt_level`
launches it for a CUDA tensor and runs `cg_ntt_level_plain`, the same
arithmetic in torch, for a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Type

import numpy as np
import torch

from ..fields import FieldElement
from . import _build
from .field import NLIMBS, FieldCtx, add_mod, ints_to_limbs, mont_mul, sub_mod
from .ntt import bitrev_perm

LAUNCHES = {"cg_ntt_level": 0}

# Threads a block of kernel 1 at most: f/2 a column, so a block holds
# max(1, LEVEL_THREADS / (f/2)) columns (from `tools/msm_ab.py --ntt --sweep`).
LEVEL_THREADS = 32

_SIG = {
    "cg_ntt_level": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    )
}


def _cg_stage_tables(f: int, w_f: int, p: int, r: int):
    """Per-stage constant-geometry twiddles (log_f lists of f/2 Montgomery
    ints) + the slot permutation rev (output slot i holds DFT index rev[i])."""
    log_f = f.bit_length() - 1
    rev = bitrev_perm(log_f)
    pos = [int(v) for v in rev]
    stages = []
    for s in range(log_f):
        m = 1 << s
        w_m = pow(w_f, f >> (s + 1), p)
        if not all(pos[i + f // 2] == pos[i] + m and (pos[i] & m) == 0 for i in range(f // 2)):
            raise AssertionError("constant-geometry invariant")
        stages.append([pow(w_m, pos[i] % m, p) * r % p for i in range(f // 2)])
        npos = [0] * f
        for i in range(f // 2):
            npos[2 * i] = pos[i]
            npos[2 * i + 1] = pos[i] + m
        pos = npos
    if list(pos) != list(rev):
        raise AssertionError("constant-geometry slot order")
    return stages, rev


def cg_ntt_level_plain(x: torch.Tensor, stw: torch.Tensor, inter: Optional[torch.Tensor],
                       ctx: FieldCtx, perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch version of kernel 1, the same contract (`cg_ntt_level`)."""
    B, f, g, _ = x.shape
    cols = x.transpose(1, 2).reshape(B * g, f, NLIMBS)
    for s in range(stw.shape[0]):
        lo, hi = cols[:, : f // 2], cols[:, f // 2 :]
        t = mont_mul(hi, stw[s], ctx)
        cols = torch.stack([add_mod(lo, t, ctx), sub_mod(lo, t, ctx)], dim=2).reshape(cols.shape)
    if inter is not None:
        cols = mont_mul(cols, inter.repeat(B, 1, 1), ctx)  # column (b, j2) takes row j2
    rev = torch.as_tensor(bitrev_perm(f.bit_length() - 1), device=x.device)
    y = cols[:, rev]  # slot order -> k1 order
    if perm is None:
        return y.reshape(B, g, f, NLIMBS).transpose(1, 2).contiguous()
    out = torch.empty((f, B, NLIMBS), dtype=x.dtype, device=x.device)
    out[:, perm.long()] = y.transpose(0, 1)
    return out


def cg_ntt_level(x: torch.Tensor, stw: torch.Tensor, inter: Optional[torch.Tensor],
                 ctx: FieldCtx, perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One CG level down every column (b, j2) of x (B, f, g, 16) int32.

    stw: (log f, f/2, 16) stage twiddles; inter: (g, f, 16) inter-level
    twiddles in slot order (column (b, j2) takes inter[j2]) or None. Returns
    (B, f, g, 16) with row k1 of each column in natural order; with perm
    ((B,) int32, g = 1) returns (f, B, 16) with row k1 of column b at
    [k1, perm[b]]. Launches kernel 1 on a CUDA tensor; runs the plain version
    on a CPU tensor."""
    if not _build.on_card(x, "cg_ntt_level"):
        return cg_ntt_level_plain(x, stw, inter, ctx, perm)
    B, f, g, _ = x.shape
    log_f, log_g = f.bit_length() - 1, g.bit_length() - 1
    if f != 1 << log_f or log_f < 1 or log_f > 9 or g != 1 << log_g:
        raise ValueError(f"cg_ntt_level: f = {f} must be a power of two in [2, 512], "
                         f"and g = {g} a power of two")
    _build.check_tensor(x, (B, f, g, NLIMBS), "x", x.device, align=16)
    _build.check_tensor(stw, (log_f, f // 2, NLIMBS), "stw", x.device, align=16)
    if inter is not None:
        _build.check_tensor(inter, (g, f, NLIMBS), "inter", x.device, align=16)
    if perm is not None:
        if g != 1:
            raise ValueError("cg_ntt_level: perm is for the last level (g = 1)")
        _build.check_tensor(perm, (B,), "perm", x.device)
    lib = _build.load("ntt_cg", _SIG)
    y = torch.empty((f, B, NLIMBS) if perm is not None else (B, f, g, NLIMBS),
                    dtype=torch.int32, device=x.device)
    err = lib.cg_ntt_level(
        x.data_ptr(), y.data_ptr(), stw.data_ptr(),
        inter.data_ptr() if inter is not None else None,
        perm.data_ptr() if perm is not None else None,
        B * g, log_f, log_g, LEVEL_THREADS, ctypes.byref(_build.field_consts(ctx.p_int)),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "cg_ntt_level")
    LAUNCHES["cg_ntt_level"] += 1
    return y


def digit_reversal(radices) -> np.ndarray:
    """perm of the last level of a four-step plan whose earlier levels have
    sizes `radices`: its column b = (k1, k2, ...) (k1 most significant) goes to
    k1 + f0 k2 + f0 f1 k3 + ..., the digit reversal over those radices. Both
    plans split X[k1 + f k2] so, and share it."""
    perm = np.zeros(1, dtype=np.int32)
    for f in radices:
        perm = (perm[:, None] + perm.size * np.arange(f, dtype=np.int32)).reshape(-1)
    return perm


class CgNttPlan:
    """Constant-geometry NTT; (n, 16) -> (n, 16) Montgomery limbs."""

    _cache: dict = {}
    MAX_LOG_F = 8

    def __new__(cls, field: Type[FieldElement], log_n: int, omega: int):
        key = (cls, field, log_n, omega, cls.MAX_LOG_F)
        if key in cls._cache:
            return cls._cache[key]
        self = super().__new__(cls)
        cls._cache[key] = self
        self.field = field
        self.ctx = FieldCtx(field)
        self.log_n = log_n
        self.n = 1 << log_n
        self.omega = omega
        self._plan_levels()
        self._dev: dict = {}
        return self

    def _plan_levels(self):
        p, r = self.ctx.p_int, self.ctx.r_int
        levels = []
        size, root = self.n, self.omega
        while size > 1:
            log_f = min(size.bit_length() - 1, self.MAX_LOG_F)
            f = 1 << log_f
            g = size // f
            stages, rev = _cg_stage_tables(f, pow(root, g, p), p, r)
            stw = ints_to_limbs([v for st in stages for v in st]).reshape(log_f, f // 2, NLIMBS)
            inter = None
            if g > 1:
                # inter[j2, slot] = root^(rev(slot) * j2), rows in slot order
                vals = []
                wks = [pow(root, int(rev[slot]), p) for slot in range(f)]
                cur = [1] * f
                for _j2 in range(g):
                    vals.extend(c * r % p for c in cur)
                    cur = [c * w % p for c, w in zip(cur, wks)]
                inter = ints_to_limbs(vals).reshape(g, f, NLIMBS)
            levels.append(dict(f=f, g=g, stw=stw, inter=inter, perm=None))
            size = g
            root = pow(root, f, p)
        if levels:
            levels[-1]["perm"] = digit_reversal([lv["f"] for lv in levels[:-1]])
        self.levels = levels

    def _tables(self, device):
        """Every host table of every level (all but f and g) on `device`."""
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = [
                {name: None if v is None else torch.as_tensor(v, device=device)
                 for name, v in lv.items() if name not in ("f", "g")}
                for lv in self.levels
            ]
        return self._dev[device]

    def _level(self, x, stw, inter, perm):
        """One level in the (B, f, g) contract: kernel 1 here, kernel 8 in MrNttPlan."""
        return cg_ntt_level(x, stw, inter, self.ctx, perm)

    def __call__(self, a: torch.Tensor) -> torch.Tensor:
        if tuple(a.shape) != (self.n, NLIMBS):
            raise ValueError(f"{type(self).__name__}: expected ({self.n}, 16), got {tuple(a.shape)}")
        x = a.contiguous()
        for lv, tab in zip(self.levels, self._tables(a.device)):
            f, g = lv["f"], lv["g"]
            x = self._level(x.reshape(self.n // (f * g), f, g, NLIMBS), tab["stw"], tab["inter"],
                            tab["perm"])
        return x.reshape(self.n, NLIMBS)

    def many(self, a: torch.Tensor) -> torch.Tensor:
        """(nb, n, 16) -> (nb, n, 16): the transform of each row, as the same
        levels' launches with nb times the columns. A level's columns are
        independent, so transform t's columns follow transform t - 1's; the
        last level writes column t Bs + b to row k1 of slot t Bs + perm[b]
        (Bs its columns a transform), and one copy puts each transform's
        rows together."""
        nb = a.shape[0]
        if tuple(a.shape[1:]) != (self.n, NLIMBS):
            raise ValueError(f"{type(self).__name__}.many: expected (B, {self.n}, 16), "
                             f"got {tuple(a.shape)}")
        x = a.contiguous()
        for lv, tab in zip(self.levels, self._tables(a.device)):
            f, g = lv["f"], lv["g"]
            perm = tab["perm"]
            if perm is not None:
                offs = torch.arange(nb, dtype=perm.dtype, device=perm.device) * perm.numel()
                perm = (offs[:, None] + perm[None, :]).reshape(-1)
            x = self._level(x.reshape(nb * self.n // (f * g), f, g, NLIMBS), tab["stw"],
                            tab["inter"], perm)
        f = self.levels[-1]["f"] if self.levels else 1
        return x.reshape(f, nb, self.n // f, NLIMBS).transpose(0, 1).reshape(nb, self.n, NLIMBS)
