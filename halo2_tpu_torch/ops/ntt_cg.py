"""Constant-geometry (Pease) NTT: the level structure and kernel 1.

Counterpart of `halo2_tpu/ops/ntt_pallas2.py`. A size-n transform is split
into levels of size f <= 2^MAX_LOG_F (n = f * g, then g recursively, the
four-step split of the reference's `fft/parallel.rs:195-255`). Each level
runs `cg_ntt_level`: a size-f constant-geometry NTT on every column,

    y[2i]   = x[i] + tw_s[i] * x[i + f/2]
    y[2i+1] = x[i] - tw_s[i] * x[i + f/2]        i < f/2,  log2(f) stages,

followed by the inter-level twiddle root^(k1 * j2). The iteration takes
natural-order input and emits bit-reversed slots (slot i holds DFT index
rev(i), verified in `_cg_stage_tables`); the wrapper gathers the slots back
and does the transposes between levels in torch.

Layout between levels (the wrapper's choice): columns outermost, (cols, f,
16) int32, so each column's f elements are contiguous for the kernel.

Kernel 1 (`csrc/ntt_cg.cu`) replaces `ntt_pallas2.py::_cg_kernel`. It keeps a
column in shared memory for all log2(f) stages and is bound by integer
multiply throughput (see the source note). `cg_ntt_level` launches it for a
CUDA tensor and runs `cg_ntt_level_plain`, the same arithmetic in torch,
for a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Type

import torch

from ..fields import FieldElement
from . import _build
from .field import NLIMBS, FieldCtx, add_mod, ints_to_limbs, mont_mul, sub_mod
from .ntt import bitrev_perm

LAUNCHES = {"cg_ntt_level": 0}

_SIG = {
    "cg_ntt_level": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
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
                       ctx: FieldCtx) -> torch.Tensor:
    """Plain torch version of kernel 1: x (cols, f, 16) -> slot-order rows."""
    cols, f, _ = x.shape
    for s in range(stw.shape[0]):
        lo, hi = x[:, : f // 2], x[:, f // 2 :]
        t = mont_mul(hi, stw[s], ctx)
        x = torch.stack([add_mod(lo, t, ctx), sub_mod(lo, t, ctx)], dim=2).reshape(cols, f, NLIMBS)
    if inter is not None:
        g = inter.shape[0]
        idx = torch.arange(cols, device=x.device) % g
        x = mont_mul(x, inter[idx], ctx)
    return x


def cg_ntt_level(x: torch.Tensor, stw: torch.Tensor, inter: Optional[torch.Tensor],
                 ctx: FieldCtx) -> torch.Tensor:
    """One CG level over every column of x (cols, f, 16) int32.

    stw: (log f, f/2, 16) stage twiddles; inter: (g, f, 16) inter-level
    twiddles (column j takes inter[j mod g]) or None. Launches kernel 1 on
    a CUDA tensor; runs the plain version on a CPU tensor."""
    if not _build.on_card(x, "cg_ntt_level"):
        return cg_ntt_level_plain(x, stw, inter, ctx)
    cols, f, _ = x.shape
    log_f = f.bit_length() - 1
    if f != 1 << log_f or log_f < 1 or log_f > 10:
        raise ValueError(f"cg_ntt_level: f = {f} must be a power of two in [2, 1024]")
    _build.check_tensor(x, (cols, f, NLIMBS), "x", x.device)
    _build.check_tensor(stw, (log_f, f // 2, NLIMBS), "stw", x.device)
    g = 1
    if inter is not None:
        g = inter.shape[0]
        _build.check_tensor(inter, (g, f, NLIMBS), "inter", x.device)
    lib = _build.load("ntt_cg", _SIG)
    consts = _build.field_consts(ctx.p_int)
    y = torch.empty_like(x)
    err = lib.cg_ntt_level(
        x.data_ptr(), y.data_ptr(), stw.data_ptr(),
        inter.data_ptr() if inter is not None else None,
        cols, log_f, g, ctypes.byref(consts), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "cg_ntt_level")
    LAUNCHES["cg_ntt_level"] += 1
    return y


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
            levels.append(dict(f=f, g=g, stw=stw, inter=inter, rev=rev))
            size = g
            root = pow(root, f, p)
        self.levels = levels

    def _tables(self, device):
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = [
                dict(
                    stw=torch.as_tensor(lv["stw"], device=device),
                    inter=None if lv["inter"] is None else torch.as_tensor(lv["inter"], device=device),
                    rev=torch.as_tensor(lv["rev"], device=device),
                )
                for lv in self.levels
            ]
        return self._dev[device]

    def _ntt_cols(self, x: torch.Tensor, level_idx: int, tabs) -> torch.Tensor:
        """x: (B, size, 16) -> NTT of every row block, natural in/out order."""
        lvl, tab = self.levels[level_idx], tabs[level_idx]
        f, g = lvl["f"], lvl["g"]
        B = x.shape[0]
        # split j = j1*g + j2; one column per (b, j2) holding the f values j1
        cols = x.reshape(B, f, g, NLIMBS).transpose(1, 2).reshape(B * g, f, NLIMBS).contiguous()
        y = cg_ntt_level(cols, tab["stw"], tab["inter"], self.ctx)
        y = y[:, tab["rev"]]  # slot order -> k1 order
        if g == 1:
            return y.reshape(B, f, NLIMBS)
        # (b, j2, k1) -> (b, k1, j2): the remaining g-point transforms over j2
        z = y.reshape(B, g, f, NLIMBS).transpose(1, 2).reshape(B * f, g, NLIMBS)
        z = self._ntt_cols(z, level_idx + 1, tabs)  # (B*f, g[k2], 16)
        # X[k2 * f + k1]
        return z.reshape(B, f, g, NLIMBS).transpose(1, 2).reshape(B, g * f, NLIMBS)

    def __call__(self, a: torch.Tensor) -> torch.Tensor:
        if tuple(a.shape) != (self.n, NLIMBS):
            raise ValueError(f"CgNttPlan: expected ({self.n}, 16), got {tuple(a.shape)}")
        tabs = self._tables(a.device)
        return self._ntt_cols(a.reshape(1, self.n, NLIMBS), 0, tabs).reshape(self.n, NLIMBS)
