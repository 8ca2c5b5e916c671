"""Montgomery multiplication by a constant as exact matrix products (NTT=mxu).

Counterpart of `halo2_tpu/ops/mxu_mont.py`. The name is kept because
`NTT=mxu` names it: "MXU" is the TPU's matrix unit, and here the products
run on the card's tensor cores. Every multiply of an NTT stage is by a
constant twiddle c, so the schoolbook product a * c is one matrix product
with a precomputed Toeplitz operand over 4-bit limbs ("nibbles"):

    cols[..., k] = sum_i T_c[k, i] * nib_i(a),      T_c[k, i] = nib_{k-i}(c)

with 64 nibbles per value and 127 product columns. REDC with the constant
modulus is two more Toeplitz products (by N' truncated to 64 columns, by p
full width). Between them, carries are relaxed column-parallel
(col <- (col & 15) + (col_below >> 4)), so every matrix operand is a small
non-negative integer: nibbles <= 15, relaxed columns < 17.

Exactness: a product is <= 15 * 17 = 255 and a column sums at most 64 of
them, <= 16320 < 2^24. `MXU_DTYPE` picks the operand type, read at each
call as the JAX package reads it (`mxu_mont.py:126-132`):

- "bf16" (default): bf16 operands hold 0..256 exactly, and the product is
  taken with a float32 output and float32 accumulation
  (`torch.mm` / `torch.bmm` with `out_dtype=torch.float32`), exact below
  2^24. A plain bf16 matmul returns bf16, which rounds such sums; no
  global torch flag is read or changed.
- "int8": int8 operands (all below 128) into int32 with `torch._int_mm`,
  which is 2-D only: a batch of constants is one product per constant.

On a CPU tensor every contraction is an int64 matrix product, the exact
plain version; `chip_smoke.py` holds both card dtypes against it. These
products are plain matrix products, as the JAX package leaves them to XLA:
the module has no kernel of its own.

Results: `MxuConstMul` / `mont_mul_const` take canonical values below p and
return REDC(a * c) below p; `mont_mul_const_batched` takes lazy values below
2p and returns values below 2p, as the NTT's add and sub expect.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Optional, Type

import numpy as np
import torch
import torch.nn.functional as F

from ..fields import FieldElement
from .field import NLIMBS, FieldCtx, _norm, _reduce, _to16, add_mod, ints_to_limbs, mont_mul, sub_mod
from .ntt import bitrev_perm

NNIB = 4 * NLIMBS  # 64 nibbles
NCOLS = 2 * NNIB - 1  # 127 product columns
DTYPES = ("bf16", "int8")


def mxu_dtype() -> str:
    """The operand type of the card's products, from MXU_DTYPE."""
    v = os.environ.get("MXU_DTYPE", "bf16")
    if v not in DTYPES:
        raise ValueError(f"MXU_DTYPE={v!r}: expected one of {DTYPES}")
    return v


def to_nibbles(a: torch.Tensor) -> torch.Tensor:
    """(..., 16) 16-bit limbs -> (..., 64) int64 nibbles, nibble 4i + j of
    limb i at index 4i + j."""
    a = a.to(torch.int64)
    parts = torch.stack([(a >> (4 * j)) & 0xF for j in range(4)], dim=-1)
    return parts.reshape(*a.shape[:-1], NNIB)


def toeplitz(value: int, out_cols: int) -> np.ndarray:
    """(out_cols, 64) int8 matrix T[k, i] = nibble_{k-i}(value)."""
    nibs = np.asarray([(value >> (4 * i)) & 0xF for i in range(NNIB)], np.int8)
    d = np.arange(out_cols)[:, None] - np.arange(NNIB)[None, :]
    return np.where((d >= 0) & (d < NNIB), nibs[np.clip(d, 0, NNIB - 1)], 0).astype(np.int8)


class _Operand:
    """A Toeplitz table (..., C, 64) kept on the host and, per device and
    operand type, transposed to (..., 64, C') with C' = C rounded up to 8
    (`torch._int_mm` needs it)."""

    def __init__(self, table: np.ndarray):
        self.table = table
        self.cols = table.shape[-2]
        self._dev: dict = {}

    def on(self, device: torch.device, kind: str) -> torch.Tensor:
        key = (device, kind)
        if key not in self._dev:
            pad = -self.cols % 8
            t = np.swapaxes(self.table, -1, -2)
            t = np.pad(t, [(0, 0)] * (t.ndim - 1) + [(0, pad)])
            dtype = {"int64": torch.int64, "bf16": torch.bfloat16, "int8": torch.int8}[kind]
            self._dev[key] = torch.as_tensor(t.astype(np.int64), device=device).to(dtype).contiguous()
        return self._dev[key]


def _mm(x: torch.Tensor, w: torch.Tensor, kind: str) -> torch.Tensor:
    """x (N, 64) int64 small non-negative, w (64, C') -> (N, C') int64, exact."""
    if kind == "int64":
        return x @ w
    if kind == "bf16":
        return torch.mm(x.to(torch.bfloat16), w, out_dtype=torch.float32).to(torch.int64)
    n = x.shape[0]
    rows = max(32, -(-n // 8) * 8)  # torch._int_mm wants more than 16 rows, a multiple of 8
    xi = F.pad(x.to(torch.int8), (0, 0, 0, rows - n))
    return torch._int_mm(xi, w)[:n].to(torch.int64)


def _contract(x: torch.Tensor, op: _Operand, kind: Optional[str] = None) -> torch.Tensor:
    """out[..., k] = sum_i T[k, i] * x[..., i], exactly, for op's table T
    (C, 64); for a batch of tables (J, C, 64), x is (..., J, 64) and row j
    takes table j. Returns int64 (..., C). `kind` is the operand type:
    int64 on a CPU tensor and MXU_DTYPE on a CUDA one unless given."""
    if kind is None:
        kind = "int64" if x.device.type == "cpu" else mxu_dtype()
    w = op.on(x.device, kind)
    if w.dim() == 2:
        out = _mm(x.reshape(-1, NNIB), w, kind)
    else:
        J = w.shape[0]
        xb = x.reshape(-1, J, NNIB).transpose(0, 1)  # (J, N, 64)
        if kind == "int64":
            out = torch.bmm(xb, w)
        elif kind == "bf16":
            out = torch.bmm(xb.to(torch.bfloat16), w, out_dtype=torch.float32).to(torch.int64)
        else:
            out = torch.stack([_mm(xb[j], w[j], kind) for j in range(J)])
        out = out.transpose(0, 1)
    return out[..., : op.cols].reshape(*x.shape[:-1], op.cols)


def _relax(cols: torch.Tensor, rounds: int) -> torch.Tensor:
    """Column-parallel carry relaxation along the last axis, the carry out
    of the top column dropped: each round divides the excess over 16 by 16."""
    for _ in range(rounds):
        cols = (cols & 0xF) + F.pad((cols >> 4)[..., :-1], (1, 0))
    return cols


@lru_cache(maxsize=None)
def _redc_operands(field: Type[FieldElement]):
    """Per-field REDC operands: N' mod R (64 columns) and p (127)."""
    ctx = FieldCtx(field)
    return ctx, _Operand(toeplitz(ctx.nprime_int, NNIB)), _Operand(toeplitz(ctx.p_int, NCOLS))


def _redc(t_cols: torch.Tensor, field: Type[FieldElement]) -> torch.Tensor:
    """(..., 127) exact product columns of t = a * c -> REDC(t), one
    conditional subtraction of p applied, as (..., 16) limbs."""
    ctx, t_np, t_p = _redc_operands(field)
    # five rounds leave every column below 17: small matrix operands
    t_nib = _relax(t_cols[..., :NNIB], 5)  # t mod R
    m_nib = _relax(_contract(t_nib, t_np), 5)  # m = t N' mod R
    total = t_cols + _contract(m_nib, t_p)  # t + m p, a multiple of R
    total = _relax(F.pad(total, (0, 2 * NNIB + 1 - NCOLS)), 5)  # 129 columns < 32
    # 8 nibble columns per 32-bit digit column (< 2^34), then exact digits
    grp = F.pad(total, (0, 8 * 17 - total.shape[-1])).reshape(*total.shape[:-1], 17, 8)
    digits = (grp << (4 * torch.arange(8, device=grp.device))).sum(-1)
    r = _norm(digits, 17)[..., 8:16]  # (t + m p) / R
    return _to16(_reduce(F.pad(r, (0, 1)), 0, "neg_p", ctx))


class MxuConstMul:
    """REDC(a * c) for a fixed (field, c): three Toeplitz products."""

    _cache: dict = {}

    def __new__(cls, field: Type[FieldElement], c_mont: int):
        key = (field, c_mont)
        if key in cls._cache:
            return cls._cache[key]
        self = super().__new__(cls)
        cls._cache[key] = self
        self.field = field
        self.t_c = _Operand(toeplitz(c_mont, NCOLS))
        return self

    def __call__(self, a: torch.Tensor) -> torch.Tensor:
        """a: (..., 16) canonical Montgomery limbs -> REDC(a * c) below p."""
        return _redc(_contract(to_nibbles(a), self.t_c), self.field)


def mont_mul_const(field: Type[FieldElement], a: torch.Tensor, c_mont: int) -> torch.Tensor:
    """(n, 16) canonical Montgomery limbs -> REDC(a * c_mont), (n, 16)."""
    return MxuConstMul(field, c_mont)(a)


def mont_mul_const_batched(field: Type[FieldElement], a: torch.Tensor, t_c: _Operand) -> torch.Tensor:
    """REDC(a * c_j) for a (..., m, 16) lazy limbs below 2p and a batch of
    m Toeplitz constants t_c (table (m, 127, 64)); returns (..., m, 16)
    below 2p."""
    return _redc(_contract(to_nibbles(a), t_c), field)


class MxuNttPlan:
    """NTT with the stage-twiddle products as Toeplitz matrix products.

    The mixed-radix levels of `MrNttPlan` (f <= 2^8), at the tensor level
    as in the JAX package: each stage's m distinct twiddles are a stack of
    Toeplitz operands (`mont_mul_const_batched`); the inter-level twiddles,
    one per element with no constant structure, take the plain limb product
    (`ops/field.py`). Layout (rows, batch, 16), rows outermost, as
    `mxu_mont.py:340-462`."""

    _cache: dict = {}
    MAX_LOG_F = 8

    def __new__(cls, field: Type[FieldElement], log_n: int, omega: int):
        key = (field, log_n, omega)
        if key in cls._cache:
            return cls._cache[key]
        self = super().__new__(cls)
        cls._cache[key] = self
        self.field = field
        self.ctx = FieldCtx(field)
        self.log_n = log_n
        self.n = 1 << log_n
        p, r = self.ctx.p_int, self.ctx.r_int
        levels = []
        size, root = self.n, omega
        while size > 1:
            log_f = min(size.bit_length() - 1, self.MAX_LOG_F)
            f = 1 << log_f
            g = size // f
            w_f = pow(root, g, p)
            stage_ts = [None]  # stage 0 multiplies by 1
            for s in range(1, log_f):
                w_m = pow(w_f, f >> (s + 1), p)
                tw = [r]
                for _ in range((1 << s) - 1):
                    tw.append(tw[-1] * w_m % p)
                stage_ts.append(_Operand(np.stack([toeplitz(t, NCOLS) for t in tw])))
            inter = None
            if g > 1:  # inter[k1, j2] = root^(k1 * j2) in Montgomery form
                vals = []
                for k1 in range(f):
                    wk, cur = pow(root, k1, p), r
                    for _ in range(g):
                        vals.append(cur)
                        cur = cur * wk % p
                inter = ints_to_limbs(vals).reshape(f, g, 1, NLIMBS)
            levels.append(dict(f=f, g=g, log_f=log_f, stage_ts=stage_ts, inter=inter,
                               perm=bitrev_perm(log_f)))
            size = g
            root = pow(root, f, p)
        self.levels = levels
        self._dev: dict = {}
        return self

    def _inter(self, li: int, device: torch.device) -> torch.Tensor:
        key = (li, device)
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self.levels[li]["inter"], device=device)
        return self._dev[key]

    def _col_ntt(self, x: torch.Tensor, lvl) -> torch.Tensor:
        """(f, M, 16) bit-reversed rows -> all radix-2 stages, natural out."""
        f, M = lvl["f"], x.shape[1]
        for s in range(lvl["log_f"]):
            m = 1 << s
            blocks = x.reshape(f // (2 * m), 2, m, M, NLIMBS)
            lo, hi = blocks[:, 0], blocks[:, 1]
            if s == 0:
                t = hi
            else:  # the twiddle index j next to the limb axis: (blk, M, m, 16)
                t = mont_mul_const_batched(self.field, hi.transpose(1, 2), lvl["stage_ts"][s])
                t = t.transpose(1, 2)
            x = torch.stack([add_mod(lo, t, self.ctx), sub_mod(lo, t, self.ctx)], dim=1)
            x = x.reshape(f, M, NLIMBS)
        return x

    def _ntt_axis0(self, x: torch.Tensor, li: int) -> torch.Tensor:
        """x (size, B, 16) -> NTT over axis 0, natural in/out order."""
        lvl = self.levels[li]
        f, g = lvl["f"], lvl["g"]
        B = x.shape[1]
        x = x.reshape(f, g, B, NLIMBS)[torch.as_tensor(lvl["perm"], device=x.device)]
        y = self._col_ntt(x.reshape(f, g * B, NLIMBS), lvl)
        if g == 1:
            return y.reshape(f, B, NLIMBS)
        y = mont_mul(y.reshape(f, g, B, NLIMBS), self._inter(li, x.device), self.ctx)
        y = y.transpose(0, 1).reshape(g, f * B, NLIMBS)
        z = self._ntt_axis0(y, li + 1)  # (g = k2, (k1, b), 16)
        return z.reshape(g * f, B, NLIMBS)

    def __call__(self, a: torch.Tensor) -> torch.Tensor:
        if tuple(a.shape) != (self.n, NLIMBS):
            raise ValueError(f"MxuNttPlan: expected ({self.n}, 16), got {tuple(a.shape)}")
        return self._ntt_axis0(a.reshape(self.n, 1, NLIMBS), 0).reshape(self.n, NLIMBS)
