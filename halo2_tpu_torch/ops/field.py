"""Batched prime-field arithmetic over 16-bit limb tensors in PyTorch.

Counterpart of `halo2_tpu/ops/limbs.py` + `halo2_tpu/ops/field_jax.py`.
Every public function takes and returns (..., 16) `torch.int32` tensors of
16-bit little-endian limbs (values in [0, 2^16)) holding Montgomery residues
x*R mod p with R = 2^256, reduced lazily to [0, 2p) exactly as the JAX
package does, so the Montgomery values are the same numbers in both.

Inside a function the limbs are repacked into 8 digits of 32 bits held in
`torch.int64`. A digit product is taken with 64-bit wraparound, which keeps
its exact unsigned bits, and split into 32-bit halves with shift-and-mask;
the halves are summed into product columns by one float64 matrix product
with a 0/1 matrix (exact: a column of 16 halves stays below 2^36 < 2^53).
Carries are resolved without a serial loop: two shift-and-add passes leave
every column in [0, 2^32], and the one-bit ripple that is left is read off a
running maximum (`cummax`) of the last position that does not propagate a
carry. Comparisons against p or 2p never read a wrapped sign bit: they add
the two's complement of the constant and read the carry out of the top
digit.

These are the plain tensor ops the prover runs on whatever device its
tensors live on; the hand-written CUDA kernels carry their own copy of the
arithmetic in `csrc/field.cuh`.
"""

from __future__ import annotations

from typing import List, Sequence, Type

import numpy as np
import torch
import torch.nn.functional as F

from ..fields import FieldElement

NLIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
I32 = torch.int32
I64 = torch.int64


# ---------------- host packing ----------------


def int_to_limbs(v: int) -> np.ndarray:
    """One 256-bit integer -> (16,) int32 limb vector."""
    return np.frombuffer(v.to_bytes(32, "little"), dtype="<u2").astype(np.int32)


def ints_to_limbs(vals: Sequence[int]) -> np.ndarray:
    """Batch of integers -> (n, 16) int32 limbs."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").reshape(len(vals), NLIMBS).astype(np.int32)


def limbs_to_ints(arr) -> List[int]:
    """(n, 16) limbs (numpy or tensor) -> list of integers."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    raw = np.ascontiguousarray(np.asarray(arr).astype("<u2")).tobytes()
    return [int.from_bytes(raw[32 * i : 32 * i + 32], "little") for i in range(len(raw) // 32)]


M32 = (1 << 32) - 1


def _digits(v: int, n: int) -> np.ndarray:
    """v as n little-endian 32-bit digits (int64)."""
    return np.frombuffer(v.to_bytes(4 * n, "little"), dtype="<u4").astype(np.int64)


class FieldCtx:
    """Per-modulus constants for limb arithmetic, cached per field class.

    Constant tensors are made once per device on first use."""

    _cache: dict = {}

    def __new__(cls, field: Type[FieldElement]):
        if field in cls._cache:
            return cls._cache[field]
        self = super().__new__(cls)
        cls._cache[field] = self
        p = field.MODULUS
        self.field = field
        self.p_int = p
        self.nprime_int = (-pow(p, -1, 1 << 256)) % (1 << 256)
        self.r_int = (1 << 256) % p
        self.r2_int = (self.r_int * self.r_int) % p
        e = p - 2
        self.inv_exp_bits = [(e >> i) & 1 for i in range(e.bit_length() - 1, -1, -1)]
        self._host = {
            "p": _digits(p, 8),
            "twop": _digits(2 * p, 8),
            "nprime": _digits(self.nprime_int, 8),
            # 2^288 - 2p and 2^288 - p in 9 digits: adding one and reading
            # the carry out of digit 8 tells whether a value is >= 2p (or p)
            "neg_twop": _digits((1 << 288) - 2 * p, 9),
            "neg_p": _digits((1 << 288) - p, 9),
        }
        self._dev: dict = {}
        return self

    def k(self, name: str, device) -> torch.Tensor:
        """Constant digit vector `name` as int64 on `device`."""
        device = torch.device(device)
        key = (name, device)
        t = self._dev.get(key)
        if t is None:
            t = torch.as_tensor(self._host[name], dtype=I64, device=device)
            self._dev[key] = t
        return t

    # ---------------- host <-> device conversion ----------------
    def one(self, device) -> torch.Tensor:
        return torch.as_tensor(int_to_limbs(self.r_int), device=device)

    def to_mont(self, x: torch.Tensor) -> torch.Tensor:
        """Canonical limbs -> Montgomery limbs (multiply by R^2, REDC)."""
        r2 = torch.as_tensor(int_to_limbs(self.r2_int), device=x.device)
        return mont_mul(x, r2, self)

    def from_mont(self, x: torch.Tensor) -> torch.Tensor:
        return from_mont(x, self)

    def encode_ints(self, vals, device) -> torch.Tensor:
        """Python ints -> (n, 16) Montgomery limbs on `device`."""
        return self.consts(vals, device)

    def encode_elems(self, elems, device) -> torch.Tensor:
        return self.encode_ints([e.v for e in elems], device)

    def decode_ints(self, x: torch.Tensor) -> List[int]:
        """Montgomery limbs -> canonical Python ints (one readback)."""
        canon = from_mont(x, self).reshape(-1, NLIMBS)
        return limbs_to_ints(canon)

    def decode(self, x: torch.Tensor) -> list:
        return [self.field(v) for v in self.decode_ints(x)]

    def const(self, v: int, device) -> torch.Tensor:
        """Single constant in Montgomery form, shape (16,)."""
        return torch.as_tensor(
            int_to_limbs((v % self.p_int) * self.r_int % self.p_int), device=device
        )

    def consts(self, vals, device) -> torch.Tensor:
        """Constants in Montgomery form, shape (n, 16) (host-side packing)."""
        p, r = self.p_int, self.r_int
        return torch.as_tensor(
            ints_to_limbs([(v % p) * r % p for v in vals]), device=device
        )

    # convenience wrappers (the JAX package's jitted ctx.mul / ctx.add ...)
    def mul(self, a, b):
        return mont_mul(a, b, self)

    def add(self, a, b):
        return add_mod(a, b, self)

    def sub(self, a, b):
        return sub_mod(a, b, self)

    def neg(self, a):
        return neg_mod(a, self)

    def inv(self, a):
        return inv_mod(a, self)


# ---------------- internal digit helpers (int64, 32-bit digits) ----------------


def _to32(a: torch.Tensor) -> torch.Tensor:
    """(..., 16) 16-bit limbs -> (..., 8) int64 32-bit digits."""
    x = a.to(I64).reshape(*a.shape[:-1], 8, 2)
    return x[..., 0] + (x[..., 1] << LIMB_BITS)


def _to16(d: torch.Tensor) -> torch.Tensor:
    """(..., 8) 32-bit digits -> (..., 16) int32 16-bit limbs."""
    x = torch.stack([d & LIMB_MASK, d >> LIMB_BITS], dim=-1)
    return x.reshape(*d.shape[:-1], NLIMBS).to(I32)


def _shift_up(x: torch.Tensor, d: int) -> torch.Tensor:
    """out[..., k] = x[..., k - d] (zero below d) along the last axis."""
    return torch.constant_pad_nd(x[..., :-d], (d, 0))


_tables: dict = {}


def _table(name: str, n: int, device) -> torch.Tensor:
    """Cached index tables: "pos" = arange(n) (int64); "cols" = the (2*64, 16)
    float64 0/1 matrix sending the low (high) half of a_i b_j to column
    i+j (i+j+1)."""
    key = (name, n, torch.device(device))
    t = _tables.get(key)
    if t is None:
        if name == "pos":
            t = torch.arange(n, dtype=I64, device=device)
        else:
            m = np.zeros((2, 8, 8, 16), dtype=np.float64)
            for h in range(2):
                for i in range(8):
                    for j in range(8):
                        if i + j + h < 16:
                            m[h, i, j, i + j + h] = 1.0
            t = torch.as_tensor(m.reshape(128, 16), device=device)
        _tables[key] = t
    return t


def _norm(c: torch.Tensor, nout: int) -> torch.Tensor:
    """Exact digits of sum_k c_k 2^(32k) mod 2^(32 nout).

    c: (..., m) int64 columns, each in [0, 2^40). Returns (..., nout) int64
    digits in [0, 2^32)."""
    m = c.shape[-1]
    if m > nout:
        c = c[..., :nout]
    elif m < nout:
        c = F.pad(c, (0, nout - m))
    # two passes: < 2^40 -> < 2^32 + 2^8 -> <= 2^32
    for _ in range(2):
        c = (c & M32) + _shift_up(c >> 32, 1)
    # digit k passes a carry on iff it is 2^32 - 1 and one arrives; the carry
    # out of k is therefore the "generate" bit (c == 2^32) of the last digit
    # at or below k that is not 2^32 - 1
    pos = _table("pos", nout, c.device)
    last = torch.where(c == M32, -1, pos).cummax(-1).values
    carry = torch.gather(c >> 32, -1, last.clamp(min=0)) * (last >= 0)
    return (c + _shift_up(carry, 1)) & M32


def _mul_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns of two (..., 8) digit vectors -> (..., 16):
    column k sums the low halves of a_i b_j with i+j = k and the high
    halves with i+j = k-1 (< 2^36 each)."""
    prod = a.unsqueeze(-1) * b.unsqueeze(-2)  # (..., 8, 8), exact mod 2^64
    halves = torch.stack([prod, prod >> 32], dim=-3) & M32  # (..., 2, 8, 8)
    flat = halves.reshape(*halves.shape[:-3], 128).to(torch.float64)
    return (flat @ _table("cols", 128, a.device)).to(I64)


def _reduce(cols: torch.Tensor, extra: int, neg: str, ctx: FieldCtx) -> torch.Tensor:
    """cols (..., 9) non-negative columns of v + extra * 2^288 with v < 2c
    for the constant c = 2p (neg="neg_twop") or p (neg="neg_p"): returns v - c
    if v >= c else v, as (..., 8) digits."""
    both = torch.stack([cols, cols + ctx.k(neg, cols.device)], dim=-2)
    t = _norm(both, 10)
    ge = t[..., 1, 9] > extra  # v + 2^288 - c carried past 2^288
    return torch.where(ge.unsqueeze(-1), t[..., 1, :8], t[..., 0, :8])


def _mont_mul32(a: torch.Tensor, b: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    """REDC(a*b) on (..., 8) digit vectors.

    t = a*b; m = (t mod R) * N' mod R; r = (t + m*p) / R. m is taken from
    the unnormalised low columns of t, which equal t mod R as a value."""
    dev = a.device
    t = _mul_cols(a, b)  # (..., 16), < 2^36
    t_lo = t[..., :8]
    split = torch.stack([t_lo & M32, t_lo >> 32], dim=-2)  # t_lo = lo + hi * 2^32
    mc = _mul_cols(split, ctx.k("nprime", dev).expand_as(split))[..., :8]
    m = _norm(mc[..., 0, :] + _shift_up(mc[..., 1, :], 1), 8)
    mp = _mul_cols(m, ctx.k("p", dev).expand_as(m))
    return _norm(t + mp, 16)[..., 8:]  # t + m*p < 2^512, divisible by R


# ---------------- public primitives (shape (..., 16) int32) ----------------


def mont_mul(a: torch.Tensor, b: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    """Montgomery product REDC(a*b) on the lazy domain [0, 2p)."""
    a32, b32 = torch.broadcast_tensors(_to32(a), _to32(b))
    return _to16(_mont_mul32(a32, b32, ctx))


def from_mont(a: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    """Montgomery -> canonical (< p): REDC against 1, then reduce mod p."""
    one = torch.zeros(8, dtype=I64, device=a.device)
    one[0] = 1
    a32 = _to32(a)
    r = _mont_mul32(a32, one.expand_as(a32), ctx)  # <= p
    return _to16(_reduce(F.pad(r, (0, 1)), 0, "neg_p", ctx))


def add_mod(a: torch.Tensor, b: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    """(a + b) on the lazy domain: result < 2p."""
    s = F.pad(_to32(a) + _to32(b), (0, 1))
    return _to16(_reduce(s, 0, "neg_twop", ctx))


def sub_mod(a: torch.Tensor, b: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    """(a - b) on the lazy domain: a - b + 2p, reduced below 2p.

    -b is written as 2^288 - b = (~b over 9 digits) + 1, so every column
    stays non-negative; the 2^288 it adds is dropped by `_reduce`."""
    a32, b32 = torch.broadcast_tensors(_to32(a), _to32(b))
    cols = a32 + ctx.k("twop", a32.device) + (M32 - b32)
    cols = F.pad(cols, (0, 1), value=M32)
    cols[..., 0] += 1
    return _to16(_reduce(cols, 1, "neg_twop", ctx))


def neg_mod(a: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    return sub_mod(torch.zeros_like(a), a, ctx)


def double_mod(a: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    return add_mod(a, a, ctx)


def mont_sqr(a: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    return mont_mul(a, a, ctx)


def select(mask, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Branchless where over limb vectors; mask broadcastable to (...,)."""
    mask = torch.as_tensor(mask, device=a.device)
    return torch.where(mask.unsqueeze(-1), a, b)


def inv_mod(a: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    """Fermat inversion a^(p-2) in Montgomery form; 0 maps to 0.

    One square and one multiply per exponent bit (254 steps). Batch callers
    should prefer `ops.scan.batch_invert`, which runs this ladder on one
    element only."""
    acc = ctx.one(a.device).expand_as(a)
    for bit in ctx.inv_exp_bits:
        acc = mont_mul(acc, acc, ctx)
        if bit:
            acc = mont_mul(acc, a, ctx)
    return acc


def pow_const(a: torch.Tensor, e: int, ctx: FieldCtx) -> torch.Tensor:
    """a^e for a static exponent (square-and-multiply)."""
    if e == 0:
        return ctx.one(a.device).expand_as(a).clone()
    acc = None
    for i in range(e.bit_length() - 1, -1, -1):
        if acc is not None:
            acc = mont_mul(acc, acc, ctx)
        if (e >> i) & 1:
            acc = a if acc is None else mont_mul(acc, a, ctx)
    return acc


def is_zero(a: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    """(...,) bool mask; on the lazy domain zero is represented as 0 or p."""
    z = (a == 0).all(-1)
    zp = (_to32(a) == ctx.k("p", a.device)).all(-1)
    return z | zp


def eq_mod(a: torch.Tensor, b: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    """Value equality on the lazy domain."""
    return is_zero(sub_mod(a, b, ctx), ctx)


def batch_invert_mod(a: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    """Invert a batch; zeros pass through (0^(p-2) = 0)."""
    return inv_mod(a, ctx)
