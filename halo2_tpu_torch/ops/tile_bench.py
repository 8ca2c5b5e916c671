"""Per-element field and curve arithmetic of the kernel-profiling tool:
kernels 9 and 10.

Counterpart of the two Pallas kernels inside `tools/profile_kernels.py`
`sec_tilemul`, which time the arithmetic the MSM's inner loop is made of:

- `tile_mul(a, b)` (kernel 9, replaces `mul_kernel`): eight chained
  Montgomery products o <- o * b per element; on the card bit for bit the
  plain version's limbs.
- `tile_padd(X1, Y1, Z1, X2, Y2)` (kernel 10, replaces `padd_kernel`): one
  complete mixed addition per element, RCB15 algorithm 8 with the curve's
  3b, the function of `msm_pallas._mixed_padd`. For a curve with 3b = 15
  (Pallas, Vesta) the kernel multiplies by 3b as 16 x - x, so its
  coordinates equal the plain version's as canonical values, not always as
  limbs; for any other curve (the generic form) they are its limbs.

Two probes of the tool, no TPU kernel's port, count their launches apart
from the ten kernels (PROBE_LAUNCHES):

- `op_chain(a, b, n, op)`: one thread applies one of the field operations
  of `csrc/field.cuh` (OPS) n times in a chain, x <- op(x, b), and returns
  the result with the clock cycles the chain took; its plain version repeats
  the operation in torch.
- `mul_peak(acc, iters, form)`: every thread of the grid steps its
  PEAK_CHAINS words `iters` times with one multiply instruction of
  PEAK_FORMS (mad.lo or mad.hi on independent words, their carry-chained
  .cc forms over the 8 words, mad.wide.u32 on 4 independent 64-bit words);
  timed over a full-card grid it gives the card's rate of that instruction.

Tensors are the port's (n, 16) int32 limbs, 16-byte aligned (the kernels
load 16-byte vectors). Each wrapper launches its CUDA kernel
(`csrc/tile_bench.cu`) for CUDA tensors and runs its plain version,
`mont_mul` eight times (`ops/field.py`) or `padd_mixed` (`ops/curve.py`), for
CPU tensors. Neither kernel has a library counterpart: no PyTorch call
computes a Montgomery product.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .curve import CurveCtx, PointVec, padd_mixed
from .field import NLIMBS, FieldCtx, add_mod, mont_mul, sub_mod

MULS_PER_ELEMENT = 8
LAUNCHES = {"tile_mul": 0, "tile_padd": 0}
# the probes' launches, apart from the ten kernels' counts
PROBE_LAUNCHES = {"op_chain": 0, "mul_peak": 0}
# op_chain's operations, in csrc/tile_bench.cu's order
OPS = ("fe_mul", "fe_mul_cc", "fe_mul_cc_pasta", "fe_add", "fe_add_cc", "fe_sub", "fe_sub_cc")

# mul_peak: words a thread, threads a block, the constants, the forms (in
# csrc/tile_bench.cu's order) and each form's instructions a step
PEAK_CHAINS = 8
PEAK_THREADS = 256
PEAK_M, PEAK_C = 0x9E3779B1, 0x7F4A7C15
PEAK_FORMS = {"mad_lo": 8, "mad_hi": 8, "mad_lo_cc": 8, "mad_hi_cc": 8, "mad_wide": 4}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {
    "tile_mul": (_P, _P, _P, ctypes.c_longlong, _P, _P),
    "tile_padd": (_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _P, _P),
    "op_chain": (_P, _P, _P, _P, _I, _I, _P, _P),
    "mul_peak": (_P, _I, _I, _I, ctypes.c_uint32, ctypes.c_uint32, _P),
}


def tile_mul_plain(a: torch.Tensor, b: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    o = a
    for _ in range(MULS_PER_ELEMENT):
        o = mont_mul(o, b, ctx)
    return o


def tile_mul(a: torch.Tensor, b: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    """(n, 16) lazy Montgomery limbs a, b -> a * b^8 (eight REDC products)."""
    if not _build.on_card(a, "tile_mul"):
        return tile_mul_plain(a, b, ctx)
    n = a.shape[0]
    for t, name in ((a, "a"), (b, "b")):
        _build.check_tensor(t, (n, NLIMBS), name, a.device, align=16)
    out = torch.empty_like(a)
    lib = _build.load("tile_bench", _SIG)
    err = lib.tile_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                       ctypes.byref(_build.field_consts(ctx.p_int)),
                       torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "tile_mul")
    LAUNCHES["tile_mul"] += 1
    return out


def tile_padd_plain(x1, y1, z1, x2, y2, cc: CurveCtx) -> PointVec:
    return padd_mixed(PointVec(x1, y1, z1), x2, y2, cc)


def tile_padd(x1: torch.Tensor, y1: torch.Tensor, z1: torch.Tensor, x2: torch.Tensor,
              y2: torch.Tensor, cc: CurveCtx) -> PointVec:
    """Projective (X1 : Y1 : Z1) plus affine (X2, Y2), elementwise over (n, 16)
    limb tensors, with the complete mixed addition of curve `cc`."""
    if not _build.on_card(x1, "tile_padd"):
        return tile_padd_plain(x1, y1, z1, x2, y2, cc)
    n = x1.shape[0]
    for t, name in ((x1, "x1"), (y1, "y1"), (z1, "z1"), (x2, "x2"), (y2, "y2")):
        _build.check_tensor(t, (n, NLIMBS), name, x1.device, align=16)
    out = PointVec(*(torch.empty_like(x1) for _ in range(3)))
    lib = _build.load("tile_bench", _SIG)
    err = lib.tile_padd(x1.data_ptr(), y1.data_ptr(), z1.data_ptr(), x2.data_ptr(), y2.data_ptr(),
                        out.x.data_ptr(), out.y.data_ptr(), out.z.data_ptr(), n,
                        int(cc.b3_int == 15),
                        ctypes.byref(_build.field_consts(cc.fctx.p_int, cc.b3_mont)),
                        torch.cuda.current_stream(x1.device).cuda_stream)
    _build.check(err, "tile_padd")
    LAUNCHES["tile_padd"] += 1
    return out


def op_chain_plain(a: torch.Tensor, b: torch.Tensor, n: int, op: str,
                   ctx: FieldCtx) -> torch.Tensor:
    fn = add_mod if "add" in op else sub_mod if "sub" in op else mont_mul
    x = a
    for _ in range(n):
        x = fn(x, b, ctx)
    return x


def op_chain(a: torch.Tensor, b: torch.Tensor, n: int, op: str, ctx: FieldCtx):
    """(16,) limbs a, b -> (x, cycles): x = op(...op(a, b)..., b), n times,
    and the SM clock cycles of the chain (None for the plain version). The
    Pasta form needs a Pasta modulus; the kernel refuses another."""
    if not _build.on_card(a, "op_chain"):
        return op_chain_plain(a, b, n, op, ctx), None
    for t, name in ((a, "a"), (b, "b")):
        _build.check_tensor(t, (NLIMBS,), name, a.device, align=16)
    out = torch.empty_like(a)
    cycles = torch.zeros(1, dtype=torch.int64, device=a.device)
    lib = _build.load("tile_bench", _SIG)
    err = lib.op_chain(a.data_ptr(), b.data_ptr(), out.data_ptr(), cycles.data_ptr(), n,
                       OPS.index(op), ctypes.byref(_build.field_consts(ctx.p_int)),
                       torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "op_chain")
    PROBE_LAUNCHES["op_chain"] += 1
    return out, int(cycles.item())


def mul_peak_plain(acc: torch.Tensor, iters: int, form: str) -> torch.Tensor:
    """The steps in int64 torch arithmetic on 32-bit words, the multiplier
    cut into 16-bit halves so that no product leaves 63 bits."""
    mask = 0xFFFFFFFF
    m_hi, m_lo = PEAK_M >> 16, PEAK_M & 0xFFFF

    def mul(x):  # (low, high) words of x * PEAK_M
        a, b = x * m_hi, x * m_lo  # x * m = a 2^16 + b
        return (((a & 0xFFFF) << 16) + b) & mask, (a + (b >> 16)) >> 16

    x = acc.to(torch.int64) & mask
    for _ in range(iters):
        if form in ("mad_lo", "mad_hi"):
            x = (mul(x)[form == "mad_hi"] + PEAK_C) & mask
        elif form in ("mad_lo_cc", "mad_hi_cc"):
            words, carry = [], 0
            for i in range(PEAK_CHAINS):  # one carry chain over the words
                s = mul(x[:, i])[form == "mad_hi_cc"] + PEAK_C + carry
                words.append(s & mask)
                carry = s >> 32
            x = torch.stack(words, 1)
        else:  # 64-bit words (2i, 2i + 1) <- low word * m + the 64-bit word
            lo, hi = x[:, 0::2], x[:, 1::2]
            pl, ph = mul(lo)
            s = pl + lo
            x = torch.stack([s & mask, (ph + hi + (s >> 32)) & mask], 2).reshape(x.shape)
    return x.to(torch.int32)


def mul_peak(acc: torch.Tensor, iters: int, form: str) -> torch.Tensor:
    """acc (blocks * PEAK_THREADS, PEAK_CHAINS) int32 words -> their values
    after `iters` steps of the multiply form `form` (one of PEAK_FORMS); on
    the card in place (and returned)."""
    if form not in PEAK_FORMS:
        raise ValueError(f"mul_peak: form {form!r} is not one of {tuple(PEAK_FORMS)}")
    if not _build.on_card(acc, "mul_peak"):
        return mul_peak_plain(acc, iters, form)
    threads = acc.shape[0]
    if threads % PEAK_THREADS:
        raise ValueError(f"mul_peak: {threads} threads, not whole blocks of {PEAK_THREADS}")
    _build.check_tensor(acc, (threads, PEAK_CHAINS), "acc", acc.device)
    lib = _build.load("tile_bench", _SIG)
    err = lib.mul_peak(acc.data_ptr(), threads // PEAK_THREADS, iters, list(PEAK_FORMS).index(form),
                       PEAK_M, PEAK_C, torch.cuda.current_stream(acc.device).cuda_stream)
    _build.check(err, "mul_peak")
    PROBE_LAUNCHES["mul_peak"] += 1
    return acc
