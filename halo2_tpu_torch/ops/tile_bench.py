"""Per-element field and curve arithmetic of the kernel-profiling tool:
kernels 9 and 10.

Counterpart of the two Pallas kernels inside `tools/profile_kernels.py`
`sec_tilemul`, which time the arithmetic the MSM's inner loop is made of:

- `tile_mul(a, b)` (kernel 9, replaces `mul_kernel`): eight chained
  Montgomery products o <- o * b per element.
- `tile_padd(X1, Y1, Z1, X2, Y2)` (kernel 10, replaces `padd_kernel`): one
  complete mixed addition per element, RCB15 algorithm 8 with the curve's
  3b, the function of `msm_pallas._mixed_padd`.

`op_chain(a, b, n, op)` is the tool's latency probe, no TPU kernel's port:
one thread applies one of the field operations of `csrc/field.cuh` (OPS) n
times in a chain, x <- op(x, b), and returns the result with the clock
cycles the chain took; its plain version repeats the operation in torch.

Tensors are the port's (n, 16) int32 limbs. Each wrapper launches its CUDA
kernel (`csrc/tile_bench.cu`) for CUDA tensors and runs its plain version,
`mont_mul` eight times (`ops/field.py`) or `padd_mixed` (`ops/curve.py`), for
CPU tensors. Neither has a library counterpart: no PyTorch call computes a
Montgomery product.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .curve import CurveCtx, PointVec, padd_mixed
from .field import NLIMBS, FieldCtx, add_mod, mont_mul, sub_mod

MULS_PER_ELEMENT = 8
LAUNCHES = {"tile_mul": 0, "tile_padd": 0}
# the latency probe's launches, apart from the ten kernels' counts
PROBE_LAUNCHES = {"op_chain": 0}
# op_chain's operations, in csrc/tile_bench.cu's order
OPS = ("fe_mul", "fe_mul_cc", "fe_mul_cc_pasta", "fe_add", "fe_add_cc", "fe_sub", "fe_sub_cc")

_P = ctypes.c_void_p
_SIG = {
    "tile_mul": (_P, _P, _P, ctypes.c_longlong, _P, _P),
    "tile_padd": (_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P, _P),
    "op_chain": (_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P),
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
        _build.check_tensor(t, (n, NLIMBS), name, a.device)
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
        _build.check_tensor(t, (n, NLIMBS), name, x1.device)
    out = PointVec(*(torch.empty_like(x1) for _ in range(3)))
    lib = _build.load("tile_bench", _SIG)
    err = lib.tile_padd(x1.data_ptr(), y1.data_ptr(), z1.data_ptr(), x2.data_ptr(), y2.data_ptr(),
                        out.x.data_ptr(), out.y.data_ptr(), out.z.data_ptr(), n,
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
        _build.check_tensor(t, (NLIMBS,), name, a.device)
    out = torch.empty_like(a)
    cycles = torch.zeros(1, dtype=torch.int64, device=a.device)
    lib = _build.load("tile_bench", _SIG)
    err = lib.op_chain(a.data_ptr(), b.data_ptr(), out.data_ptr(), cycles.data_ptr(), n,
                       OPS.index(op), ctypes.byref(_build.field_consts(ctx.p_int)),
                       torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "op_chain")
    PROBE_LAUNCHES["op_chain"] += 1
    return out, int(cycles.item())
