"""Kernel A: elementwise Montgomery product, sum and difference on the card.

Counterpart of the jitted `ctx.mul` / `ctx.add` / `ctx.sub` of
`halo2_tpu/ops/field_jax.py:75-77`, which XLA fuses into the program that
calls them. `ops/field.py`'s public `mont_mul`, `add_mod` and `sub_mod` call
`launch` here for a CUDA tensor (and their plain versions, `*_plain`, for a
CPU tensor), so every caller of those three functions takes the kernel on
the card with no change of its own.

`launch_args` is the launch's preparation, kept in Python so that the CPU
tests reach it: the broadcast shape of the two operands' leading
dimensions, collapsed to at most four dimensions, and each operand's stride
of each, in int32 units (0 where it is broadcast, so it is read where it
lies and never copied). An operand whose limbs are not contiguous is made
contiguous first; each operand's data and element strides must allow
16-byte vector loads. The kernel (`csrc/field_ew.cu`) writes a contiguous
(*shape, 16) int32 output, bit for bit the plain version's limbs. No PyTorch
call computes a Montgomery product ("library: none").
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NLIMBS = 16
MAX_DIMS = 4
OPS = ("mont_mul", "add_mod", "sub_mod")  # csrc/field_ew.cu's op 0, 1, 2
LAUNCHES = {op: 0 for op in OPS}

_P = ctypes.c_void_p
_L4 = ctypes.c_longlong * MAX_DIMS
_SIG = {"field_ew": (ctypes.c_int, _P, _P, _P, _L4, _L4, _L4, ctypes.c_longlong, _P, _P)}


def launch_args(a: torch.Tensor, b: torch.Tensor):
    """(shape, a, b, sizes, strides_a, strides_b) of one launch on (..., 16)
    operands: `shape` the broadcast leading shape of the output, `a` and `b`
    the tensors whose data the kernel reads (the operands, made contiguous
    only where their limbs were not), `sizes` the collapsed shape (MAX_DIMS
    entries, outermost first, padded with 1) and each operand's strides of
    it in int32 units. Element e of the output, in row-major order over
    `shape`, reads a at sum_d i_d strides_a[d] from a's first element."""
    if a.shape[-1:] != (NLIMBS,) or b.shape[-1:] != (NLIMBS,):
        raise ValueError(f"field_ew: operands must be (..., 16) limbs, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    shape = tuple(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]))
    ops = []
    for t in (a, b):
        if t.dtype != torch.int32:
            t = t.to(torch.int32)  # limbs below 2^16: the same values
        if t.stride(-1) != 1:
            t = t.contiguous()
        ops.append(t)
    a, b = ops
    ea, eb = a.expand(*shape, NLIMBS), b.expand(*shape, NLIMBS)
    dims = []
    for d, s in enumerate(shape):
        if s == 1:
            continue
        sa, sb = ea.stride(d), eb.stride(d)
        if dims and dims[-1][1] == sa * s and dims[-1][2] == sb * s:
            dims[-1] = (dims[-1][0] * s, sa, sb)  # row-major neighbours in both
        else:
            dims.append((s, sa, sb))
    if len(dims) > MAX_DIMS:
        # more than four dimensions that do not merge: read both as one
        # contiguous row of elements
        a, b = ea.contiguous(), eb.contiguous()
        numel = a.numel() // NLIMBS
        dims = [(numel, NLIMBS, NLIMBS)]
    dims = [(1, 0, 0)] * (MAX_DIMS - len(dims)) + dims
    sizes, sa, sb = (tuple(x) for x in zip(*dims))
    return shape, a, b, sizes, sa, sb


def launch(op: str, a: torch.Tensor, b: torch.Tensor, ctx) -> torch.Tensor:
    """op(a, b) for CUDA tensors: one launch of kernel A ("mont_mul",
    "add_mod" or "sub_mod" of `ctx`'s field), the output contiguous."""
    if b.device != a.device:
        raise ValueError(f"{op}: operands on {a.device} and {b.device}")
    shape, a, b, sizes, sa, sb = launch_args(a, b)
    for t, strides, name in ((a, sa, "a"), (b, sb, "b")):
        if t.data_ptr() % 16 or any(s % 4 for s in strides):
            raise ValueError(f"{op}: operand {name} at {t.data_ptr():#x} with element strides "
                             f"{strides} does not allow 16-byte vector loads")
    out = torch.empty((*shape, NLIMBS), dtype=torch.int32, device=a.device)
    n = out.numel() // NLIMBS
    if n == 0:
        return out
    lib = _build.load("field_ew", _SIG)
    err = lib.field_ew(OPS.index(op), a.data_ptr(), b.data_ptr(), out.data_ptr(), _L4(*sizes),
                       _L4(*sa), _L4(*sb), n, ctypes.byref(_build.field_consts(ctx.p_int)),
                       torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, op)
    LAUNCHES[op] += 1
    return out

