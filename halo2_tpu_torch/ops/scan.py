"""Prefix-product scans and Montgomery-trick batch inversion on limb tensors.

Counterpart of `halo2_tpu/ops/scan.py`. Each public function runs kernel C
(`csrc/scan.cu`) for a CUDA tensor and its plain version (`*_plain`) for a
CPU tensor, and raises for any other device.

Kernel C is a reduce-then-scan over runs of RUN_ROWS rows: the runs'
products, one block's scan of them into each run's carry in, and each run's
rows from its carry; `batch_invert` inverts the total on the card (a Fermat
ladder on one thread) and ends in Montgomery's trick within each run, so
nothing is read back to the host. `launch_args` is the launch's
preparation in Python, so that the CPU tests reach it.

The plain versions are the JAX package's algorithms in torch: the
inclusive prefix product is a Hillis-Steele scan, log2(n) rounds, each one
batched `mont_mul` of the array against itself shifted by 2^r; batch
inversion needs the inverse of ONE element (the total product), which is
taken on the host with Python's `pow` (one readback).

Every result is exact mod p and lies in the lazy domain [0, 2p): the kernel
and the plain version equal each other, and the JAX package, after
canonicalisation, not always in their limbs.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .field import NLIMBS, FieldCtx, is_zero, mont_mul, select

RUN_ROWS = 8  # csrc/scan.cuh kRunRows
MODES = ("inclusive", "exclusive", "invert")  # csrc/scan.cu scan_rows' mode 0, 1, 2
KERNELS_PER_CALL = 3  # the runs' totals, the carries, the rows
LAUNCHES = {"scan": 0}  # kernel C's device kernels

_P = ctypes.c_void_p
_SIG = {"scan_rows": (ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_longlong, _P, _P),
        "scan_run_rows": ()}


def launch_args(vals: torch.Tensor, init: Optional[torch.Tensor] = None):
    """(vals, init, runs) of one launch on an (n, 16) tensor: the rows and
    init as the kernel reads them (int32, contiguous; init one row) and the
    number of runs, ceil(n / RUN_ROWS), whose totals and carries the
    scratch holds."""
    if vals.dim() != 2 or vals.shape[1] != NLIMBS:
        raise ValueError(f"scan: expected (n, 16) limbs, got {tuple(vals.shape)}")
    vals = vals.to(torch.int32).contiguous()
    if init is not None:
        if init.numel() != NLIMBS:
            raise ValueError(f"scan: init must be one (16,) element, got {tuple(init.shape)}")
        init = init.to(torch.int32).reshape(NLIMBS).contiguous()
    return vals, init, -(-vals.shape[0] // RUN_ROWS)


def launch(mode: str, vals: torch.Tensor, ctx: FieldCtx, init: Optional[torch.Tensor] = None):
    """Kernel C on a CUDA tensor: "inclusive" or "exclusive" (times `init`)
    prefix products along axis 0, or "invert" (batch inversion, zeros to
    zero). Three device kernels, no readback."""
    vals, init, runs = launch_args(vals, init)
    if init is not None and init.device != vals.device:
        raise ValueError(f"scan: init on {init.device}, rows on {vals.device}")
    n = vals.shape[0]
    out = torch.empty_like(vals)
    if n == 0:
        return out
    for t, name in ((vals, "vals"), (out, "out"), (init, "init")):
        if t is not None:
            _build.check_tensor(t, t.shape, name, vals.device, align=16)
    scratch = torch.empty((2, runs, NLIMBS), dtype=torch.int32, device=vals.device)
    lib = _build.load("scan", _SIG)
    if lib.scan_run_rows() != RUN_ROWS:
        raise RuntimeError(f"scan: the library runs {lib.scan_run_rows()} rows a thread, not {RUN_ROWS}")
    err = lib.scan_rows(MODES.index(mode), vals.data_ptr(), out.data_ptr(), scratch[0].data_ptr(),
                        scratch[1].data_ptr(), None if init is None else init.data_ptr(), n,
                        ctypes.byref(_build.field_consts(ctx.p_int)),
                        torch.cuda.current_stream(vals.device).cuda_stream)
    _build.check(err, f"scan {mode}")
    LAUNCHES["scan"] += KERNELS_PER_CALL
    return out


def prefix_product(vals: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    """Inclusive prefix products along axis 0: out[i] = prod_{j<=i} vals[j]."""
    if _build.on_card(vals, "prefix_product"):
        return launch("inclusive", vals, ctx)
    return prefix_product_plain(vals, ctx)


def prefix_product_plain(vals: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    out = vals
    n = vals.shape[0]
    d = 1
    while d < n:
        out = torch.cat([out[:d], mont_mul(out[d:], out[:-d], ctx)], dim=0)
        d *= 2
    return out


def exclusive_prefix_product(
    vals: torch.Tensor, ctx: FieldCtx, init: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """out[i] = init * prod_{j<i} vals[j]  (init defaults to one)."""
    if _build.on_card(vals, "exclusive_prefix_product"):
        return launch("exclusive", vals, ctx, init)
    return exclusive_prefix_product_plain(vals, ctx, init)


def exclusive_prefix_product_plain(
    vals: torch.Tensor, ctx: FieldCtx, init: Optional[torch.Tensor] = None
) -> torch.Tensor:
    incl = prefix_product_plain(vals, ctx)
    one = ctx.one(vals.device)[None]
    excl = torch.cat([one, incl[:-1]], dim=0)
    if init is not None:
        excl = mont_mul(excl, init, ctx)
    return excl


def batch_invert(vals: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    """Invert all n elements with one inversion; zeros pass through as zero."""
    if _build.on_card(vals, "batch_invert"):
        return launch("invert", vals, ctx)
    return batch_invert_plain(vals, ctx)


def batch_invert_plain(vals: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    zero_mask = is_zero(vals, ctx)
    one = ctx.one(vals.device).expand_as(vals)
    safe = select(zero_mask, one, vals)
    pre = exclusive_prefix_product_plain(safe, ctx)  # prod_{j<i}
    suf = exclusive_prefix_product_plain(safe.flip(0), ctx).flip(0)  # prod_{j>i}
    total = mont_mul(pre[-1], safe[-1], ctx)
    (t,) = ctx.decode_ints(total)
    total_inv = ctx.const(pow(t, -1, ctx.p_int), vals.device)
    out = mont_mul(mont_mul(pre, suf, ctx), total_inv, ctx)
    return select(zero_mask, torch.zeros_like(vals), out)
