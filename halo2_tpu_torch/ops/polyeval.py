"""Batched polynomial evaluation, Horner fold and Kate division on limb tensors.

Counterpart of `halo2_tpu/ops/polyeval.py`:

  * `batch_eval_mont`: M stacked polynomials at (few) points;
    `device_powers`: [1, x, ..., x^(n-1)].
  * `horner_fold_mont`: fold a stack of polynomials by a scalar.
  * `kate_division_mont`: (p(X) - p(b)) / (X - b).

`batch_eval_mont`, `device_powers` and `kate_division_mont` run their
kernels (`csrc/polyeval.cu`: kernel D for the first two, kernel E for the
third) for a CUDA tensor and their plain versions (`*_plain`) for a CPU
tensor, and raise for any other device; none reads anything back to the
host on the card. Kernel D gives each thread a run of RUN_ROWS rows from
x^r0 (a product of entries of the point's table x^(2^j)) and sums c_i x^i
in the block, a second launch the blocks; in its powers mode it writes
x^i. Kernel E is one launch of kernel C's single-pass look-back scan
(`csrc/scan.cuh`), from the last row back, over the affine maps
v -> b v + a_i of the suffix recurrence s_i = a_i + b s_{i+1}. Their
outputs lie in [0, 2p) and equal the plain versions' as values mod p.

The plain versions are the JAX package's algorithms in torch: a
log-doubling power ladder and a log-depth modular tree sum; for Kate
division, a Hillis-Steele scan over the reversed coefficients in which
round r adds b^(2^r) times the array shifted by 2^r. `horner_fold_mont`
stays a loop of kernel A's products and sums.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Type

import numpy as np
import torch

from ..fields import FieldElement
from . import _build
from .field import NLIMBS, FieldCtx, add_mod, ints_to_limbs, mont_mul
from . import scan as scan_ops

RUN_ROWS = 8  # csrc/scan.cuh kRunRows: rows a thread of kernel D's evaluation
EVAL_THREADS = 128  # csrc/polyeval.cu kEvalThreads
LAUNCHES = {"batch_eval": 0, "kate_div": 0}  # kernels D and E: their device kernels

_P = ctypes.c_void_p
_SIG = {
    "power_table": (_P, _P, ctypes.c_int, ctypes.c_int, _P, _P),
    "batch_eval": (ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, _P, _P),
    "kate_div": (_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _P, _P, _P),
    "polyeval_run_rows": (),
    "polyeval_tile_rows": (),
    "kate_table_entries": (),
}


def _lib():
    lib = _build.load("polyeval", _SIG)
    if lib.polyeval_run_rows() != RUN_ROWS:
        raise RuntimeError(f"polyeval: the library runs {lib.polyeval_run_rows()} rows a thread, "
                           f"not {RUN_ROWS}")
    if lib.polyeval_tile_rows() != scan_ops.TILE_ROWS:
        raise RuntimeError(f"polyeval: the library's tiles hold {lib.polyeval_tile_rows()} rows, "
                           f"not {scan_ops.TILE_ROWS}")
    if lib.kate_table_entries() != len(kate_powers(1, 3)):
        raise RuntimeError(f"polyeval: the library's Kate table holds {lib.kate_table_entries()} entries, "
                           f"not {len(kate_powers(1, 3))}")
    return lib


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def table_bits(n: int) -> int:
    """L, the entries x^(2^j), j < L, of a point's table: enough bits for
    every row index below n."""
    return max(1, (n - 1).bit_length())


def eval_blocks(n: int) -> int:
    """Kernel D's row blocks a polynomial."""
    return -(-n // (RUN_ROWS * EVAL_THREADS))


def point_tables(ctx: FieldCtx, points: Sequence[int], n: int):
    """(table, sel): the distinct points' tables x^(2^j) (Q, L, 16) in
    Montgomery limbs, in sorted order of the points mod p, and each
    point's row in it (M,), as numpy int32; built on the host."""
    p, r = ctx.p_int, ctx.r_int
    uniq = sorted(set(int(x) % p for x in points))
    index = {x: i for i, x in enumerate(uniq)}
    L = table_bits(n)
    vals = []
    for x in uniq:
        w = x
        for _ in range(L):
            vals.append(w * r % p)
            w = w * w % p
    table = ints_to_limbs(vals).reshape(len(uniq), L, NLIMBS)
    sel = np.asarray([index[int(x) % p] for x in points], dtype=np.int32)
    return table, sel


def eval_launch(coeffs: torch.Tensor, xtab: torch.Tensor, sel: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    """Kernel D on CUDA tensors: coeffs (M, n, 16), xtab (Q, L, 16) with
    L = table_bits(n), sel (M,) int32 -> (M, 16) evaluations. Two device
    kernels."""
    M, n, _ = coeffs.shape
    coeffs = coeffs.to(torch.int32).contiguous()
    L = table_bits(n)
    dev = coeffs.device
    _build.check_tensor(coeffs, (M, n, NLIMBS), "coeffs", dev, align=16)
    _build.check_tensor(xtab, (xtab.shape[0], L, NLIMBS), "xtab", dev, align=16)
    _build.check_tensor(sel, (M,), "sel", dev)
    blocks = eval_blocks(n)
    partial = torch.empty((M, blocks, NLIMBS), dtype=torch.int32, device=dev)
    out = torch.empty((M, NLIMBS), dtype=torch.int32, device=dev)
    err = _lib().batch_eval(0, coeffs.data_ptr(), xtab.data_ptr(), sel.data_ptr(), partial.data_ptr(),
                            out.data_ptr(), n, M, L, blocks, ctypes.byref(_build.field_consts(ctx.p_int)),
                            _stream(coeffs))
    _build.check(err, "batch_eval")
    LAUNCHES["batch_eval"] += 2
    return out


def powers_launch(x_mont: torch.Tensor, n: int, ctx: FieldCtx) -> torch.Tensor:
    """Kernel D's powers mode on a CUDA tensor: x (..., 16) -> (..., n, 16)
    = x^i. Two device kernels: the table x^(2^j), then the powers."""
    lead = x_mont.shape[:-1]
    x = x_mont.to(torch.int32).reshape(-1, NLIMBS).contiguous()
    Q, L, dev = x.shape[0], table_bits(n), x.device
    out = torch.empty((Q, n, NLIMBS), dtype=torch.int32, device=dev)
    if Q == 0 or n == 0:
        return out.reshape(*lead, n, NLIMBS)
    _build.check_tensor(x, (Q, NLIMBS), "x", dev, align=16)
    xtab = torch.empty((Q, L, NLIMBS), dtype=torch.int32, device=dev)
    lib = _lib()
    consts = ctypes.byref(_build.field_consts(ctx.p_int))
    _build.check(lib.power_table(x.data_ptr(), xtab.data_ptr(), Q, L, consts, _stream(x)), "power_table")
    err = lib.batch_eval(1, None, xtab.data_ptr(), None, None, out.data_ptr(), n, Q, L, eval_blocks(n),
                         consts, _stream(x))
    _build.check(err, "device_powers")
    LAUNCHES["batch_eval"] += 2
    return out.reshape(*lead, n, NLIMBS)


def device_powers(x_mont: torch.Tensor, n: int, ctx: FieldCtx) -> torch.Tensor:
    """[1, x, ..., x^(n-1)] from a (..., 16) Montgomery scalar."""
    if _build.on_card(x_mont, "device_powers"):
        return powers_launch(x_mont, n, ctx)
    return device_powers_plain(x_mont, n, ctx)


def device_powers_plain(x_mont: torch.Tensor, n: int, ctx: FieldCtx) -> torch.Tensor:
    """The log-doubling ladder: pw_{2l} = pw_l ++ (x^l * pw_l)."""
    lead = x_mont.shape[:-1]
    pw = ctx.one(x_mont.device).expand(*lead, 1, NLIMBS)
    xl = x_mont
    length = 1
    while length < n:
        ext = mont_mul(pw, xl.unsqueeze(-2), ctx)
        pw = torch.cat([pw, ext], dim=-2)
        if 2 * length < n:
            xl = mont_mul(xl, xl, ctx)
        length *= 2
    return pw[..., :n, :]


def tree_sum(t: torch.Tensor, ctx: FieldCtx, dim: int) -> torch.Tensor:
    """Log-depth modular sum along `dim`."""
    t = t.movedim(dim, 0)
    while t.shape[0] > 1:
        if t.shape[0] % 2:
            t = torch.cat([t, torch.zeros_like(t[:1])], dim=0)
        half = t.shape[0] // 2
        t = add_mod(t[:half], t[half:], ctx)
    return t[0]


def batch_eval_mont(
    field: Type[FieldElement], coeff_stack: torch.Tensor, points: Sequence[int]
) -> torch.Tensor:
    """Evaluate coeff_stack[i] (Montgomery limbs, coeff basis) at points[i];
    (M, 16) Montgomery results. Distinct points share one table (kernel D)
    or one power ladder (plain). On the card the tables and the point of
    each polynomial go up in one copy from pinned memory, which does not
    wait for the card."""
    ctx = FieldCtx(field)
    if not _build.on_card(coeff_stack, "batch_eval_mont"):
        return batch_eval_mont_plain(field, coeff_stack, points)
    n = coeff_stack.shape[1]
    table, sel = point_tables(ctx, points, n)
    host = torch.from_numpy(np.concatenate([table.reshape(-1), sel])).pin_memory()
    buf = host.to(coeff_stack.device, non_blocking=True)
    xtab = buf[: table.size].view(table.shape)
    return eval_launch(coeff_stack, xtab, buf[table.size:], ctx)


def batch_eval_mont_plain(
    field: Type[FieldElement], coeff_stack: torch.Tensor, points: Sequence[int]
) -> torch.Tensor:
    ctx = FieldCtx(field)
    n = coeff_stack.shape[1]
    dev = coeff_stack.device
    uniq = sorted(set(int(x) % ctx.p_int for x in points))
    index = {x: i for i, x in enumerate(uniq)}
    pws = device_powers_plain(ctx.consts(uniq, dev), n, ctx)  # (Q, n, 16)
    sel = torch.as_tensor([index[int(x) % ctx.p_int] for x in points], device=dev)
    t = mont_mul(coeff_stack, pws[sel], ctx)
    return tree_sum(t, ctx, dim=1)


def batch_eval(
    field: Type[FieldElement], coeff_stack: torch.Tensor, points: Sequence[int]
) -> List[int]:
    """Host-int results of `batch_eval_mont` (one readback)."""
    return FieldCtx(field).decode_ints(batch_eval_mont(field, coeff_stack, points))


def horner_fold_mont(field: Type[FieldElement], stack: torch.Tensor, x: int) -> torch.Tensor:
    """acc = (...(s_0 * x + s_1) * x + ...) + s_{M-1} over (M, n, 16)."""
    ctx = FieldCtx(field)
    xm = ctx.const(x, stack.device)
    acc = stack[0]
    for i in range(1, stack.shape[0]):
        acc = add_mod(mont_mul(acc, xm, ctx), stack[i], ctx)
    return acc


def kate_powers(b: int, p: int) -> List[int]:
    """The powers of b that kernel E multiplies by, as csrc/polyeval.cu's
    KateTable holds them: b^(2^e) for e up to a look-back round's rows
    (log2 of TILE_ROWS, 32 tiles a window, a window a warp), b^(R l) for the
    32 lanes l and b^(32 R w) for the warps w of a tile (R rows a thread),
    and b^j for j = 0 .. R; by products, not exponentiations, since a call
    builds them on the host."""
    rows, warps = scan_ops.SCAN_ROWS, scan_ops.SCAN_THREADS // 32
    pow2 = [b % p]
    for _ in range((scan_ops.TILE_ROWS * 32 * warps).bit_length() - 1):
        pow2.append(pow2[-1] * pow2[-1] % p)
    row = [1]
    for _ in range(rows):
        row.append(row[-1] * b % p)
    lane = [1]
    for _ in range(31):
        lane.append(lane[-1] * row[rows] % p)
    warp, step = [1], lane[31] * row[rows] % p
    for _ in range(warps - 1):
        warp.append(warp[-1] * step % p)
    return pow2 + lane + warp + row


def kate_words(ctx: FieldCtx, b: int):
    """kate_powers of b in Montgomery form, 8 words each, as kernel E takes
    them by value."""
    p, r = ctx.p_int, ctx.r_int
    vals = kate_powers(b % p, p)
    raw = b"".join((v * r % p).to_bytes(32, "little") for v in vals)
    return (ctypes.c_uint32 * (8 * len(vals))).from_buffer_copy(raw)


def kate_launch(coeffs: torch.Tensor, b: int, ctx: FieldCtx) -> torch.Tensor:
    """Kernel E on a CUDA tensor (n, 16): one device kernel."""
    if coeffs.dim() != 2 or coeffs.shape[1] != NLIMBS:
        raise ValueError(f"kate_division_mont: expected (n, 16) limbs, got {tuple(coeffs.shape)}")
    a = coeffs.to(torch.int32).contiguous()
    n = a.shape[0]
    q = torch.empty_like(a)
    if n == 0:
        return q
    _build.check_tensor(a, (n, NLIMBS), "coeffs", a.device, align=16)
    words = scan_ops.scratch_words(n)
    scratch = torch.empty(words, dtype=torch.int32, device=a.device)
    err = _lib().kate_div(a.data_ptr(), q.data_ptr(), scratch.data_ptr(), words, n, kate_words(ctx, b),
                          ctypes.byref(_build.field_consts(ctx.p_int)), _stream(a))
    _build.check(err, "kate_div")
    LAUNCHES["kate_div"] += 1
    return q


def kate_division_mont(field: Type[FieldElement], coeffs: torch.Tensor, b: int) -> torch.Tensor:
    """(p(X) - p(b)) / (X - b) over (n, 16) Montgomery limbs; returns n limbs
    with the top coefficient zero."""
    if _build.on_card(coeffs, "kate_division_mont"):
        return kate_launch(coeffs, b, FieldCtx(field))
    return kate_division_mont_plain(field, coeffs, b)


def kate_division_mont_plain(field: Type[FieldElement], coeffs: torch.Tensor, b: int) -> torch.Tensor:
    ctx = FieldCtx(field)
    n = coeffs.shape[0]
    s = coeffs.flip(0)  # s[t] accumulates sum_{u<=t} r_u b^(t-u)
    bd = ctx.const(b, coeffs.device)
    d = 1
    while d < n:
        s = torch.cat([s[:d], add_mod(s[d:], mont_mul(s[:-d], bd, ctx), ctx)], dim=0)
        d *= 2
        if d < n:
            bd = mont_mul(bd, bd, ctx)
    s = s.flip(0)  # s[i] = sum_{j>=i} a_j b^(j-i)
    return torch.cat([s[1:], torch.zeros_like(s[:1])], dim=0)
