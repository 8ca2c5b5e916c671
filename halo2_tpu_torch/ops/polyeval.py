"""Batched polynomial evaluation, Horner fold and Kate division on limb tensors.

Counterpart of `halo2_tpu/ops/polyeval.py`:

  * `batch_eval_mont`: M stacked polynomials at (few) points;
    `device_powers`: [1, x, ..., x^(n-1)].
  * `horner_fold_mont`: fold polynomials by a scalar.
  * `kate_division_mont`: (p(X) - p(b)) / (X - b).

`batch_eval_mont`, `device_powers` / `point_powers` and
`kate_division_mont` run their kernels (`csrc/polyeval.cu`: kernel D for
the first three, kernel E for the last) for a CUDA tensor or device and
their plain versions (`*_plain`) for a CPU one, and raise for any other
device; none reads anything back to the host on the card. Kernel D takes
each point's L squares x^(2^e) (`squares_words`, L host squarings a point)
and the polynomials grouped by point in the launch's parameters, so a call
copies nothing to the card; a block forms its rows' powers from the squares
in shared memory, groups of its threads share the point's polynomials
(`eval_geometry`), and the last block to finish sums the warps' partials:
one launch a call (`point_powers`, the powers of a host point, too).
Kernel E is one launch of kernel C's
single-pass look-back scan (`csrc/scan.cuh`), from the last row back, over
the affine maps v -> b v + a_i of the suffix recurrence
s_i = a_i + b s_{i+1}. Their outputs lie in [0, 2p) and equal the plain
versions' as values mod p.

The plain versions are the JAX package's algorithms in torch: a
log-doubling power ladder and a log-depth modular tree sum; for Kate
division, a Hillis-Steele scan over the reversed coefficients in which
round r adds b^(2^r) times the array shifted by 2^r.

`horner_fold_mont` runs kernel H (`csrc/horner.cu`) for CUDA tensors: one
launch, a thread a row folding the M pieces in registers, the pieces by
pointer and x by value in the launch's parameters (`HornerParams`), so the
caller stacks nothing; its plain version (`horner_fold_mont_plain`) is the
loop of kernel A's products and sums, which the kernel equals bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Type

import numpy as np
import torch

from ..fields import FieldElement
from . import _build
from .field import NLIMBS, FieldCtx, add_mod, mont_mul
from . import scan as scan_ops

# csrc/polyeval.cu's kernel D (which rejects a launch beyond them): threads
# a block (kEvalThreads), bits of a row index (kMaxBits), the squares a
# launch takes by value over its points (kTableFe), and its slots, the
# polynomials, then its points' first slots and M (kMaxSlots)
EVAL_THREADS = 128
MAX_BITS = 29
TABLE_FE = 96
MAX_SLOTS = 256
# kernel D's row blocks over all points at most: four a streaming
# multiprocessor, all resident at once
EVAL_MAX_BLOCKS = 528
MAX_PIECES = 64  # csrc/horner.cu kMaxPieces: the pieces kernel H folds
LAUNCHES = {"batch_eval": 0, "kate_div": 0, "horner": 0}  # kernels D, E and H: their device kernels

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {
    "batch_eval": (_I, _I, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P, _P),
    "kate_div": (_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _P, _P, _P),
    "polyeval_tile_rows": (),
    "kate_table_entries": (),
}
_HORNER_SIG = {"horner_fold": (_P, _P), "horner_params_size": ()}


def _lib():
    lib = _build.load("polyeval", _SIG)
    if lib.polyeval_tile_rows() != scan_ops.TILE_ROWS:
        raise RuntimeError(f"polyeval: the library's tiles hold {lib.polyeval_tile_rows()} rows, "
                           f"not {scan_ops.TILE_ROWS}")
    if lib.kate_table_entries() != len(kate_powers(1, 3)):
        raise RuntimeError(f"polyeval: the library's Kate table holds {lib.kate_table_entries()} entries, "
                           f"not {len(kate_powers(1, 3))}")
    return lib


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def table_bits(n: int) -> int:
    """L: enough bits for every row index below n."""
    return max(1, (n - 1).bit_length())


def eval_geometry(n: int, per_point: Sequence[int]):
    """Kernel D's (G, rows, blocks) for polynomials of n rows, per_point[q]
    of them at point q: the block's threads in G groups that share the
    point's polynomials, `rows` rows a thread (1, 2 or 4) and `blocks` row
    blocks a point. A thread's products run one after another, rows (1 +
    ceil(M_q / G)) of them, so the choice is the shortest such run whose
    blocks over all points stay within EVAL_MAX_BLOCKS, then the fewest
    blocks; where no choice stays within it the card is busy anyway, and
    the fewest blocks win. The powers mode takes per_point all 0, so
    G = 1."""
    Q, mq = len(per_point), max(per_point)
    best = None
    for G in (1, 2, 4):
        if EVAL_THREADS // G < 32 or (G > 1 and G // 2 >= mq):
            break
        for rows in (1, 2, 4):
            blocks = eval_blocks(n, rows, G)
            serial, over = rows * (1 + -(-mq // G)), Q * blocks > EVAL_MAX_BLOCKS
            key = (over, Q * blocks, serial) if over else (over, serial, Q * blocks)
            if best is None or key < best[0]:
                best = (key, (G, rows, blocks))
    return best[1]


def eval_blocks(n: int, rows: int, G: int = 1) -> int:
    """Kernel D's row blocks a point at `rows` rows a thread and G groups
    of threads a block."""
    return -(-n // (rows * (EVAL_THREADS // G)))


def squares_words(ctx: FieldCtx, points: Sequence[int], L: int) -> bytes:
    """The points' squares x^(2^e), e < L, in Montgomery form, as kernel D
    takes them by value: 8 little-endian words each, point after point; L
    squarings a point on the host."""
    p, r = ctx.p_int, ctx.r_int
    out = []
    for x in points:
        w = int(x) % p
        for _ in range(L):
            out.append((w * r % p).to_bytes(32, "little"))
            w = w * w % p
    return b"".join(out)


def eval_launches(points: Sequence[int], p: int, L: int):
    """Kernel D's launches for polynomials at `points` (host ints), each
    (its points, its slots, the polynomials at each point): the distinct
    points mod p in sorted order, at most TABLE_FE // L of them a launch,
    and the slots, the polynomials' indices grouped by point, then each
    point's first slot and the launch's polynomials, at most MAX_SLOTS in
    all (a point with more polynomials than that spreads over launches).
    Every evaluation of the proofs fits one launch."""
    if len(points) > 1 << 16:
        raise ValueError(f"batch_eval_mont: {len(points)} polynomials; kernel D indexes at most 2^16")
    by_point = {}
    for m, x in enumerate(points):
        by_point.setdefault(int(x) % p, []).append(m)
    launches, cur, used = [], [], 1

    def close():
        xs = [x for x, _ in cur]
        counts = [len(ms) for _, ms in cur]
        slots = [m for _, ms in cur for m in ms] + np.cumsum([0] + counts).tolist()
        launches.append((xs, slots, counts))

    for x in sorted(by_point):
        polys = by_point[x]
        while polys:
            if len(cur) == TABLE_FE // L or used + 2 > MAX_SLOTS:
                close()
                cur, used = [], 1
            take = min(len(polys), MAX_SLOTS - used - 1)
            cur.append((x, polys[:take]))
            used, polys = used + take + 1, polys[take:]
    close()
    return launches


def _launch(n: int, Q: int, L: int, out: torch.Tensor, ctx: FieldCtx, *, rows: int, G: int = 1, blocks: int,
            coeffs=None, x=None, slots=(), squares=b"", partial=None, counter=None):
    """One launch of kernel D (csrc/polyeval.cu batch_eval): with slots,
    the evaluations of their polynomials of coeffs into their rows of out;
    else the powers of the points (x on the card, or their squares) into
    out (Q, n, 16)."""
    M = len(slots) - Q - 1 if slots else 0
    slot_arr = (ctypes.c_uint16 * max(1, len(slots)))(*slots)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _lib().batch_eval(rows, G, ptr(coeffs), ptr(x), slot_arr, squares or None, ptr(partial), ptr(counter),
                            out.data_ptr(), n, M, Q, L, blocks, ctypes.byref(_build.field_consts(ctx.p_int)),
                            _stream(out.device))
    _build.check(err, "batch_eval" if M else "powers")
    LAUNCHES["batch_eval"] += 1


def _check_rows(n: int, what: str) -> int:
    if n > 1 << MAX_BITS:
        raise ValueError(f"{what}: {n} rows; kernel D takes at most 2^{MAX_BITS}")
    return table_bits(n)


def eval_launch(coeffs: torch.Tensor, points: Sequence[int], ctx: FieldCtx) -> torch.Tensor:
    """Kernel D on a CUDA tensor: coeffs (M, n, 16) at the host points ->
    (M, 16) evaluations. Each launch of eval_launches (one on every proof
    path) takes its points' squares and its polynomials' slots in its
    parameters, so the call copies nothing to the card and waits for
    nothing."""
    M, n, _ = coeffs.shape
    coeffs = coeffs.to(torch.int32).contiguous()
    dev = coeffs.device
    out = torch.empty((M, NLIMBS), dtype=torch.int32, device=dev)
    if M == 0:
        return out
    _build.check_tensor(coeffs, (M, n, NLIMBS), "coeffs", dev, align=16)
    L = _check_rows(n, "batch_eval_mont")
    counter = _build.completion_counter(dev)
    for xs, slots, counts in eval_launches(points, ctx.p_int, L):
        G, rows, blocks = eval_geometry(n, counts)
        partial = torch.empty((len(slots) - len(xs) - 1, blocks, 8), dtype=torch.int32, device=dev)
        _launch(n, len(xs), L, out, ctx, rows=rows, G=G, blocks=blocks, coeffs=coeffs, slots=slots,
                squares=squares_words(ctx, xs, L), partial=partial, counter=counter)
    return out


def powers_launch(n: int, ctx: FieldCtx, device, x_mont: torch.Tensor = None, point: int = None) -> torch.Tensor:
    """Kernel D's powers on the card, one launch: x (..., 16) on the card ->
    (..., n, 16) = x^i, or of a host point -> (n, 16), its squares in the
    launch's parameters."""
    if x_mont is not None:
        lead = x_mont.shape[:-1]
        x = x_mont.to(torch.int32).reshape(-1, NLIMBS).contiguous()
        Q = x.shape[0]
    else:
        lead, x, Q = (), None, 1
    out = torch.empty((Q, n, NLIMBS), dtype=torch.int32, device=device)
    if Q and n:
        L = _check_rows(n, "powers")
        if x is not None:
            _build.check_tensor(x, (Q, NLIMBS), "x", x.device, align=16)
        _, rows, blocks = eval_geometry(n, [0] * Q)
        _launch(n, Q, L, out, ctx, rows=rows, blocks=blocks, x=x,
                squares=b"" if x is not None else squares_words(ctx, [point], L))
    return out.reshape(*lead, n, NLIMBS)


def point_powers(ctx: FieldCtx, x: int, n: int, device) -> torch.Tensor:
    """[1, x, ..., x^(n-1)] (n, 16) in Montgomery limbs on `device`, from a
    host point: on the card one launch of kernel D, the point's L squares
    in its parameters; on the CPU the plain ladder."""
    if not _build.on_card(device, "point_powers"):
        return device_powers_plain(ctx.const(x, device), n, ctx)
    return powers_launch(n, ctx, torch.device(device), point=x)


def device_powers(x_mont: torch.Tensor, n: int, ctx: FieldCtx) -> torch.Tensor:
    """[1, x, ..., x^(n-1)] from a (..., 16) Montgomery scalar (on the card
    one launch of kernel D, the squares by a chain on one thread of each
    block; the powers of a host point: point_powers)."""
    if _build.on_card(x_mont, "device_powers"):
        return powers_launch(n, ctx, x_mont.device, x_mont=x_mont)
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
    (M, 16) Montgomery results. Distinct points share their powers (kernel
    D) or one power ladder (plain). On the card one launch of kernel D
    evaluates them all, the points' squares and the polynomials' grouping
    in its parameters: no copy to the card and no wait for it."""
    if not _build.on_card(coeff_stack, "batch_eval_mont"):
        return batch_eval_mont_plain(field, coeff_stack, points)
    return eval_launch(coeff_stack, points, FieldCtx(field))


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


class HornerParams(ctypes.Structure):
    """Host mirror of `HornerParams` in csrc/horner.cu (the launch's
    parameters)."""

    _fields_ = [("pieces", _P * MAX_PIECES), ("out", _P), ("n", ctypes.c_longlong), ("m", _I),
                ("x", ctypes.c_uint32 * 8), ("k", _build.FieldConsts)]


def _horner_lib():
    lib = _build.load("horner", _HORNER_SIG)
    if lib.horner_params_size() != ctypes.sizeof(HornerParams):
        raise RuntimeError(f"horner_fold: the library's HornerParams has {lib.horner_params_size()} bytes, "
                           f"not {ctypes.sizeof(HornerParams)}")
    return lib


def horner_params(pieces: Sequence[torch.Tensor], out: torch.Tensor, x: int, ctx: FieldCtx) -> HornerParams:
    """The parameters of kernel H's launch, every tensor checked: the M
    pieces (2 <= M <= MAX_PIECES) and out, each (n, 16) contiguous int32 on
    one device, 16-byte aligned; x as its Montgomery words."""
    n, dev = out.shape[0], out.device
    if not 2 <= len(pieces) <= MAX_PIECES:
        raise ValueError(f"horner_fold_mont: {len(pieces)} pieces; kernel H takes 2-{MAX_PIECES}")
    for i, t in enumerate((out, *pieces)):
        _build.check_tensor(t, (n, NLIMBS), "out" if i == 0 else f"piece {i - 1}", dev, align=16)
    params = HornerParams(out=out.data_ptr(), n=n, m=len(pieces), x=_build.mont_words(ctx.p_int, x),
                          k=_build.field_consts(ctx.p_int))
    for i, t in enumerate(pieces):
        params.pieces[i] = t.data_ptr()
    return params


def horner_launch(pieces: Sequence[torch.Tensor], x: int, ctx: FieldCtx) -> torch.Tensor:
    """Kernel H on CUDA tensors: one launch, a thread a row."""
    pieces = [t.to(torch.int32).contiguous() for t in pieces]
    out = torch.empty_like(pieces[0])
    if out.shape[0] == 0:
        return out
    params = horner_params(pieces, out, x, ctx)
    err = _horner_lib().horner_fold(ctypes.byref(params), _stream(out.device))
    _build.check(err, "horner_fold")
    LAUNCHES["horner"] += 1
    return out


def horner_fold_mont(field: Type[FieldElement], pieces: Sequence[torch.Tensor], x: int) -> torch.Tensor:
    """acc = (...(s_0 * x + s_1) * x + ...) + s_{M-1} over M pieces of
    (n, 16) (a sequence of tensors, or an (M, n, 16) stack): on the card one
    launch of kernel H, which reads the pieces where they lie. M = 1
    returns the piece."""
    if len(pieces) == 1:
        return pieces[0]
    if _build.on_card(pieces[0], "horner_fold_mont"):
        return horner_launch(pieces, x, FieldCtx(field))
    return horner_fold_mont_plain(field, pieces, x)


def horner_fold_mont_plain(field: Type[FieldElement], pieces: Sequence[torch.Tensor], x: int) -> torch.Tensor:
    ctx = FieldCtx(field)
    xm = ctx.const(x, pieces[0].device)
    acc = pieces[0]
    for i in range(1, len(pieces)):
        acc = add_mod(mont_mul(acc, xm, ctx), pieces[i], ctx)
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
                          ctypes.byref(_build.field_consts(ctx.p_int)), _stream(a.device))
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
