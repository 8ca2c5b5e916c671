"""Prefix-product scans and Montgomery-trick batch inversion on limb tensors.

Counterpart of `halo2_tpu/ops/scan.py`. Each public function runs kernel C
(`csrc/scan.cu`) for a CUDA tensor and its plain version (`*_plain`) for a
CPU tensor, and raises for any other device.

Kernel C is a single-pass scan with a decoupled look-back (`csrc/scan.cuh`):
one launch a scan over tiles of TILE_ROWS rows, each tile's carry read from
the tiles before it. `batch_invert` is two such launches: the prefix
products of the nonzero rows, then the same scan from the last row back,
starting from the inverse of the total, which the card takes by a binary
GCD (`inverse_model` is that algorithm step for step in Python integers);
so nothing is read back to the host. `launch_args` and `scratch_words` are
the launch's preparation in Python, so that the CPU tests reach them.

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
import functools
from typing import List, Optional, Tuple

import torch

from . import _build
from .field import NLIMBS, FieldCtx, is_zero, mont_mul, select

SCAN_ROWS = 2  # csrc/scan.cuh kScanRows: rows a thread
SCAN_THREADS = 128  # kScanThreads: threads a tile
TILE_ROWS = SCAN_ROWS * SCAN_THREADS  # kTileRows
MODES = ("inclusive", "exclusive", "invert")  # csrc/scan.cu scan_rows' mode 0, 1, 2
KERNELS_PER_CALL = {"inclusive": 1, "exclusive": 1, "invert": 2}  # device kernels a call
LAUNCHES = {"scan": 0}  # kernel C's device kernels

# the inverse (csrc/batch_invert.cuh fe_inverse_gcd): batches of INV_STEPS divsteps,
# at most INV_BATCHES (600 divsteps; 590 suffice below 2^256)
INV_STEPS = 30
INV_BATCHES = 20
_M30 = (1 << 30) - 1

_P = ctypes.c_void_p
_W8 = ctypes.c_uint32 * 8
_SIG = {"scan_rows": (ctypes.c_int, _P, _P, _P, ctypes.c_longlong, _P, ctypes.c_longlong, _P, _P, _P),
        "scan_tile_rows": ()}


def scan_tiles(n: int) -> int:
    """Row tiles of a scan over n rows; a launch has one block more (the
    block that writes the scan's initial value)."""
    return -(-n // TILE_ROWS)


def scratch_words(n: int, scans: int = 1) -> int:
    """32-bit words of the scratch of `scans` scans over n rows: per scan
    the ticket counter and a flag per descriptor (T + 2, rounded up to 16
    bytes), then an aggregate and an inclusive prefix per descriptor, each
    a state of 8 words (kernels C and E alike)."""
    tiles = scan_tiles(n)
    return scans * (-(-(tiles + 2) // 4) * 4 + (tiles + 1) * 2 * 8)


def launch_args(vals: torch.Tensor, init: Optional[torch.Tensor] = None):
    """(vals, init, tiles) of one launch on an (n, 16) tensor: the rows and
    init as the kernel reads them (int32, contiguous; init one row) and the
    number of row tiles, ceil(n / TILE_ROWS)."""
    if vals.dim() != 2 or vals.shape[1] != NLIMBS:
        raise ValueError(f"scan: expected (n, 16) limbs, got {tuple(vals.shape)}")
    vals = vals.to(torch.int32).contiguous()
    if init is not None:
        if init.numel() != NLIMBS:
            raise ValueError(f"scan: init must be one (16,) element, got {tuple(init.shape)}")
        init = init.to(torch.int32).reshape(NLIMBS).contiguous()
    return vals, init, scan_tiles(vals.shape[0])


@functools.lru_cache(maxsize=None)
def r3_words(p: int):
    """R^3 mod p (R = 2^256) as the 8 words kernel C takes by value: one
    product by it turns (a R)^-1 into a^-1 R."""
    v = pow(1 << 256, 3, p)
    return _W8(*[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)])


def launch(mode: str, vals: torch.Tensor, ctx: FieldCtx, init: Optional[torch.Tensor] = None):
    """Kernel C on a CUDA tensor: "inclusive" or "exclusive" (times `init`)
    prefix products along axis 0 (one device kernel), or "invert" (batch
    inversion, zeros to zero; two). No readback."""
    vals, init, _ = launch_args(vals, init)
    if init is not None and init.device != vals.device:
        raise ValueError(f"scan: init on {init.device}, rows on {vals.device}")
    n = vals.shape[0]
    out = torch.empty_like(vals)
    if n == 0:
        return out
    for t, name in ((vals, "vals"), (out, "out"), (init, "init")):
        if t is not None:
            _build.check_tensor(t, t.shape, name, vals.device, align=16)
    words = scratch_words(n, KERNELS_PER_CALL[mode])
    scratch = torch.empty(words, dtype=torch.int32, device=vals.device)
    lib = _build.load("scan", _SIG)
    if lib.scan_tile_rows() != TILE_ROWS:
        raise RuntimeError(f"scan: the library's tiles hold {lib.scan_tile_rows()} rows, not {TILE_ROWS}")
    err = lib.scan_rows(MODES.index(mode), vals.data_ptr(), out.data_ptr(), scratch.data_ptr(), words,
                        None if init is None else init.data_ptr(), n, r3_words(ctx.p_int),
                        ctypes.byref(_build.field_consts(ctx.p_int)),
                        torch.cuda.current_stream(vals.device).cuda_stream)
    _build.check(err, f"scan {mode}")
    LAUNCHES["scan"] += KERNELS_PER_CALL[mode]
    return out


def _to30(x: int) -> List[int]:
    return [(x >> (30 * i)) & _M30 for i in range(8)] + [x >> 240]


def _from30(limbs: List[int]) -> int:
    return sum(v << (30 * i) for i, v in enumerate(limbs))


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >> 31 else v


def _divsteps(zeta: int, f0: int, g0: int) -> Tuple[int, Tuple[int, int, int, int]]:
    """INV_STEPS divsteps on the low 32 bits of f and g, in 32-bit words as
    csrc/batch_invert.cuh divsteps_30 takes them (a run of g's zero low bits at once,
    and up to 8 divsteps that add f to an odd g at once): the new zeta and
    the matrix."""
    m32 = 0xFFFFFFFF
    u, v, q, r, f, g = 1, 0, 0, 1, f0 & m32, g0 & m32
    i = INV_STEPS
    while True:
        low = g | ((m32 << i) & m32)
        zeros = (low & -low).bit_length() - 1
        g, u, v = g >> zeros, (u << zeros) & m32, (v << zeros) & m32
        zeta, i = zeta - zeros, i - zeros
        if i == 0:
            break
        if zeta < 0:
            f, u, v, g, q, r = g, q, r, -f & m32, -u & m32, -v & m32
            zeta = -zeta - 1
        limit = min(zeta + 1, i)
        mask = (m32 >> (32 - limit)) & 255
        inv = f
        inv = inv * (2 - f * inv) & m32
        inv = inv * (2 - f * inv) & m32
        w = -(g * inv) & mask
        g, q, r = (g + f * w) & m32, (q + u * w) & m32, (r + v * w) & m32
    return zeta, (_i32(u), _i32(v), _i32(q), _i32(r))


def _apply(a: List[int], b: List[int], ta: int, tb: int, p30=None, m: int = 0) -> List[int]:
    """(ta a + tb b + m p) / 2^30 on 9 limbs, limb by limb with a 64-bit
    carry as the kernel's update_fg / update_de: the new limbs."""
    c = ta * a[0] + tb * b[0] + (m * p30[0] if p30 else 0)
    assert c & _M30 == 0
    c >>= 30
    out = []
    for i in range(1, 9):
        c += ta * a[i] + tb * b[i] + (m * p30[i] if p30 else 0)
        assert -(1 << 63) <= c < 1 << 63
        out.append(c & _M30)
        c >>= 30
    assert -(1 << 31) <= c < 1 << 31
    return out + [c]


def inverse_model(x: int, p: int) -> Tuple[int, int]:
    """(x^-1 mod p, batches) for x in [1, 2p) not a multiple of p: the
    kernel's inverse (csrc/batch_invert.cuh fe_inverse_gcd) step for step, in the
    same 30-bit limbs and batches of INV_STEPS divsteps, at most INV_BATCHES;
    the kernel then multiplies by R^3 (r3_words), which this leaves out."""
    if x >= p:
        x -= p
    p30, pinv = _to30(p), pow(p, -1, 1 << 30)
    f, g, d, e = _to30(p), _to30(x), _to30(0), _to30(1)
    zeta, batches = -1, 0
    while batches < INV_BATCHES and any(g):
        zeta, (u, v, q, r) = _divsteps(zeta, f[0], g[0])
        sd, se = -(d[8] < 0), -(e[8] < 0)
        md, me = _i32((u & sd) + (v & se)), _i32((q & sd) + (r & se))
        cd, ce = u * d[0] + v * e[0], q * d[0] + r * e[0]
        md = _i32(md - ((pinv * (cd & 0xFFFFFFFF) + md) & _M30))
        me = _i32(me - ((pinv * (ce & 0xFFFFFFFF) + me) & _M30))
        d, e = _apply(d, e, u, v, p30, md), _apply(d, e, q, r, p30, me)
        f, g = _apply(f, g, u, v), _apply(f, g, q, r)
        batches += 1
        assert -2 * p < _from30(d) < p and -2 * p < _from30(e) < p
    if any(g):
        raise ArithmeticError(f"inverse_model: g is not 0 after {INV_BATCHES} batches")
    fv, dv = _from30(f), _from30(d)
    assert fv in (1, -1)
    dv = -dv if fv < 0 else dv
    dv += p if dv < 0 else 0
    dv += p if dv < 0 else 0
    return (dv - p if dv >= p else dv), batches


# Inputs below p that need the most divsteps of those a local search found
# (528-530 of the 590 allowed, 18 batches), by modulus. A search: flip one
# or two random bits of x while its divsteps to g = 0 do not fall.
HARD_INPUTS = {
    0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001: (  # Fp
        0x2E91345DBD10E7B313ABAEF02D3A0C57D81E3F27E4FFC6C71A57269E30EC6A6F,
        0x05E7653A158D066C8D3B2009DA7112F01FC9FB43622BE60608AEAD76D78F4E79),
    0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001: (  # Fq
        0x3B753AE201E64EF4E0EE59900EDD04359521907D5D9DC9F89918E811092F922C,
        0x09241A1A266C4358C8AA037D9EB14FA3746D1905245A09EE433D89CCBF4A5EF8),
    0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001: (  # FrBn
        0x008A9D72A1060DF2EBC8BFA2D38AE5996CECE9D20C654352E737276E5D77C3B5,
        0x1FD404C09E88C14B74B3A4519EDA908D78BB0B89DA27D6AB400B74CD66931ED6),
    0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47: (  # FqBn
        0x1F2E9662AC8E815EA679D7B412DE51B27EE7F84F62CF3A88352C8D6B4774DD09,
        0x1DBD1C7281E74EFD68F37D940ED824359531885D5D9DC9F81018C811892D902C),
}


def inverse_edges(p: int) -> List[int]:
    """Inputs of the inverse that sit at its edges: 1, 2, p - 1,
    (p + 1) / 2, R mod p, R^-1 mod p, 2^255 mod p, two in [p, 2p) (the lazy
    domain), and HARD_INPUTS[p] where p is there."""
    r = (1 << 256) % p
    return [1, 2, p - 1, (p + 1) // 2, r, pow(r, -1, p), (1 << 255) % p, p + 1, 2 * p - 1,
            *HARD_INPUTS.get(p, ())]


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
