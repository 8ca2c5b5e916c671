"""The grand products' z columns on limb tensors: kernel G.

Counterpart of the JAX package's jitted z columns,
`halo2_tpu/plonk/lookup_prover.py` `_lookup_z_fn` and
`halo2_tpu/plonk/permutation_prover.py` `_perm_z_fn`. `lookup_z` and
`perm_z` run kernel G (`csrc/grand_product.cu`) for CUDA tensors and their
plain versions (`lookup_z_plain`, `perm_z_plain`) for CPU tensors, and
raise for any other device.

Kernel G is three launches of kernel C's single-pass look-back scan
(`csrc/scan.cuh`) and one memset a z column: the rows' denominators formed
from the columns and their prefix products; the same scan from the last row
back, from the inverse of the total (a binary GCD on the card), which
leaves each row's fraction num_i / den_i with its numerator formed in the
row; and the prefix products of the fractions from `init`, written as the
z rows, the random rows and `last_z`. The columns, the sigma columns, the
powers of omega, the random rows and the outputs are pointers in the
launches' parameters (`GrandParams`), beta, gamma and the chunk's
beta delta^(base + j) values there, so nothing is stacked, concatenated or
copied, and nothing is read back: `last_z` stays on the card as the next
chunk's `init`. `pack` is the launch's preparation in Python, so that the
CPU tests reach it.

The plain versions are the JAX programs' order of operations in torch:
kernel A's products and sums (`ops/field.py`) around `ops/scan.py`'s batch
inversion and exclusive prefix product. The kernel's outputs lie in
[0, 2p) and equal theirs as values mod p, not always in their limbs.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Type

import torch

from ..fields import FieldElement
from . import _build
from . import scan as scan_ops
from .field import NLIMBS, FieldCtx, add_mod, mont_mul

MAX_COLS = 32  # csrc/grand_product.cu kMaxCols: columns of a permutation chunk
KINDS = ("lookup", "permutation")  # GrandParams.kind 0, 1
KERNELS_PER_CALL = 3  # device kernels a z column
LAUNCHES = {"grand_product": 0}  # kernel G's device kernels

_P = ctypes.c_void_p
_W8 = ctypes.c_uint32 * 8
_SIG = {"grand_product": (_P, ctypes.c_longlong, _P), "grand_tile_rows": (), "grand_params_size": ()}


class Lookback(ctypes.Structure):
    """Host mirror of `Lookback` in csrc/scan.cuh (filled in on the C side)."""

    _fields_ = [("words", _P), ("values", _P)]


class GrandParams(ctypes.Structure):
    """Host mirror of `GrandParams` in csrc/grand_product.cu (the launches'
    parameters; the C entry point fills in `tiles` and `lb`)."""

    _fields_ = [
        ("cols", _P * MAX_COLS), ("sigmas", _P * MAX_COLS), ("omega", _P), ("rand", _P), ("init", _P),
        ("out", _P), ("last_z", _P), ("den", _P), ("scratch", _P),
        ("n", ctypes.c_longlong), ("tiles", ctypes.c_longlong),
        ("kind", ctypes.c_int), ("ncols", ctypes.c_int), ("blinding", ctypes.c_int),
        ("beta", _W8), ("gamma", _W8), ("dpows", _W8 * MAX_COLS), ("r3", _W8),
        ("k", _build.FieldConsts), ("lb", Lookback * 3),
    ]


def _lib():
    lib = _build.load("grand_product", _SIG)
    if lib.grand_tile_rows() != scan_ops.TILE_ROWS:
        raise RuntimeError(f"grand_product: the library's tiles hold {lib.grand_tile_rows()} rows, "
                           f"not {scan_ops.TILE_ROWS}")
    if lib.grand_params_size() != ctypes.sizeof(GrandParams):
        raise RuntimeError(f"grand_product: the library's GrandParams has {lib.grand_params_size()} bytes, "
                           f"not {ctypes.sizeof(GrandParams)}")
    return lib


def scratch_words(n: int) -> int:
    """32-bit words of a call's scratch: the three scans' look-back words
    (scan.scratch_words), then a column of n rows for the denominators."""
    return scan_ops.scratch_words(n, KERNELS_PER_CALL) + n * NLIMBS


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def pack(kind: str, ctx: FieldCtx, blinding: int, cols: Sequence[torch.Tensor], beta: int, gamma: int, *,
         out: torch.Tensor, scratch: torch.Tensor, rand_rows: torch.Tensor, sigmas: Sequence[torch.Tensor] = (),
         omega: Optional[torch.Tensor] = None, dpows: Sequence[int] = (), init: Optional[torch.Tensor] = None,
         last_z: Optional[torch.Tensor] = None) -> GrandParams:
    """The parameters of one z column's launches, every tensor checked: the
    columns (a lookup's a, s, a', s'; a chunk's columns, each with its
    sigma column and dpows value), omega (n, 16), rand_rows (blinding, 16),
    init and last_z (16,), out (n, 16) and scratch (scratch_words(n),)
    contiguous int32 on one device, 16-byte aligned."""
    if kind not in KINDS:
        raise ValueError(f"grand_product: kind {kind!r}, not one of {KINDS}")
    n = out.shape[0]
    dev = out.device
    ncols = len(cols)
    if kind == "lookup" and (ncols != 4 or sigmas or dpows or omega is not None):
        raise ValueError("grand_product: a lookup takes four columns and no sigma, dpows or omega")
    if kind == "permutation" and not (1 <= ncols <= MAX_COLS and len(sigmas) == ncols == len(dpows)
                                      and omega is not None):
        raise ValueError(f"grand_product: a permutation chunk takes 1-{MAX_COLS} columns, a sigma column "
                         f"and a dpows value each, and omega; got {ncols}, {len(sigmas)}, {len(dpows)}")
    if not 0 <= blinding < n:
        raise ValueError(f"grand_product: {blinding} blinding rows of {n}")
    checks = [(out, (n, NLIMBS), "out"), (scratch, (scratch_words(n),), "scratch"),
              (rand_rows, (blinding, NLIMBS), "rand_rows")]
    checks += [(c, (n, NLIMBS), f"column {j}") for j, c in enumerate(cols)]
    checks += [(s, (n, NLIMBS), f"sigma {j}") for j, s in enumerate(sigmas)]
    checks += [(t, (n, NLIMBS), "omega") for t in (omega,) if t is not None]
    checks += [(t, (NLIMBS,), name) for t, name in ((init, "init"), (last_z, "last_z")) if t is not None]
    for t, shape, name in checks:
        _build.check_tensor(t, shape, name, dev, align=16)
    p = ctx.p_int
    params = GrandParams(omega=None if omega is None else omega.data_ptr(),
                         rand=rand_rows.data_ptr() if blinding else None,
                         init=None if init is None else init.data_ptr(), out=out.data_ptr(),
                         last_z=None if last_z is None else last_z.data_ptr(),
                         den=scratch.data_ptr() + 4 * scan_ops.scratch_words(n, KERNELS_PER_CALL),
                         scratch=scratch.data_ptr(), n=n, kind=KINDS.index(kind), ncols=ncols,
                         blinding=blinding, beta=_build.mont_words(p, beta), gamma=_build.mont_words(p, gamma),
                         r3=scan_ops.r3_words(p), k=_build.field_consts(p))
    for j, c in enumerate(cols):
        params.cols[j] = c.data_ptr()
    for j, s in enumerate(sigmas):
        params.sigmas[j] = s.data_ptr()
    for j, d in enumerate(dpows):
        params.dpows[j] = _build.mont_words(p, d)
    return params


def launch(kind: str, ctx: FieldCtx, blinding: int, cols: Sequence[torch.Tensor], beta: int, gamma: int,
           rand_rows: torch.Tensor, sigmas: Sequence[torch.Tensor] = (), omega: Optional[torch.Tensor] = None,
           dpows: Sequence[int] = (), init: Optional[torch.Tensor] = None):
    """Kernel G on CUDA tensors: (z (n, 16), last_z (16,), or None for a
    lookup). Three device kernels and one memset; nothing is read back."""
    cols = [_rows(c) for c in cols]
    sigmas = [_rows(s) for s in sigmas]
    omega = None if omega is None else _rows(omega)
    init = None if init is None else _rows(init).reshape(NLIMBS)
    rand_rows = _rows(rand_rows)
    dev = cols[0].device
    n = cols[0].shape[0]
    out = torch.empty((n, NLIMBS), dtype=torch.int32, device=dev)
    last_z = torch.empty(NLIMBS, dtype=torch.int32, device=dev) if kind == "permutation" else None
    scratch = torch.empty(scratch_words(n), dtype=torch.int32, device=dev)
    params = pack(kind, ctx, blinding, cols, beta, gamma, out=out, scratch=scratch, rand_rows=rand_rows,
                  sigmas=sigmas, omega=omega, dpows=dpows, init=init, last_z=last_z)
    err = _lib().grand_product(ctypes.byref(params), scan_ops.scratch_words(n, KERNELS_PER_CALL),
                               torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"grand_product {kind}")
    LAUNCHES["grand_product"] += KERNELS_PER_CALL
    return out, last_z


def lookup_z(field: Type[FieldElement], blinding: int, ci: torch.Tensor, ct: torch.Tensor, pi: torch.Tensor,
             pt: torch.Tensor, beta: int, gamma: int, rand_rows: torch.Tensor) -> torch.Tensor:
    """The lookup's blinded z column (lookup/prover.rs:168-330):
    z[0] = 1; z[i+1] = z[i] (a_i + beta)(s_i + gamma) /
    ((a'_i + beta)(s'_i + gamma)); rows [n - blinding, n) are rand_rows.
    ci, ct, pi, pt: the compressed input and table and their permutations,
    (n, 16) Montgomery limbs; beta, gamma host values."""
    if _build.on_card(ci, "lookup_z"):
        return launch("lookup", FieldCtx(field), blinding, (ci, ct, pi, pt), beta, gamma, rand_rows)[0]
    return lookup_z_plain(field, blinding, ci, ct, pi, pt, beta, gamma, rand_rows)


def lookup_z_plain(field: Type[FieldElement], blinding: int, ci: torch.Tensor, ct: torch.Tensor,
                   pi: torch.Tensor, pt: torch.Tensor, beta: int, gamma: int,
                   rand_rows: torch.Tensor) -> torch.Tensor:
    ctx = FieldCtx(field)
    n = ci.shape[0]
    beta_c, gamma_c = ctx.const(beta, ci.device), ctx.const(gamma, ci.device)
    denom = mont_mul(add_mod(pi, beta_c, ctx), add_mod(pt, gamma_c, ctx), ctx)
    denom_inv = scan_ops.batch_invert(denom, ctx)
    product = mont_mul(denom_inv, mont_mul(add_mod(ci, beta_c, ctx), add_mod(ct, gamma_c, ctx), ctx), ctx)
    z = scan_ops.exclusive_prefix_product(product, ctx)
    return torch.cat([z[: n - blinding], rand_rows], dim=0)


def perm_z(field: Type[FieldElement], blinding: int, cols: Sequence[torch.Tensor], sigmas: Sequence[torch.Tensor],
           omega_pw: torch.Tensor, beta: int, gamma: int, dpows: Sequence[int], init: Optional[torch.Tensor],
           rand_rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One permutation chunk's blinded z column and its last_z
    (permutation/prover.rs:44-160): z[0] = init (one where it is None);
    z[i+1] = z[i] prod_j (v_j + beta delta^(base+j) omega^i + gamma) /
    prod_j (v_j + beta sigma_j + gamma); rows [n - blinding, n) are
    rand_rows; last_z = z[n - blinding - 1]. cols, sigmas: the chunk's
    columns and sigma columns, each (n, 16); omega_pw (n, 16) = omega^i;
    dpows: beta delta^(base + j) mod p, host values; init (16,) or None."""
    if _build.on_card(omega_pw, "perm_z"):
        return launch("permutation", FieldCtx(field), blinding, cols, beta, gamma, rand_rows, sigmas=sigmas,
                      omega=omega_pw, dpows=dpows, init=init)
    return perm_z_plain(field, blinding, cols, sigmas, omega_pw, beta, gamma, dpows, init, rand_rows)


def perm_z_plain(field: Type[FieldElement], blinding: int, cols: Sequence[torch.Tensor],
                 sigmas: Sequence[torch.Tensor], omega_pw: torch.Tensor, beta: int, gamma: int,
                 dpows: Sequence[int], init: Optional[torch.Tensor],
                 rand_rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    ctx = FieldCtx(field)
    dev = omega_pw.device
    n = omega_pw.shape[0]
    beta_c, gamma_c = ctx.const(beta, dev), ctx.const(gamma, dev)
    dpows_c = ctx.consts(list(dpows), dev)
    # denominator product: prod_j (v_j + beta*sigma_j + gamma)
    modified = None
    for j in range(len(cols)):
        term = add_mod(add_mod(cols[j], mont_mul(sigmas[j], beta_c, ctx), ctx), gamma_c, ctx)
        modified = term if modified is None else mont_mul(modified, term, ctx)
    modified = scan_ops.batch_invert(modified, ctx)
    # numerator product: prod_j (v_j + beta*delta^(base+j)*omega^i + gamma)
    for j in range(len(cols)):
        term = add_mod(add_mod(cols[j], mont_mul(omega_pw, dpows_c[j], ctx), ctx), gamma_c, ctx)
        modified = mont_mul(modified, term, ctx)
    z = scan_ops.exclusive_prefix_product(modified, ctx, init=init)
    last_z = z[n - (blinding + 1)]
    z = torch.cat([z[: n - blinding], rand_rows], dim=0)
    return z, last_z
