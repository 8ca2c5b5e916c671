"""The grand products' z columns on limb tensors: kernel G.

Counterpart of the JAX package's jitted z columns,
`halo2_tpu/plonk/lookup_prover.py` `_lookup_z_fn` and
`halo2_tpu/plonk/permutation_prover.py` `_perm_z_fn`. `z_columns` computes
every z column of a `create_proof` call, each circuit's permutation chunks
(chained by last_z) and the lookups, by kernel G (`csrc/grand_product.cu`)
for CUDA tensors and by its plain version (`z_columns_plain`: `lookup_z_plain`
and `perm_z_plain` in a loop) for CPU tensors, and raises for any other
device. `lookup_z` and `perm_z` are calls of it with one column.

Kernel G is two launches of kernel C's single-pass look-back scan
(`csrc/scan.cuh`) over every column's tiles and one memset: the prefix
products of each row's (numerator, denominator) pair with the terms formed
in the rows (a zero denominator counts as one, its numerator as zero); then
the same scan of the denominators from the last row back, whose descriptor
0 is a column's init over its denominators' total (inverted by a binary
GCD on the card, the chunks chained there), leaving z. The columns, the
sigma columns, the powers of omega, the random rows and the outputs are
pointers in the launches' parameters (`GrandParams`), beta, gamma and each
chunk's beta delta^(base + j) values there, so nothing is stacked,
concatenated or copied, and nothing is read back: `last_z` stays on the
card. A call of more than MAX_Z columns or MAX_SLOTS columns' pointers is
split into several launches (`launch_groups`), a chunk that starts one
taking the one before's last_z as its init. `pack` is a launch's
preparation in Python, so that the CPU tests reach it.

The plain versions are the JAX programs' order of operations in torch:
kernel A's products and sums (`ops/field.py`) around `ops/scan.py`'s batch
inversion and exclusive prefix product. The kernel's outputs lie in
[0, 2p) and equal theirs as values mod p, not always in their limbs.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple, Type

import torch

from ..fields import FieldElement
from . import _build
from . import scan as scan_ops
from .field import NLIMBS, FieldCtx, add_mod, mont_mul

MAX_Z = 16  # csrc/grand_product.cu kMaxZ: z columns a launch
MAX_SLOTS = 48  # kMaxSlots: their columns, a lookup's four and a chunk's ncols
KINDS = ("lookup", "permutation")  # ZColumn.kind 0, 1
KERNELS_PER_CALL = 2  # device kernels a launch (one memset besides)
PAIR_WORDS = 16  # the forward scan's state, (P, Q); the backward scan's is 8 words
LAUNCHES = {"grand_product": 0}  # kernel G's device kernels

_P = ctypes.c_void_p
_W8 = ctypes.c_uint32 * 8
_SIG = {"grand_product": (_P, ctypes.c_longlong, _P), "grand_tile_rows": (), "grand_params_size": ()}


class LookupColumns(NamedTuple):
    """A lookup's z column inputs: the compressed input and table, their
    permutations ((n, 16) Montgomery limbs each) and its random rows."""

    ci: torch.Tensor
    ct: torch.Tensor
    pi: torch.Tensor
    pt: torch.Tensor
    rand_rows: torch.Tensor


class Chunk(NamedTuple):
    """A permutation chunk's z column inputs: its columns and sigma columns
    ((n, 16) each), beta delta^(base + j) mod p for each column (host
    values) and its random rows."""

    cols: Sequence[torch.Tensor]
    sigmas: Sequence[torch.Tensor]
    dpows: Sequence[int]
    rand_rows: torch.Tensor


class Column(NamedTuple):
    """One z column of a launch: a lookup's four columns or a chunk's, its
    init (16,) or None (one), and whether its init is the column before's
    last_z instead."""

    kind: str
    cols: Sequence[torch.Tensor]
    rand_rows: torch.Tensor
    sigmas: Sequence[torch.Tensor] = ()
    dpows: Sequence[int] = ()
    init: Optional[torch.Tensor] = None
    chain: bool = False


class ZColumn(ctypes.Structure):
    """Host mirror of `ZColumn` in csrc/grand_product.cu."""

    _fields_ = [("rand", _P), ("init", _P), ("out", _P), ("last_z", _P), ("kind", ctypes.c_int),
                ("ncols", ctypes.c_int), ("first", ctypes.c_int), ("chain", ctypes.c_int)]


class GrandParams(ctypes.Structure):
    """Host mirror of `GrandParams` in csrc/grand_product.cu (the launches'
    parameters; the C entry point fills in `tiles`)."""

    _fields_ = [
        ("cols", _P * MAX_SLOTS), ("sigmas", _P * MAX_SLOTS), ("omega", _P), ("scratch", _P),
        ("z", ZColumn * MAX_Z), ("n", ctypes.c_longlong), ("tiles", ctypes.c_longlong),
        ("nz", ctypes.c_int), ("blinding", ctypes.c_int), ("beta", _W8), ("gamma", _W8),
        ("dpows", _W8 * MAX_SLOTS), ("r3", _W8), ("k", _build.FieldConsts),
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


def _flag_words(tiles: int, nz: int) -> int:
    return -(-(1 + nz * (tiles + 1)) // 4) * 4


def scratch_words(n: int, blinding: int, nz: int) -> int:
    """32-bit words of a launch's scratch over nz columns, each scanning its
    U = n - blinding - 1 rows in T tiles (csrc/grand_product.cu
    grand_scratch_words): each launch's ticket counter and T + 1 flags a
    column (rounded up to 16 bytes), then T + 1 descriptors a column of
    two states each, 16 words in the forward launch and 8 in the backward
    one, then U den' rows of 8 words a column."""
    rows = n - blinding - 1
    tiles = scan_ops.scan_tiles(rows)
    return 2 * _flag_words(tiles, nz) + nz * (tiles + 1) * 2 * (PAIR_WORDS + 8) + nz * rows * 8


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def pack(ctx: FieldCtx, blinding: int, columns: Sequence[Column], beta: int, gamma: int, *,
         out: torch.Tensor, last_z: torch.Tensor, scratch: torch.Tensor,
         omega: Optional[torch.Tensor] = None) -> GrandParams:
    """The parameters of one launch over `columns` (at most MAX_Z, with at
    most MAX_SLOTS columns in all), every tensor checked: each column's
    columns (a lookup's a, s, a', s'; a chunk's columns, each with its sigma
    column and dpows value), rand_rows (blinding, 16), init (16,); omega
    (n, 16) where a chunk is; out (len(columns), n, 16), last_z
    (len(columns), 16) (a chunk's row) and scratch
    (scratch_words(n, blinding, len(columns)),), all contiguous int32 on one
    device, 16-byte aligned."""
    nz = len(columns)
    if not 1 <= nz <= MAX_Z:
        raise ValueError(f"grand_product: 1-{MAX_Z} z columns a launch, got {nz}")
    slots = sum(len(c.cols) for c in columns)
    if slots > MAX_SLOTS:
        raise ValueError(f"grand_product: at most {MAX_SLOTS} columns' pointers a launch, got {slots}")
    for i, c in enumerate(columns):
        if c.kind not in KINDS:
            raise ValueError(f"grand_product: kind {c.kind!r}, not one of {KINDS}")
        if c.kind == "lookup" and (len(c.cols) != 4 or c.sigmas or c.dpows or c.init is not None or c.chain):
            raise ValueError("grand_product: a lookup takes four columns and no sigma, dpows, init or chain")
        if c.kind == "permutation" and not (1 <= len(c.cols) and len(c.sigmas) == len(c.cols) == len(c.dpows)
                                            and omega is not None):
            raise ValueError(f"grand_product: a permutation chunk takes columns, a sigma column and a dpows "
                             f"value each, and omega; got {len(c.cols)}, {len(c.sigmas)}, {len(c.dpows)}")
        if c.chain and not (i > 0 and columns[i - 1].kind == "permutation" and c.init is None):
            raise ValueError(f"grand_product: column {i} chains to no chunk before it")
    n = columns[0].cols[0].shape[0]
    dev = out.device
    if not 0 <= blinding < n:
        raise ValueError(f"grand_product: {blinding} blinding rows of {n}")
    checks = [(out, (nz, n, NLIMBS), "out"), (last_z, (nz, NLIMBS), "last_z"),
              (scratch, (scratch_words(n, blinding, nz),), "scratch")]
    for i, c in enumerate(columns):
        checks += [(t, (n, NLIMBS), f"column {i}.{j}") for j, t in enumerate(c.cols)]
        checks += [(t, (n, NLIMBS), f"sigma {i}.{j}") for j, t in enumerate(c.sigmas)]
        checks += [(c.rand_rows, (blinding, NLIMBS), f"rand_rows {i}")]
        checks += [(t, (NLIMBS,), f"init {i}") for t in (c.init,) if t is not None]
    checks += [(t, (n, NLIMBS), "omega") for t in (omega,) if t is not None]
    for t, shape, name in checks:
        _build.check_tensor(t, shape, name, dev, align=16)
    p = ctx.p_int
    params = GrandParams(omega=None if omega is None else omega.data_ptr(), scratch=scratch.data_ptr(), n=n,
                         nz=nz, blinding=blinding, beta=_build.mont_words(p, beta),
                         gamma=_build.mont_words(p, gamma), r3=scan_ops.r3_words(p), k=_build.field_consts(p))
    first = 0
    for i, c in enumerate(columns):
        z = params.z[i]
        z.rand = c.rand_rows.data_ptr() if blinding else None
        z.init = None if c.init is None else c.init.data_ptr()
        z.out = out[i].data_ptr()
        z.last_z = last_z[i].data_ptr() if c.kind == "permutation" else None
        z.kind, z.ncols, z.first, z.chain = KINDS.index(c.kind), len(c.cols), first, int(c.chain)
        for j, t in enumerate(c.cols):
            params.cols[first + j] = t.data_ptr()
        for j, (s, d) in enumerate(zip(c.sigmas, c.dpows)):
            params.sigmas[first + j] = s.data_ptr()
            params.dpows[first + j] = _build.mont_words(p, d)
        first += len(c.cols)
    return params


def launch_groups(columns: Sequence[Column]) -> List[List[Column]]:
    """`columns` cut, in order, into launches of at most MAX_Z columns and
    MAX_SLOTS columns' pointers; a chained chunk that starts a launch is
    left chained here, and `launch` gives it the last_z before it as its
    init."""
    groups: List[List[Column]] = []
    slots = 0
    for c in columns:
        if len(c.cols) > MAX_SLOTS:
            raise ValueError(f"grand_product: a z column of {len(c.cols)} columns, more than {MAX_SLOTS}")
        if not groups or len(groups[-1]) == MAX_Z or slots + len(c.cols) > MAX_SLOTS:
            groups.append([])
            slots = 0
        groups[-1].append(c)
        slots += len(c.cols)
    return groups


def launch(ctx: FieldCtx, blinding: int, columns: Sequence[Column], beta: int, gamma: int,
           omega: Optional[torch.Tensor] = None) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Kernel G on CUDA tensors: every column's (z (n, 16), last_z (16,)),
    the latter only meaningful for a chunk. Two device kernels and one
    memset a launch (one for up to MAX_Z columns); nothing is read back."""
    columns = [c._replace(cols=[_rows(t) for t in c.cols], sigmas=[_rows(t) for t in c.sigmas],
                          rand_rows=_rows(c.rand_rows), init=None if c.init is None else _rows(c.init).reshape(NLIMBS))
               for c in columns]
    omega = None if omega is None else _rows(omega)
    dev = columns[0].cols[0].device
    n = columns[0].cols[0].shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    zs: List[torch.Tensor] = []
    lasts: List[torch.Tensor] = []
    for group in launch_groups(columns):
        if group[0].chain:  # its chain began in the launch before
            group[0] = group[0]._replace(chain=False, init=lasts[-1])
        out = torch.empty((len(group), n, NLIMBS), dtype=torch.int32, device=dev)
        last_z = torch.empty((len(group), NLIMBS), dtype=torch.int32, device=dev)
        words = scratch_words(n, blinding, len(group))
        scratch = torch.empty(words, dtype=torch.int32, device=dev)
        params = pack(ctx, blinding, group, beta, gamma, out=out, last_z=last_z, scratch=scratch, omega=omega)
        _build.check(_lib().grand_product(ctypes.byref(params), words, stream), "grand_product")
        LAUNCHES["grand_product"] += KERNELS_PER_CALL
        zs += list(out)
        lasts += list(last_z)
    return zs, lasts


def z_columns(field: Type[FieldElement], blinding: int, beta: int, gamma: int,
              lookups: Sequence[LookupColumns] = (), circuits: Sequence[Sequence[Chunk]] = (),
              omega_pw: Optional[torch.Tensor] = None, inits: Optional[Sequence[Optional[torch.Tensor]]] = None):
    """Every z column of a proof: (the lookups' z, each circuit's chunks'
    z, each circuit's chunks' last_z), all left on the device. Each
    circuit's first chunk starts from its init ((16,), inits[i], or one
    where that is None or inits is), each later chunk from the last_z of
    the one before (permutation/prover.rs:44-160); omega_pw (n, 16) =
    omega^i where a chunk is; beta, gamma host values. A lookup's z:
    lookup_z; a chunk's: perm_z."""
    first = next((t for t in [*(lk.ci for lk in lookups), *(ch.cols[0] for chunks in circuits for ch in chunks)]),
                 None)
    if first is None:
        return [], [[] for _ in circuits], [[] for _ in circuits]
    if not _build.on_card(first, "z_columns"):
        return z_columns_plain(field, blinding, beta, gamma, lookups, circuits, omega_pw, inits)
    columns = []
    for i, chunks in enumerate(circuits):
        for j, ch in enumerate(chunks):
            columns.append(Column("permutation", ch.cols, ch.rand_rows, ch.sigmas, ch.dpows,
                                  init=inits[i] if inits is not None and j == 0 else None, chain=j > 0))
    columns += [Column("lookup", (lk.ci, lk.ct, lk.pi, lk.pt), lk.rand_rows) for lk in lookups]
    zs, lasts = launch(FieldCtx(field), blinding, columns, beta, gamma, omega_pw)
    chunk_zs, chunk_lasts, at = [], [], 0
    for chunks in circuits:
        chunk_zs.append(zs[at:at + len(chunks)])
        chunk_lasts.append(lasts[at:at + len(chunks)])
        at += len(chunks)
    return zs[at:], chunk_zs, chunk_lasts


def z_columns_plain(field: Type[FieldElement], blinding: int, beta: int, gamma: int,
                    lookups: Sequence[LookupColumns] = (), circuits: Sequence[Sequence[Chunk]] = (),
                    omega_pw: Optional[torch.Tensor] = None,
                    inits: Optional[Sequence[Optional[torch.Tensor]]] = None):
    """z_columns' plain version: lookup_z_plain for each lookup and
    perm_z_plain for each chunk, each circuit's chunks chained by last_z."""
    lookup_zs = [lookup_z_plain(field, blinding, *lk[:4], beta, gamma, lk.rand_rows) for lk in lookups]
    chunk_zs, chunk_lasts = [], []
    for i, chunks in enumerate(circuits):
        init = inits[i] if inits is not None else None
        zs, lasts = [], []
        for ch in chunks:
            z, init = perm_z_plain(field, blinding, ch.cols, ch.sigmas, omega_pw, beta, gamma, ch.dpows, init,
                                   ch.rand_rows)
            zs.append(z)
            lasts.append(init)
        chunk_zs.append(zs)
        chunk_lasts.append(lasts)
    return lookup_zs, chunk_zs, chunk_lasts


def lookup_z(field: Type[FieldElement], blinding: int, ci: torch.Tensor, ct: torch.Tensor, pi: torch.Tensor,
             pt: torch.Tensor, beta: int, gamma: int, rand_rows: torch.Tensor) -> torch.Tensor:
    """The lookup's blinded z column (lookup/prover.rs:168-330):
    z[0] = 1; z[i+1] = z[i] (a_i + beta)(s_i + gamma) /
    ((a'_i + beta)(s'_i + gamma)); rows [n - blinding, n) are rand_rows.
    ci, ct, pi, pt: the compressed input and table and their permutations,
    (n, 16) Montgomery limbs; beta, gamma host values. A z_columns call of
    one lookup."""
    return z_columns(field, blinding, beta, gamma, [LookupColumns(ci, ct, pi, pt, rand_rows)])[0][0]


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
    dpows: beta delta^(base + j) mod p, host values; init (16,) or None. A
    z_columns call of one chunk."""
    _, zs, lasts = z_columns(field, blinding, beta, gamma, circuits=[[Chunk(cols, sigmas, dpows, rand_rows)]],
                             omega_pw=omega_pw, inits=[init])
    return zs[0][0], lasts[0][0]


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
