"""Kernels G and H (ops/grand_product.py, csrc/grand_product.cu; ops/polyeval.py
horner_fold_mont, csrc/horner.cu): the grand products' z columns and the
Horner fold of the quotient's pieces.

On the CPU: `lookup_z_plain` and `perm_z_plain` equal the JAX package's
jitted bodies (`halo2_tpu/plonk/lookup_prover.py` `_lookup_z_fn`,
`permutation_prover.py` `_perm_z_fn`), computed with the JAX package's own
`field_jax` and `scan` functions called eagerly in the bodies' order, as
canonical values on Fp and FrBn at n = 5 rows: a lookup on each field, a
permutation chunk of 1, 2 and 6 columns, two chunks chained by last_z, and
a zero and a p denominator in the first rows; `z_columns_plain` (the plain
version of a proof's one call) equals them for a lookup and three chained
chunks on each field (tests/test_torch_polyeval.py holds
`horner_fold_mont_plain` to the JAX package's `horner_fold_mont`). The
eager JAX batch inversion costs seconds a call, so each JAX reference is
computed once a module run (`jax_once`) and the cases share beta, gamma
and omega. A model of kernel G's two launches in Python integers, tile by
tile, equals `z_columns_plain` with zero denominators in the first row, the
middle, row u and a blinding row at n = 2^5 + 3. The launches'
preparation (parameters, scratch, checks, the split into launches); CPU
tensors launch nothing, other devices raise. The jitted programs
themselves compile for minutes on the CPU: one `slow` test calls them. On
the card (`gpu`): each kernel equals its plain version (G as values, its
output in [0, 2p); H bit for bit), also after replays of a CUDA graph, and
G also in calls split into two launches with a chain of chunks across the
split.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_tpu.fields import Fp as JFp, FrBn as JFrBn
from halo2_tpu.ops import field_jax as fj
from halo2_tpu.ops import scan as jscan
from halo2_tpu_torch.fields import Fp, Fq, FqBn, FrBn
from halo2_tpu_torch.ops import grand_product as gp
from halo2_tpu_torch.ops import field as fo
from halo2_tpu_torch.ops import polyeval, scan
from chip_smoke import replayed, term_to

torch.set_num_threads(2)

N = 5  # rows of the JAX comparisons: one shape, so that its eager ops compile once
BLINDING = 2


def lazy_vals(p: int, n: int, rng, edge=()):
    """The `edge` values, then values uniform below 2p."""
    return (list(edge) + [int.from_bytes(rng.bytes(40), "little") % (2 * p) for _ in range(n)])[:n]


def limbs(vals, device="cpu"):
    return torch.as_tensor(fo.ints_to_limbs(vals), device=device)


def jarr(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def values(t, F):
    return fo.FieldCtx(F).decode_ints(t)


def mont_int(ctx, v):
    return v % ctx.p_int * ctx.r_int % ctx.p_int


def lookup_case(F, rng, edges: bool, n: int = N, rows=(0, 1), blinding: int = BLINDING, shared=None):
    """(ci, ct, pi, pt, beta, gamma, rand_rows): lazy columns (`shared`: the
    call's (beta, gamma, ...) instead of random ones); with `edges` a' is
    set at `rows` so that a' + beta lands on 2p (add_mod gives 0, a zero
    denominator) and on p (the denominator's product is p), in turn."""
    p, ctx = F.MODULUS, fo.FieldCtx(F)
    beta, gamma = (int(v) % p for v in rng.integers(1, 1 << 62, size=2))
    if shared is not None:
        beta, gamma = shared[:2]
    ci, ct, pi, pt = (lazy_vals(p, n, rng, [0, p, p - 1, 2 * p - 1][i:]) for i in range(4))
    if edges:
        b = mont_int(ctx, beta)
        for i, row in enumerate(rows):
            pi[row] = term_to((2 - i % 2) * p, b, p)
    rand_rows = limbs(lazy_vals(p, blinding, rng))
    return (*(limbs(c) for c in (ci, ct, pi, pt)), beta, gamma, rand_rows)


def perm_case(F, rng, ncols: int, edges: bool, n: int = N, shared=None, rows=(0, 1), blinding: int = BLINDING):
    """(cols, sigmas, omega_pw, beta, gamma, dpows, rand_rows): lazy columns
    and sigma columns, omega^i of a random omega, beta delta^j (`shared`:
    the call's (beta, gamma, omega) instead); with `edges` column 0 is set
    at `rows` so that its denominator term lands on 0 and on p, in turn."""
    p, ctx = F.MODULUS, fo.FieldCtx(F)
    beta, gamma, omega = (int(v) % p for v in rng.integers(1, 1 << 62, size=3))
    if shared is not None:
        beta, gamma, omega = shared
    cols = [lazy_vals(p, n, rng, [p - 1, 2 * p - 1] if j else []) for j in range(ncols)]
    sigmas = [lazy_vals(p, n, rng) for _ in range(ncols)]
    if edges:
        bs = fo.limbs_to_ints(fo.mont_mul_plain(limbs([sigmas[0][r] for r in rows]), ctx.const(beta, "cpu"), ctx))
        g = mont_int(ctx, gamma)
        for i, row in enumerate(rows):
            cols[0][row] = term_to(term_to((2 - i % 2) * p, g, p), bs[i], p)
    omega_pw = limbs([mont_int(ctx, pow(omega, i, p)) for i in range(n)])
    dpows = [beta * pow(F.DELTA, 3 + j, p) % p for j in range(ncols)]
    rand_rows = limbs(lazy_vals(p, blinding, rng))
    return [limbs(c) for c in cols], [limbs(s) for s in sigmas], omega_pw, beta, gamma, dpows, rand_rows


_JAX = {}


def jax_once(key, fn):
    """fn(), computed once a module run under `key`: the JAX package's eager
    batch inversion costs seconds a call, and the tests share cases."""
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


OMEGA = 0x5EED  # the shared cases' omega


def shared(F):
    """The (beta, gamma, omega) that the shared cases of F take: those of
    the lookup case of test_plain_lookup_z_matches_jax."""
    case = lookup_case(F, np.random.default_rng(1), F is Fp)
    return case[4], case[5], OMEGA


def jax_lookup_z(JF, blinding, ci, ct, pi, pt, beta, gamma, rand_rows):
    """halo2_tpu/plonk/lookup_prover.py _lookup_z_fn's body, eagerly."""
    ctx = fj.FieldCtx(JF)
    ci, ct, pi, pt, rand_rows = (jarr(t) for t in (ci, ct, pi, pt, rand_rows))
    n = ci.shape[0]
    bb = jnp.broadcast_to(ctx.const(beta), ci.shape)
    gg = jnp.broadcast_to(ctx.const(gamma), ci.shape)
    denom = fj.mont_mul(fj.add_mod(pi, bb, ctx), fj.add_mod(pt, gg, ctx), ctx)
    denom_inv = jscan.batch_invert(denom, ctx)
    product = fj.mont_mul(denom_inv, fj.mont_mul(fj.add_mod(ci, bb, ctx), fj.add_mod(ct, gg, ctx), ctx), ctx)
    z = jscan.exclusive_prefix_product(product, ctx)
    return ctx.decode_ints(jnp.concatenate([z[: n - blinding], rand_rows], axis=0))


def jax_perm_z(JF, blinding, cols, sigmas, omega_pw, beta, gamma, dpows, init, rand_rows):
    """halo2_tpu/plonk/permutation_prover.py _perm_z_fn's body, eagerly:
    (z, last_z) as JAX arrays."""
    ctx = fj.FieldCtx(JF)
    cols, sigmas = [jarr(c) for c in cols], [jarr(s) for s in sigmas]
    omega_pw, rand_rows = jarr(omega_pw), jarr(rand_rows)
    beta_c, gamma_c = ctx.const(beta), ctx.const(gamma)
    dpows = jnp.stack([ctx.const(d) for d in dpows])
    init = ctx.const(1) if init is None else init
    n = cols[0].shape[0]
    modified = None
    for j in range(len(cols)):
        term = fj.add_mod(fj.add_mod(cols[j], fj.mont_mul(sigmas[j], beta_c, ctx), ctx),
                          jnp.broadcast_to(gamma_c, cols[j].shape), ctx)
        modified = term if modified is None else fj.mont_mul(modified, term, ctx)
    modified = jscan.batch_invert(modified, ctx)
    for j in range(len(cols)):
        term = fj.add_mod(fj.add_mod(cols[j], fj.mont_mul(omega_pw, dpows[j], ctx), ctx),
                          jnp.broadcast_to(gamma_c, cols[j].shape), ctx)
        modified = fj.mont_mul(modified, term, ctx)
    z = jscan.exclusive_prefix_product(modified, ctx, init=init)
    return jnp.concatenate([z[: n - blinding], rand_rows], axis=0), z[n - (blinding + 1)]


@pytest.mark.parametrize("F,JF,edges", [(Fp, JFp, True), (FrBn, JFrBn, False)], ids=["Fp-edges", "FrBn"])
def test_plain_lookup_z_matches_jax(F, JF, edges):
    case = lookup_case(F, np.random.default_rng(1), edges)
    got = values(gp.lookup_z_plain(F, BLINDING, *case), F)
    assert got == jax_once(("lookup", F), lambda: jax_lookup_z(JF, BLINDING, *case))
    assert got[0] == 1
    if edges:  # a zero (and a p) denominator: its fraction is 0, and so is every z after it
        assert got[1:N - BLINDING] == [0] * (N - BLINDING - 1)


# the chained chunks of each field: (columns, edges) of each, and its rng seed
CHAINS = {Fp: (2, ((6, False), (1, True), (2, True))), FrBn: (3, ((2, False), (3, True), (1, True)))}


def chain_cases(F):
    seed, chunks = CHAINS[F]
    rng = np.random.default_rng(seed)
    return [perm_case(F, rng, ncols, edges, shared=shared(F)) for ncols, edges in chunks]


def jax_chain(F, JF, cases, upto: int):
    """The JAX references (z, last_z) of the first `upto` chunks of F's
    chain, each from the last_z of the one before."""
    out, jinit = [], None
    for i, case in enumerate(cases[:upto]):
        jz, jinit = jax_once(("perm", F, i), lambda case=case, jinit=jinit: jax_perm_z(
            JF, BLINDING, *case[:6], jinit, case[6]))
        out.append((jz, jinit))
    return out


def test_plain_perm_z_matches_jax_chained_chunks():
    """Two chunks on Fp, 6 columns then 1 with zero and p denominators in
    its first rows, the second from the first's last_z."""
    cases = chain_cases(Fp)[:2]
    jctx = fj.FieldCtx(JFp)
    init = None
    for case, (jz, jlast), edges in zip(cases, jax_chain(Fp, JFp, cases, 2), (False, True)):
        z, last_z = gp.perm_z_plain(Fp, BLINDING, *case[:6], init, case[6])
        assert values(z, Fp) == jctx.decode_ints(jz)
        assert values(last_z[None], Fp) == jctx.decode_ints(jlast[None])
        assert values(last_z[None], Fp) == [values(z, Fp)[N - BLINDING - 1]]
        if edges:
            assert values(z, Fp)[1:N - BLINDING] == [0] * (N - BLINDING - 1)
        else:
            assert values(last_z[None], Fp) != [0]
        init = last_z


def test_plain_perm_z_matches_jax_frbn():
    case = chain_cases(FrBn)[0]
    z, last_z = gp.perm_z_plain(FrBn, BLINDING, *case[:6], None, case[6])
    ((jz, jlast),) = jax_chain(FrBn, JFrBn, [case], 1)
    jctx = fj.FieldCtx(JFrBn)
    assert values(z, FrBn) == jctx.decode_ints(jz)
    assert values(last_z[None], FrBn) == jctx.decode_ints(jlast[None])


def call_of(lookups, chunks):
    """A z_columns call's lookups and circuits from test cases."""
    return ([gp.LookupColumns(*lk[:4], lk[6]) for lk in lookups],
            [[gp.Chunk(c[0], c[1], c[5], c[6]) for c in circuit] for circuit in chunks])


@pytest.mark.parametrize("F,JF", [(Fp, JFp), (FrBn, JFrBn)], ids=["Fp-edges", "FrBn"])
def test_plain_z_columns_match_jax(F, JF):
    """One call of a lookup and three chunks chained by last_z (zero and p
    denominators in the lookup on Fp and in the later chunks on both
    fields): z_columns_plain against the JAX bodies, as canonical values."""
    lk = lookup_case(F, np.random.default_rng(1), F is Fp)
    cases = chain_cases(F)
    beta, gamma, _ = shared(F)
    lookups, circuits = call_of([lk], [cases])
    lzs, czs, lasts = gp.z_columns_plain(F, BLINDING, beta, gamma, lookups, circuits, omega_pw=cases[0][2])
    jctx = fj.FieldCtx(JF)
    assert [values(z, F) for z in lzs] == [jax_once(("lookup", F), lambda: jax_lookup_z(JF, BLINDING, *lk))]
    want = jax_chain(F, JF, cases, 3)
    assert [values(z, F) for z in czs[0]] == [jctx.decode_ints(jz) for jz, _ in want]
    assert [values(t[None], F) for t in lasts[0]] == [jctx.decode_ints(jl[None]) for _, jl in want]
    assert values(czs[0][2], F)[1:N - BLINDING] == [0] * (N - BLINDING - 1)  # after a zero


@pytest.mark.slow  # the jitted programs compile for minutes on the CPU
def test_plain_versions_match_the_jitted_programs():
    from halo2_tpu.plonk.lookup_prover import _lookup_z_fn
    from halo2_tpu.plonk.permutation_prover import _perm_z_fn

    rng = np.random.default_rng(4)
    case = lookup_case(Fp, rng, True)
    jctx = fj.FieldCtx(JFp)
    ci, ct, pi, pt, beta, gamma, rand_rows = case
    want = _lookup_z_fn(JFp, BLINDING)(jarr(ci), jarr(ct), jarr(pi), jarr(pt), jctx.const(beta),
                                       jctx.const(gamma), jarr(rand_rows))
    assert values(gp.lookup_z_plain(Fp, BLINDING, *case), Fp) == jctx.decode_ints(want)
    cols, sigmas, omega_pw, beta, gamma, dpows, rand_rows = perm_case(Fp, rng, 2, True)
    z, last_z = _perm_z_fn(JFp, 2, BLINDING)(
        jnp.stack([jarr(c) for c in cols]), jnp.stack([jarr(s) for s in sigmas]), jarr(omega_pw),
        jctx.const(beta), jctx.const(gamma), jnp.stack([jctx.const(d) for d in dpows]), jctx.const(1),
        jarr(rand_rows))
    got, got_last = gp.perm_z_plain(Fp, BLINDING, cols, sigmas, omega_pw, beta, gamma, dpows, None, rand_rows)
    assert values(got, Fp) == jctx.decode_ints(z)
    assert values(got_last[None], Fp) == jctx.decode_ints(last_z[None])


def model_z_columns(F, blinding, beta, gamma, lookups, circuits, omega_pw, inits, tile):
    """Kernel G's two launches (csrc/grand_product.cu) in Python integers,
    on canonical values, over tiles of `tile` rows: each column's (num',
    den') pairs and their exclusive prefixes over its U = n - blinding - 1
    rows, tile by tile from descriptor 0 = (1, 1); the totals' inverses (the
    kernel's binary GCD, scan.inverse_model), each circuit's chunk inits
    init_{c+1} = init_c P(<U) Q(<U)^-1; then den' from row U - 1 back,
    inclusive, tile by tile from descriptor 0 = init Q(<U)^-1, a row's
    z = carry x its tile's suffix x P(<i); row U = init P(<U) Q(<U)^-1
    (last_z), the random rows after it. Returns z_columns' three lists."""
    p, ctx = F.MODULUS, fo.FieldCtx(F)
    r = ctx.r_int
    n = (lookups[0].ci if lookups else circuits[0][0].cols[0]).shape[0]
    rows = n - blinding - 1
    tiles = -(-rows // tile)
    columns = []  # (num, den, init or None, chained, rand_rows)
    om = values(omega_pw, F) if omega_pw is not None else None
    for i, chunks in enumerate(circuits):
        for j, ch in enumerate(chunks):
            vs, ss = [values(t, F) for t in ch.cols], [values(t, F) for t in ch.sigmas]
            num, den = [1] * n, [1] * n
            for v, s, d in zip(vs, ss, ch.dpows):
                num = [a * (x + d * w + gamma) % p for a, x, w in zip(num, v, om)]
                den = [a * (x + beta * y + gamma) % p for a, x, y in zip(den, v, s)]
            init = values(inits[i][None], F)[0] if inits is not None and inits[i] is not None and j == 0 else 1
            columns.append((num, den, init, j > 0, ch.rand_rows))
    for lk in lookups:
        a, s_, a2, s2 = (values(t, F) for t in lk[:4])
        num = [(x + beta) * (y + gamma) % p for x, y in zip(a, s_)]
        den = [(x + beta) * (y + gamma) % p for x, y in zip(a2, s2)]
        columns.append((num, den, 1, False, lk.rand_rows))
    forward = []
    for num, den, *_ in columns:  # the forward launch
        nump = [0 if d == 0 else x for x, d in zip(num, den)]
        denp = [1 if d == 0 else d for d in den]
        pre, desc = [None] * rows, (1, 1)
        for t in range(tiles):
            a = (1, 1)
            for i in range(t * tile, min((t + 1) * tile, rows)):
                pre[i] = desc[0] * a[0] % p
                a = (a[0] * nump[i] % p, a[1] * denp[i] % p)
            desc = (desc[0] * a[0] % p, desc[1] * a[1] % p)
        forward.append((pre, denp, desc))
    inv = [scan.inverse_model(q * r % p, p)[0] * r % p for _, _, (_, q) in forward]
    step = [tot * v % p for (_, _, (tot, _)), v in zip(forward, inv)]
    init = []
    for c, (_, _, first, chained, _) in enumerate(columns):  # each chain's inits
        init.append(init[-1] * step[c - 1] % p if chained else first)
    zs, lasts = [], []
    for c, ((pre, denp, _), (*_, rand_rows)) in enumerate(zip(forward, columns)):  # the backward launch
        z, carry = [None] * n, init[c] * inv[c] % p
        for t in range(tiles):
            a = 1
            for pos in range(t * tile, (t + 1) * tile):
                i = tiles * tile - 1 - pos
                if i < rows:
                    a = a * denp[i] % p
                    z[i] = carry * a % p * pre[i] % p
            carry = carry * a % p
        z[rows] = init[c] * step[c] % p
        z[rows + 1:] = values(rand_rows, F)
        zs.append(z)
        lasts.append(z[rows])
    chunk_zs, chunk_lasts, at = [], [], 0
    for chunks in circuits:
        chunk_zs.append(zs[at:at + len(chunks)])
        chunk_lasts.append(lasts[at:at + len(chunks)])
        at += len(chunks)
    return zs[at:], chunk_zs, chunk_lasts


@pytest.mark.parametrize("tile", [4, 5, 64])
@pytest.mark.parametrize("F", [Fp, FrBn], ids=["Fp", "FrBn"])
def test_two_launch_model_equals_plain(F, tile):
    """At n = 2^5 + 3 with 3 blinding rows (U = 31 rows scanned): two
    circuits (three chained chunks from one, two from an init), two
    lookups, zero (and p) denominators in row 0, the middle, row U and the
    last blinding row of each column; tiles of 4 and 5 rows, and of 64
    (one tile)."""
    n, blinding = 35, 3
    u = n - blinding - 1
    rows = (0, n // 2, u, n - 1)
    rng = np.random.default_rng(8)
    lks = [lookup_case(F, rng, True, n, rows, blinding)]
    call = (lks[0][4], lks[0][5], 7)
    beta, gamma, _ = call
    lks.append(lookup_case(F, rng, True, n, rows[1:], blinding, call))
    chunks = [[perm_case(F, rng, c, True, n, call, rows, blinding) for c in (3, 1, 2)],
              [perm_case(F, rng, 2, True, n, call, (u, n - 1), blinding),
               perm_case(F, rng, 4, True, n, call, rows, blinding)]]
    lookups, circuits = call_of(lks, chunks)
    omega_pw, inits = chunks[0][0][2], [None, limbs([5])[0]]
    got = model_z_columns(F, blinding, beta, gamma, lookups, circuits, omega_pw, inits, tile)
    lzs, czs, lasts = gp.z_columns_plain(F, blinding, beta, gamma, lookups, circuits, omega_pw, inits)
    assert got[0] == [values(z, F) for z in lzs]
    assert got[1] == [[values(z, F) for z in zs] for zs in czs]
    assert got[2] == [[values(t[None], F)[0] for t in ts] for ts in lasts]
    assert got[0][0][1:u + 1] == [0] * u  # a zero in row 0: every z after it
    assert got[0][1][n // 2 + 1:u + 1] == [0] * (u - n // 2)  # in the middle
    assert 0 not in got[1][1][0][:u + 1]  # a zero in row U or a blinding row leaves z alone


def test_scratch_and_params():
    n, blinding, ctx = 300, BLINDING, fo.FieldCtx(Fp)
    rows = n - blinding - 1
    tiles = scan.scan_tiles(rows)
    flags = -(-(1 + 3 * (tiles + 1)) // 4) * 4
    assert gp.scratch_words(n, blinding, 3) == 2 * flags + 3 * (tiles + 1) * 2 * (16 + 8) + 3 * rows * 8
    assert gp.scratch_words(3, 2, 1) == 2 * 4 + 2 * (16 + 8)  # no row scanned: descriptor 0 alone
    # the C struct's layout: pointers, then ints, then the 8-word values
    P = 8
    assert ctypes.sizeof(gp.ZColumn) == 4 * P + 4 * 4
    assert gp.GrandParams.z.offset == 2 * gp.MAX_SLOTS * P + 2 * P
    assert gp.GrandParams.n.offset == gp.GrandParams.z.offset + gp.MAX_Z * ctypes.sizeof(gp.ZColumn)
    assert gp.GrandParams.dpows.offset == gp.GrandParams.n.offset + 2 * 8 + 2 * 4 + 2 * 32
    assert gp.GrandParams.k.offset == gp.GrandParams.dpows.offset + gp.MAX_SLOTS * 32 + 32
    assert ctypes.sizeof(gp.GrandParams) <= 4096 and ctypes.sizeof(polyeval.HornerParams) <= 4096
    rng = np.random.default_rng(5)
    beta, gamma = 11, 13
    chunks = [perm_case(Fp, rng, c, False, n, (beta, gamma, 3)) for c in (3, 2)]
    lk = lookup_case(Fp, rng, False, n)
    columns = [gp.Column("permutation", c[0], c[6], c[1], c[5], init=init, chain=j == 1)
               for j, (c, init) in enumerate(zip(chunks, (limbs([7])[0], None)))]
    columns.append(gp.Column("lookup", lk[:4], lk[6]))
    omega_pw = chunks[0][2]
    out = torch.empty((3, n, 16), dtype=torch.int32)
    last_z = torch.empty((3, 16), dtype=torch.int32)
    scratch = torch.empty(gp.scratch_words(n, blinding, 3), dtype=torch.int32)
    params = gp.pack(ctx, blinding, columns, beta, gamma, out=out, last_z=last_z, scratch=scratch, omega=omega_pw)
    assert [params.cols[j] for j in range(9)] == [t.data_ptr() for t in [*chunks[0][0], *chunks[1][0], *lk[:4]]]
    assert [params.sigmas[j] for j in range(5)] == [t.data_ptr() for t in [*chunks[0][1], *chunks[1][1]]]
    assert params.cols[9] is None and params.sigmas[5] is None
    assert (params.omega, params.scratch, params.n, params.nz, params.blinding) == (
        omega_pw.data_ptr(), scratch.data_ptr(), n, 3, blinding)
    z = [params.z[i] for i in range(3)]
    assert [(c.kind, c.ncols, c.first, c.chain) for c in z] == [(1, 3, 0, 0), (1, 2, 3, 1), (0, 4, 5, 0)]
    assert [c.out for c in z] == [out[i].data_ptr() for i in range(3)]
    assert [c.last_z for c in z] == [last_z[0].data_ptr(), last_z[1].data_ptr(), None]
    assert [c.rand for c in z] == [chunks[0][6].data_ptr(), chunks[1][6].data_ptr(), lk[6].data_ptr()]
    assert (z[0].init, z[1].init, z[2].init) == (columns[0].init.data_ptr(), None, None)
    assert params.z[3].out is None

    def word_int(w):
        return sum(int(v) << (32 * i) for i, v in enumerate(w))

    assert word_int(params.beta) == mont_int(ctx, beta) and word_int(params.gamma) == mont_int(ctx, gamma)
    dpows = [*chunks[0][5], *chunks[1][5]]
    assert [word_int(params.dpows[j]) for j in range(5)] == [mont_int(ctx, d) for d in dpows]
    assert word_int(params.r3) == pow(1 << 256, 3, ctx.p_int)
    assert word_int(params.k.p) == ctx.p_int
    lone = gp.pack(ctx, 0, [columns[2]._replace(rand_rows=lk[6][:0])], beta, gamma, out=out[:1], last_z=last_z[:1],
                   scratch=torch.empty(gp.scratch_words(n, 0, 1), dtype=torch.int32))
    assert (lone.z[0].rand, lone.z[0].init, lone.omega, lone.nz) == (None, None, None, 1)

    def bad(match, columns=columns, blinding=blinding, **change):
        args = dict(out=out, last_z=last_z, scratch=scratch, omega=omega_pw)
        args.update(change)
        with pytest.raises(ValueError, match=match):
            gp.pack(ctx, blinding, columns, beta, gamma, **args)

    lookup = columns[2]
    bad("1-16 z columns", columns=[])
    bad("1-16 z columns", columns=[lookup] * 17)
    bad("at most 48 columns", columns=[columns[0]._replace(cols=chunks[0][0] * 17)])
    bad("kind", columns=[lookup._replace(kind="sum")])
    bad("four columns", columns=[lookup._replace(cols=lk[:3])])
    bad("four columns", columns=[lookup._replace(chain=True)])
    bad("a sigma column", columns=[columns[0]._replace(sigmas=chunks[0][1][:2])])
    bad("a sigma column", columns=[columns[0]._replace(cols=[], sigmas=[], dpows=[])])
    bad("a sigma column", omega=None)
    bad("chains to no chunk", columns=[lookup, columns[1]])
    bad("chains to no chunk", columns=columns[1:])
    bad("blinding", blinding=n)
    bad("expected contiguous int32", out=out[:2])
    bad("expected contiguous int32", last_z=last_z[:, :8])
    bad("expected contiguous int32", scratch=scratch[1:])
    bad("expected contiguous int32", columns=[columns[0]._replace(rand_rows=chunks[0][6][:1])])
    bad("expected contiguous int32", columns=[columns[0]._replace(cols=[chunks[0][0][0].to(torch.int64),
                                                                        *chunks[0][0][1:]])])
    bad("expected contiguous int32", columns=[columns[0]._replace(cols=[chunks[0][0][0][:-1], *chunks[0][0][1:]])])
    bad("aligned", omega=torch.empty(n * 16 + 1, dtype=torch.int32)[1:].view(n, 16))

    pieces = [limbs(lazy_vals(Fp.MODULUS, n, rng)) for _ in range(4)]
    hp = polyeval.horner_params(pieces, out[0], 5, ctx)
    assert [hp.pieces[i] for i in range(4)] == [t.data_ptr() for t in pieces] and hp.pieces[4] is None
    assert (hp.out, hp.n, hp.m) == (out[0].data_ptr(), n, 4) and word_int(hp.x) == mont_int(ctx, 5)
    with pytest.raises(ValueError, match="takes 2-64"):
        polyeval.horner_params(pieces[:1], out[0], 5, ctx)
    with pytest.raises(ValueError, match="takes 2-64"):
        polyeval.horner_params(pieces * 17, out[0], 5, ctx)
    with pytest.raises(ValueError, match="piece 1"):
        polyeval.horner_params([pieces[0], pieces[1][:-1]], out[0], 5, ctx)


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(6)
    before = (dict(gp.LAUNCHES), dict(polyeval.LAUNCHES))
    case = lookup_case(Fq, rng, True, 20)
    assert torch.equal(gp.lookup_z(Fq, BLINDING, *case), gp.lookup_z_plain(Fq, BLINDING, *case))
    cols, sigmas, omega_pw, beta, gamma, dpows, rand_rows = perm_case(Fq, rng, 2, False, 20)
    init = limbs([9])[0]
    got = gp.perm_z(Fq, BLINDING, cols, sigmas, omega_pw, beta, gamma, dpows, init, rand_rows)
    want = gp.perm_z_plain(Fq, BLINDING, cols, sigmas, omega_pw, beta, gamma, dpows, init, rand_rows)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(polyeval.horner_fold_mont(Fq, cols, 3), polyeval.horner_fold_mont_plain(Fq, cols, 3))
    lookups, circuits = call_of([case], [[(cols, sigmas, omega_pw, beta, gamma, dpows, rand_rows)] * 2])
    got = gp.z_columns(Fq, BLINDING, beta, gamma, lookups, circuits, omega_pw, [init])
    want = gp.z_columns_plain(Fq, BLINDING, beta, gamma, lookups, circuits, omega_pw, [init])
    assert all(torch.equal(a, b) for a, b in zip(got[0] + got[1][0] + got[2][0], want[0] + want[1][0] + want[2][0]))
    assert gp.z_columns(Fq, BLINDING, beta, gamma, circuits=[[], []]) == ([], [[], []], [[], []])
    assert (gp.LAUNCHES, polyeval.LAUNCHES) == before
    meta = [t.to("meta") for t in case[:4]]
    with pytest.raises(ValueError, match="unsupported device"):
        gp.lookup_z(Fq, BLINDING, *meta, beta, gamma, case[6].to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        gp.perm_z(Fq, BLINDING, meta[:2], meta[2:], omega_pw.to("meta"), beta, gamma, dpows, None, rand_rows)
    with pytest.raises(ValueError, match="unsupported device"):
        gp.z_columns(Fq, BLINDING, beta, gamma, call_of([[*meta, None, None, case[6]]], [])[0])
    with pytest.raises(ValueError, match="unsupported device"):
        polyeval.horner_fold_mont(Fq, meta, 3)


def test_launch_groups():
    """Up to MAX_Z columns and MAX_SLOTS columns' pointers a launch, in
    order."""
    t = torch.zeros(1)

    def chunk(ncols, chain=False):
        return gp.Column("permutation", [t] * ncols, t, [t] * ncols, [1] * ncols, chain=chain)

    lookup = gp.Column("lookup", [t] * 4, t)
    assert gp.launch_groups([lookup]) == [[lookup]]
    cols = [chunk(2), chunk(2, True), lookup, lookup]
    assert gp.launch_groups(cols) == [cols]
    assert [len(g) for g in gp.launch_groups([chunk(1)] * 20)] == [16, 4]
    assert [len(g) for g in gp.launch_groups([lookup] * 13)] == [12, 1]
    wide = [chunk(20), chunk(20, True), chunk(8, True), chunk(1, True), lookup]
    assert [[len(c.cols) for c in g] for g in gp.launch_groups(wide)] == [[20, 20, 8], [1, 4]]
    with pytest.raises(ValueError, match="more than 48"):
        gp.launch_groups([chunk(49)])


@pytest.mark.gpu
def test_kernels_equal_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    T, dev = scan.TILE_ROWS, torch.device("cuda")
    rng = np.random.default_rng(7)

    def flat(out):  # z_columns' outputs: the lookups' z, then each circuit's z, then each circuit's last_z
        return [*out[0], *(z for zs in out[1] for z in zs), *(t for ts in out[2] for t in ts)]

    def card(t):  # a tensor, a list of tensors, or a host value
        if isinstance(t, torch.Tensor):
            return t.to(dev)
        return [c.to(dev) if isinstance(c, torch.Tensor) else c for c in t] if isinstance(t, list) else t

    assert gp._lib().grand_params_size() == ctypes.sizeof(gp.GrandParams)
    for F in (Fp, Fq, FrBn, FqBn):
        p = F.MODULUS
        for n in (5, 1000, T + 2, T + 3, T + 4, (1 << 12) + 5, 33 * T + 5):
            u = n - BLINDING - 1
            rows = (0, n // 2, u, n - 1)
            case = [card(t) for t in lookup_case(F, rng, n % 2 == 1, n, rows)]
            beta, gamma = case[4], case[5]
            before = gp.LAUNCHES["grand_product"]
            got = gp.lookup_z(F, BLINDING, *case)
            torch.cuda.synchronize()
            assert gp.LAUNCHES["grand_product"] == before + gp.KERNELS_PER_CALL
            want = values(gp.lookup_z_plain(F, BLINDING, *case), F)
            assert values(got, F) == want, (F.__name__, n, "lookup")
            assert max(fo.limbs_to_ints(got)) < 2 * p
            # a proof's call: six chained chunks of 1-6 columns and two lookups
            chunks = [[card(t) for t in perm_case(F, rng, c, c % 2 == 0, n, (beta, gamma, 5), rows)]
                      for c in range(1, 7)]
            lookups, circuits = call_of([case, case], [chunks])
            init = card(limbs([9])[0])
            before = gp.LAUNCHES["grand_product"]
            got = gp.z_columns(F, BLINDING, beta, gamma, lookups, circuits, chunks[0][2], [init])
            torch.cuda.synchronize()
            assert gp.LAUNCHES["grand_product"] == before + gp.KERNELS_PER_CALL
            want = gp.z_columns_plain(F, BLINDING, beta, gamma, lookups, circuits, chunks[0][2], [init])
            for a, b in zip(got[0] + got[1][0] + got[2][0], want[0] + want[1][0] + want[2][0]):
                assert values(a.reshape(-1, 16), F) == values(b.reshape(-1, 16), F), (F.__name__, n)
                assert max(fo.limbs_to_ints(a.reshape(-1, 16))) < 2 * p
            if n == T + 3:  # calls of two launches each, a chain of chunks going on across the split
                wide = [[[card(t) for t in perm_case(F, rng, c, i == 2 and c in (3, 4), n, (beta, gamma, 5),
                                                     (u, n - 1))]
                         for c in range(1, 7)] for i in range(3)]  # 63 columns' pointers
                narrow = [[[card(t) for t in perm_case(F, rng, 1, False, n, (beta, gamma, 5))]
                           for _ in range(gp.MAX_Z + 1)]]
                for cases in (wide, narrow):
                    lookups, circuits = call_of([case, case], cases)
                    inits = [init] + [None] * (len(circuits) - 1)
                    before = gp.LAUNCHES["grand_product"]
                    got = gp.z_columns(F, BLINDING, beta, gamma, lookups, circuits, cases[0][0][2], inits)
                    torch.cuda.synchronize()
                    assert gp.LAUNCHES["grand_product"] == before + 2 * gp.KERNELS_PER_CALL
                    want = gp.z_columns_plain(F, BLINDING, beta, gamma, lookups, circuits, cases[0][0][2], inits)
                    for a, b in zip(flat(got), flat(want), strict=True):
                        assert values(a.reshape(-1, 16), F) == values(b.reshape(-1, 16), F), (F.__name__, n, "split")
            if n in (T + 3, 33 * T + 5):
                for out in replayed(lambda: gp.lookup_z(F, BLINDING, *case)):
                    assert values(out, F) == values(want[0][0], F), (F.__name__, n, "lookup replay")
            x = int(rng.integers(1, 1 << 62)) % p
            for M in (2, 3, 7):
                pieces = limbs(lazy_vals(p, M * n, rng, [0, p, p - 1, 2 * p - 1])).reshape(M, n, 16).to(dev)
                before = polyeval.LAUNCHES["horner"]
                got = polyeval.horner_fold_mont(F, list(pieces), x)
                assert polyeval.LAUNCHES["horner"] == before + 1
                want_h = polyeval.horner_fold_mont_plain(F, list(pieces), x)
                assert torch.equal(got, want_h), (F.__name__, n, M, "horner")
                if n == T + 3:
                    for out in replayed(lambda: polyeval.horner_fold_mont(F, pieces, x)):
                        assert torch.equal(out, want_h), (F.__name__, n, M, "horner replay")
