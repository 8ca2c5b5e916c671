"""Kernels G and H (ops/grand_product.py, csrc/grand_product.cu; ops/polyeval.py
horner_fold_mont, csrc/horner.cu): the grand products' z columns and the
Horner fold of the quotient's pieces.

On the CPU: `lookup_z_plain` and `perm_z_plain` equal the JAX package's
jitted bodies (`halo2_tpu/plonk/lookup_prover.py` `_lookup_z_fn`,
`permutation_prover.py` `_perm_z_fn`), computed with the JAX package's own
`field_jax` and `scan` functions called eagerly in the bodies' order, as
canonical values on Fp and FrBn at n = 5 rows: a lookup on each field, a
permutation chunk of 1, 2 and 6 columns, two chunks chained by last_z, and
a zero and a p denominator in the first rows (tests/test_torch_polyeval.py
holds `horner_fold_mont_plain` to the JAX package's `horner_fold_mont`); the
launches' preparation (parameters, scratch, checks); CPU tensors launch
nothing, other devices raise. The jitted programs themselves compile for
minutes on the CPU: one `slow` test calls them. On the card (`gpu`): each
kernel equals its plain version (G as values, its output in [0, 2p); H bit
for bit), also after replays of a CUDA graph.
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


def lookup_case(F, rng, edges: bool, n: int = N):
    """(ci, ct, pi, pt, beta, gamma, rand_rows): lazy columns; with `edges`
    rows 0 and 1 of a' are set so that a' + beta lands on 2p (add_mod gives
    0, a zero denominator) and on p (the denominator's product is p)."""
    p, ctx = F.MODULUS, fo.FieldCtx(F)
    beta, gamma = (int(v) % p for v in rng.integers(1, 1 << 62, size=2))
    ci, ct, pi, pt = (lazy_vals(p, n, rng, [0, p, p - 1, 2 * p - 1][i:]) for i in range(4))
    if edges:
        b = mont_int(ctx, beta)
        pi[0], pi[1] = term_to(2 * p, b, p), term_to(p, b, p)
    rand_rows = limbs(lazy_vals(p, BLINDING, rng))
    return (*(limbs(c) for c in (ci, ct, pi, pt)), beta, gamma, rand_rows)


def perm_case(F, rng, ncols: int, edges: bool, n: int = N):
    """(cols, sigmas, omega_pw, beta, gamma, dpows, rand_rows): lazy columns
    and sigma columns, omega^i of a random omega, beta delta^j; with `edges`
    column 0's rows 0 and 1 are set so that its denominator term lands on
    0 and on p."""
    p, ctx = F.MODULUS, fo.FieldCtx(F)
    beta, gamma, omega = (int(v) % p for v in rng.integers(1, 1 << 62, size=3))
    cols = [lazy_vals(p, n, rng, [p - 1, 2 * p - 1] if j else []) for j in range(ncols)]
    sigmas = [lazy_vals(p, n, rng) for _ in range(ncols)]
    if edges:
        bs = fo.limbs_to_ints(fo.mont_mul_plain(limbs(sigmas[0][:2]), ctx.const(beta, "cpu"), ctx))
        g = mont_int(ctx, gamma)
        for row, target in ((0, 2 * p), (1, p)):
            cols[0][row] = term_to(term_to(target, g, p), bs[row], p)
    omega_pw = limbs([mont_int(ctx, pow(omega, i, p)) for i in range(n)])
    dpows = [beta * pow(F.DELTA, 3 + j, p) % p for j in range(ncols)]
    rand_rows = limbs(lazy_vals(p, BLINDING, rng))
    return [limbs(c) for c in cols], [limbs(s) for s in sigmas], omega_pw, beta, gamma, dpows, rand_rows


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
    assert got == jax_lookup_z(JF, BLINDING, *case)
    assert got[0] == 1
    if edges:  # a zero (and a p) denominator: its fraction is 0, and so is every z after it
        assert got[1:N - BLINDING] == [0] * (N - BLINDING - 1)


def test_plain_perm_z_matches_jax_chained_chunks():
    """Two chunks on Fp, 6 columns then 1 with zero and p denominators in
    its first rows, the second from the first's last_z."""
    rng = np.random.default_rng(2)
    jctx = fj.FieldCtx(JFp)
    init, jinit = None, None
    for ncols, edges in ((6, False), (1, True)):
        case = perm_case(Fp, rng, ncols, edges)
        z, last_z = gp.perm_z_plain(Fp, BLINDING, *case[:6], init, case[6])
        jz, jlast = jax_perm_z(JFp, BLINDING, *case[:6], jinit, case[6])
        assert values(z, Fp) == jctx.decode_ints(jz)
        assert values(last_z[None], Fp) == jctx.decode_ints(jlast[None])
        assert values(last_z[None], Fp) == [values(z, Fp)[N - BLINDING - 1]]
        if edges:
            assert values(z, Fp)[1:N - BLINDING] == [0] * (N - BLINDING - 1)
        else:
            assert values(last_z[None], Fp) != [0]
        init, jinit = last_z, jlast


def test_plain_perm_z_matches_jax_frbn():
    case = perm_case(FrBn, np.random.default_rng(3), 2, False)
    z, last_z = gp.perm_z_plain(FrBn, BLINDING, *case[:6], None, case[6])
    jz, jlast = jax_perm_z(JFrBn, BLINDING, *case[:6], None, case[6])
    jctx = fj.FieldCtx(JFrBn)
    assert values(z, FrBn) == jctx.decode_ints(jz)
    assert values(last_z[None], FrBn) == jctx.decode_ints(jlast[None])


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


def test_scratch_and_params():
    n, ctx = 300, fo.FieldCtx(Fp)
    assert gp.scratch_words(n) == scan.scratch_words(n, 3) + 16 * n
    assert ctypes.sizeof(gp.GrandParams) <= 4096 and ctypes.sizeof(polyeval.HornerParams) <= 4096
    rng = np.random.default_rng(5)
    cols, sigmas, omega_pw, beta, gamma, dpows, rand_rows = perm_case(Fp, rng, 3, False, n)
    out = torch.empty((n, 16), dtype=torch.int32)
    scratch = torch.empty(gp.scratch_words(n), dtype=torch.int32)
    init, last_z = limbs([7])[0], torch.empty(16, dtype=torch.int32)
    params = gp.pack("permutation", ctx, BLINDING, cols, beta, gamma, out=out, scratch=scratch,
                     rand_rows=rand_rows, sigmas=sigmas, omega=omega_pw, dpows=dpows, init=init, last_z=last_z)
    assert [params.cols[j] for j in range(3)] == [c.data_ptr() for c in cols]
    assert [params.sigmas[j] for j in range(3)] == [s.data_ptr() for s in sigmas]
    assert params.cols[3] is None and params.sigmas[3] is None
    assert (params.omega, params.rand, params.init, params.out, params.last_z, params.scratch) == (
        omega_pw.data_ptr(), rand_rows.data_ptr(), init.data_ptr(), out.data_ptr(), last_z.data_ptr(),
        scratch.data_ptr())
    assert params.den == scratch.data_ptr() + 4 * scan.scratch_words(n, 3)
    assert (params.n, params.kind, params.ncols, params.blinding) == (n, 1, 3, BLINDING)

    def word_int(w):
        return sum(int(v) << (32 * i) for i, v in enumerate(w))

    assert word_int(params.beta) == mont_int(ctx, beta) and word_int(params.gamma) == mont_int(ctx, gamma)
    assert [word_int(params.dpows[j]) for j in range(3)] == [mont_int(ctx, d) for d in dpows]
    assert word_int(params.r3) == pow(1 << 256, 3, ctx.p_int)
    assert word_int(params.k.p) == ctx.p_int
    lk = gp.pack("lookup", ctx, 0, cols[:1] * 4, beta, gamma, out=out, scratch=scratch,
                 rand_rows=rand_rows[:0])
    assert (lk.kind, lk.ncols, lk.rand, lk.init, lk.omega) == (0, 4, None, None, None)

    def bad(match, **change):
        args = dict(kind="permutation", cols=cols, sigmas=sigmas, omega=omega_pw, dpows=dpows, out=out,
                    scratch=scratch, rand_rows=rand_rows, blinding=BLINDING)
        args.update(change)
        kind, cls, blinding = args.pop("kind"), args.pop("cols"), args.pop("blinding")
        with pytest.raises(ValueError, match=match):
            gp.pack(kind, ctx, blinding, cls, beta, gamma, **args)

    bad("kind", kind="sum")
    bad("four columns", kind="lookup")
    bad("1-32 columns", sigmas=sigmas[:2])
    bad("1-32 columns", cols=cols * 11, sigmas=sigmas * 11, dpows=dpows * 11)
    bad("1-32 columns", omega=None)
    bad("blinding", blinding=n)
    bad("expected contiguous int32", rand_rows=rand_rows[:1])
    bad("expected contiguous int32", scratch=scratch[1:])
    bad("expected contiguous int32", cols=[cols[0].to(torch.int64), *cols[1:]])
    bad("expected contiguous int32", cols=[cols[0][:-1], *cols[1:]])
    bad("expected contiguous int32", sigmas=[sigmas[0].t().contiguous().t(), *sigmas[1:]])
    bad("aligned", omega=torch.empty(n * 16 + 1, dtype=torch.int32)[1:].view(n, 16))

    pieces = [limbs(lazy_vals(Fp.MODULUS, n, rng)) for _ in range(4)]
    hp = polyeval.horner_params(pieces, out, 5, ctx)
    assert [hp.pieces[i] for i in range(4)] == [t.data_ptr() for t in pieces] and hp.pieces[4] is None
    assert (hp.out, hp.n, hp.m) == (out.data_ptr(), n, 4) and word_int(hp.x) == mont_int(ctx, 5)
    with pytest.raises(ValueError, match="takes 2-64"):
        polyeval.horner_params(pieces[:1], out, 5, ctx)
    with pytest.raises(ValueError, match="takes 2-64"):
        polyeval.horner_params(pieces * 17, out, 5, ctx)
    with pytest.raises(ValueError, match="piece 1"):
        polyeval.horner_params([pieces[0], pieces[1][:-1]], out, 5, ctx)


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
    assert (gp.LAUNCHES, polyeval.LAUNCHES) == before
    meta = [t.to("meta") for t in case[:4]]
    with pytest.raises(ValueError, match="unsupported device"):
        gp.lookup_z(Fq, BLINDING, *meta, beta, gamma, case[6].to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        gp.perm_z(Fq, BLINDING, meta[:2], meta[2:], omega_pw.to("meta"), beta, gamma, dpows, None, rand_rows)
    with pytest.raises(ValueError, match="unsupported device"):
        polyeval.horner_fold_mont(Fq, meta, 3)


@pytest.mark.gpu
def test_kernels_equal_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    T, dev = scan.TILE_ROWS, torch.device("cuda")
    rng = np.random.default_rng(7)

    def card(t):  # a tensor, a list of tensors, or a host value
        if isinstance(t, torch.Tensor):
            return t.to(dev)
        return [c.to(dev) if isinstance(c, torch.Tensor) else c for c in t] if isinstance(t, list) else t

    for F in (Fp, Fq, FrBn, FqBn):
        p = F.MODULUS
        for n in (5, 1000, T - 1, T, T + 1, (1 << 12) + 5, 33 * T + 5):
            case = [card(t) for t in lookup_case(F, rng, n % 2 == 1, n)]
            before = gp.LAUNCHES["grand_product"]
            got = gp.lookup_z(F, BLINDING, *case)
            torch.cuda.synchronize()
            assert gp.LAUNCHES["grand_product"] == before + gp.KERNELS_PER_CALL
            want = values(gp.lookup_z_plain(F, BLINDING, *case), F)
            assert values(got, F) == want, (F.__name__, n, "lookup")
            assert max(fo.limbs_to_ints(got)) < 2 * p
            init = last = None
            for ncols in (1, 2, 6):
                cols, sigmas, omega_pw, beta, gamma, dpows, rand_rows = (
                    card(t) for t in perm_case(F, rng, ncols, ncols == 2, n))
                z, last_z = gp.perm_z(F, BLINDING, cols, sigmas, omega_pw, beta, gamma, dpows, init, rand_rows)
                wz, wlast = gp.perm_z_plain(F, BLINDING, cols, sigmas, omega_pw, beta, gamma, dpows, last,
                                            rand_rows)
                assert values(z, F) == values(wz, F), (F.__name__, n, ncols)
                assert values(last_z[None], F) == values(wlast[None], F), (F.__name__, n, ncols, "last_z")
                assert max(fo.limbs_to_ints(z)) < 2 * p
                init, last = last_z, wlast
            if n in (T + 1, 33 * T + 5):
                for out in replayed(lambda: gp.lookup_z(F, BLINDING, *case)):
                    assert values(out, F) == want, (F.__name__, n, "lookup replay")
            x = int(rng.integers(1, 1 << 62)) % p
            for M in (2, 3, 7):
                pieces = limbs(lazy_vals(p, M * n, rng, [0, p, p - 1, 2 * p - 1])).reshape(M, n, 16).to(dev)
                before = polyeval.LAUNCHES["horner"]
                got = polyeval.horner_fold_mont(F, list(pieces), x)
                assert polyeval.LAUNCHES["horner"] == before + 1
                want_h = polyeval.horner_fold_mont_plain(F, list(pieces), x)
                assert torch.equal(got, want_h), (F.__name__, n, M, "horner")
                if n == T + 1:
                    for out in replayed(lambda: polyeval.horner_fold_mont(F, pieces, x)):
                        assert torch.equal(out, want_h), (F.__name__, n, M, "horner replay")
