"""Kernels D and E (ops/polyeval.py, csrc/polyeval.cu): batched polynomial
evaluation, the powers of a point, and Kate division.

On the CPU: the plain versions equal the JAX package's `device_powers`,
batch evaluation (M = 3, a repeated point and the point 0) and Kate
division as values on Fp, Fq and FrBn at n = 3, with the values 0, p,
p - 1 and 2p - 1 among the coefficients, and so do the powers of a host
point (`point_powers`); the launches' preparation (the points' squares,
the polynomials grouped by point, the launches of a call, the row blocks
and rows a thread, b as words); CPU tensors take the plain versions and
launch nothing, other devices raise.
On the card (`gpu`): each kernel equals its plain version as values, its
output in [0, 2p), with one launch an evaluation and a host point's
powers, also after replays of a CUDA graph and on two streams at once,
and over several launches for more points than one takes; Kate division
also at a tile's rows - 1, + 0 and + 1 and at more than 32 tiles.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_tpu.fields import Fp as JFp, Fq as JFq, FrBn as JFrBn
from halo2_tpu.ops import field_jax as fj
from halo2_tpu.ops import polyeval as jpe
from halo2_tpu_torch.fields import Fp, Fq, FrBn
from halo2_tpu_torch.ops import field as fo
from halo2_tpu_torch.ops import polyeval, scan
from chip_smoke import replayed, two_streams

torch.set_num_threads(2)

FIELDS = [(Fp, JFp), (Fq, JFq), (FrBn, JFrBn)]
IDS = ["Fp", "Fq", "FrBn"]
N = 3  # rows of the JAX comparisons: each program's compile costs seconds, not its rows


def lazy_vals(p: int, n: int, seed: int):
    """0, p, p - 1 and 2p - 1, then values uniform below 2p."""
    rng = np.random.default_rng(seed)
    return ([0, p, p - 1, 2 * p - 1]
            + [int.from_bytes(rng.bytes(40), "little") % (2 * p) for _ in range(n - 4)])[:n]


def limbs(vals, device="cpu"):
    return torch.as_tensor(fo.ints_to_limbs(vals), device=device)


def both(vals, shape):
    """The same limbs as a port tensor and a JAX array, shaped (*shape, 16)."""
    arr = fo.ints_to_limbs(vals).reshape(*shape, 16)
    return torch.as_tensor(arr), jnp.asarray(arr.astype(np.uint32))


def values(t, F):
    return fo.FieldCtx(F).decode_ints(t)


POINTS, X_ROWS = [7, 0, 7], 2  # batch_eval's points; the points of device_powers


@functools.lru_cache(maxsize=None)
def jax_outputs(i: int):
    """The inputs of FIELDS[i] and the JAX package's three programs on them
    (device_powers :36, the jitted _batch_eval_kernel :71 behind
    batch_eval_mont, _kate_kernel :137 behind kate_division_mont) as
    values, compiled as one program: one compile a field, shared by the
    tests that read it."""
    F, JF = FIELDS[i]
    p = F.MODULUS
    jctx = fj.FieldCtx(JF)
    x, jx = both(lazy_vals(p, 7, 1)[-X_ROWS:], (X_ROWS,))
    c, jc = both(lazy_vals(p, 3 * N, 2), (3, N))
    a, ja = both(lazy_vals(p, N, 3), (N,))
    b = p - 5
    uniq = sorted(set(POINTS))  # batch_eval_mont's distinct points and selection
    sel = jnp.asarray([uniq.index(v) for v in POINTS], dtype=jnp.int32)

    def programs(jx, jc, xs, sel, ja, jb):
        return (jpe.device_powers(jx, N, jctx), jpe._batch_eval_kernel(JF, 3, N, len(uniq))(jc, xs, sel),
                jpe._kate_kernel(JF, N)(ja, jb)[0])

    want = jax.jit(programs)(jx, jc, jctx.consts(uniq), sel, ja, jctx.const(b))
    return (x, c, a, b), [jctx.decode_ints(w) for w in want]


@pytest.mark.parametrize("i", range(len(FIELDS)), ids=IDS)
def test_plain_versions_match_jax(i):
    F = FIELDS[i][0]
    p = F.MODULUS
    tctx = fo.FieldCtx(F)
    (x, c, a, b), want = jax_outputs(i)
    q = polyeval.kate_division_mont_plain(F, a, b)
    got = (polyeval.device_powers_plain(x, N, tctx), polyeval.batch_eval_mont_plain(F, c, POINTS), q)
    for g, w in zip(got, want):
        assert values(g, F) == w
    # (a(X) - a(b)) = q(X) (X - b), at X = 3
    coeffs, quot = values(a, F), values(q, F)
    ev = lambda cs, x: sum(c * pow(x, i, p) for i, c in enumerate(cs)) % p  # noqa: E731
    assert quot[-1] == 0
    assert (ev(coeffs, 3) - ev(coeffs, b)) % p == ev(quot, 3) * (3 - b) % p


@pytest.mark.parametrize("i", range(len(FIELDS)), ids=IDS)
def test_point_powers_match_jax(i):
    """point_powers of a host point (the IPA opening's b) against the JAX
    package's device_powers of the same point, at each n up to N."""
    F = FIELDS[i][0]
    tctx = fo.FieldCtx(F)
    (x, _, _, _), want = jax_outputs(i)
    for row, xv in enumerate(values(x, F)):
        assert values(polyeval.point_powers(tctx, xv, N, "cpu"), F) == want[0][row * N:(row + 1) * N]
        for n in range(1, N + 1):
            got = polyeval.point_powers(tctx, xv, n, torch.device("cpu"))
            assert got.shape == (n, 16) and values(got, F) == want[0][row * N:row * N + n]


def test_point_tables():
    """What a launch of kernel D takes in its parameters: each point's L
    squares (squares_words), the polynomials grouped by point (slots), and
    the launches a call needs; and its geometry."""
    ctx = fo.FieldCtx(Fq)
    p = Fq.MODULUS
    points = [9, p + 2, 0, 9, 2]
    L = polyeval.table_bits(45)
    assert L == 6
    words = polyeval.squares_words(ctx, [0, 2, 9], L)
    assert len(words) == 3 * L * 32
    vals = [int.from_bytes(words[32 * i:32 * (i + 1)], "little") * pow(ctx.r_int, -1, p) % p for i in range(3 * L)]
    assert vals == [pow(x, 1 << e, p) for x in (0, 2, 9) for e in range(L)]
    # sorted distinct points mod p: 0, 2, 9; the polynomials grouped by
    # point, then each point's first slot and M
    assert polyeval.eval_launches(points, p, L) == [([0, 2, 9], [2, 1, 4, 0, 3] + [0, 1, 3, 5], [1, 2, 2])]
    # more points than TABLE_FE // L, more polynomials than MAX_SLOTS
    many = polyeval.eval_launches(list(range(40)), p, 11)
    assert [len(xs) for xs, _, _ in many] == [8] * 5 and sum((xs for xs, _, _ in many), []) == list(range(40))
    big = polyeval.eval_launches([5] * 300 + [1], p, 14)
    assert [counts for _, _, counts in big] == [[1, 252], [48]]
    for L_, launches in ((11, many), (14, big)):
        for xs, slots, counts in launches:
            assert len(slots) == sum(counts) + len(xs) + 1 <= polyeval.MAX_SLOTS and len(xs) * L_ <= polyeval.TABLE_FE
    assert sorted(m for _, slots, counts in big for m in slots[:sum(counts)]) == list(range(301))
    assert [polyeval.table_bits(n) for n in (1, 2, 3, 4, 5, 1 << 14)] == [1, 1, 2, 2, 3, 14]
    T = polyeval.EVAL_THREADS
    assert [polyeval.eval_blocks(n, r, G) for n, r, G in ((1, 1, 1), (T, 1, 1), (T + 1, 1, 1), (1 << 14, 2, 1),
                                                          (1 << 14, 1, 4))] == [1, 1, 2, (1 << 13) // T, (1 << 16) // T]
    # groups G and rows a thread: the shortest run of products a thread,
    # rows (1 + ceil(M_q / G)), within the block limit, then the fewest blocks
    for n, counts, want in (((1 << 14), [1], (1, 1, 128)), ((1 << 14), [8], (4, 1, 512)),
                            ((1 << 14), [2, 2, 1], (1, 1, 128)), ((1 << 14), [0], (1, 1, 128)),
                            ((1 << 17), [2, 2, 2, 2], (1, 4, 256)), (45, [2, 2, 1], (2, 1, 1))):
        G, rows, blocks = polyeval.eval_geometry(n, counts)
        assert (G, rows, blocks) == want and blocks == polyeval.eval_blocks(n, rows, G)
        assert T // G >= 32 and (G == 1 or G // 2 < max(counts))
    b = list(polyeval.kate_words(ctx, p - 5))[:8]  # the table's first entry, b^(2^0)
    word = lambda w: sum(v << (32 * i) for i, v in enumerate(w))  # noqa: E731
    assert word(b) == (p - 5) * ctx.r_int % p


def test_cpu_tensors_take_the_plain_version():
    ctx = fo.FieldCtx(Fp)
    p = Fp.MODULUS
    c = limbs(lazy_vals(p, 2 * 45, 4)).reshape(2, 45, 16)
    before = dict(polyeval.LAUNCHES)
    assert torch.equal(polyeval.batch_eval_mont(Fp, c, [3, 4]), polyeval.batch_eval_mont_plain(Fp, c, [3, 4]))
    assert torch.equal(polyeval.device_powers(c[0, 5], 45, ctx), polyeval.device_powers_plain(c[0, 5], 45, ctx))
    assert torch.equal(polyeval.kate_division_mont(Fp, c[1], 11), polyeval.kate_division_mont_plain(Fp, c[1], 11))
    assert torch.equal(polyeval.point_powers(ctx, 12345, 45, "cpu"),
                       polyeval.device_powers_plain(ctx.const(12345, "cpu"), 45, ctx))
    assert polyeval.LAUNCHES == before
    meta = torch.empty((2, 4, 16), dtype=torch.int32, device="meta")
    for call in (lambda: polyeval.batch_eval_mont(Fp, meta, [1, 2]),
                 lambda: polyeval.device_powers(meta[0, 0], 4, ctx),
                 lambda: polyeval.kate_division_mont(Fp, meta[0], 3),
                 lambda: polyeval.point_powers(ctx, 3, 4, "meta")):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


@pytest.mark.gpu
def test_kernels_equal_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    for F in (Fp, Fq, FrBn):
        p, ctx = F.MODULUS, fo.FieldCtx(F)
        for n in (1, 2, 9, 256, 1000, 1 << 12, (1 << 12) + 5):
            c = limbs(lazy_vals(p, 3 * n, n), "cuda").reshape(3, n, 16)
            x = fo.FieldCtx(F).decode_ints(c[2, :1])[0]
            before = polyeval.LAUNCHES["batch_eval"]
            outs = [
                (polyeval.batch_eval_mont(F, c, [7, 0, 7]), polyeval.batch_eval_mont_plain(F, c, [7, 0, 7])),
                (polyeval.batch_eval_mont(F, c[1:2], [x]), polyeval.batch_eval_mont_plain(F, c[1:2], [x])),
                (polyeval.device_powers(c[:, 0], n, ctx), polyeval.device_powers_plain(c[:, 0], n, ctx)),
                (polyeval.point_powers(ctx, x, n, "cuda"), polyeval.device_powers_plain(c[2, 0], n, ctx)),
                (polyeval.kate_division_mont(F, c[1], p - 5), polyeval.kate_division_mont_plain(F, c[1], p - 5)),
            ]
            torch.cuda.synchronize()
            # one launch a call
            assert polyeval.LAUNCHES["batch_eval"] == before + 4
            # a call copies nothing to the card, so a CUDA graph holds it whole;
            # and two streams' calls may run at once
            outs += [(out, outs[0][1]) for out in replayed(lambda: polyeval.batch_eval_mont(F, c, [7, 0, 7]))]
            outs += [(out, outs[0][1]) for out in two_streams(lambda: polyeval.batch_eval_mont(F, c, [7, 0, 7]))]
            outs += [(out, outs[3][1]) for out in replayed(lambda: polyeval.point_powers(ctx, x, n, "cuda"))]
            for got, want in outs:
                assert values(got, F) == values(want, F), (F.__name__, n)
                assert max(fo.limbs_to_ints(got.reshape(-1, 16))) < 2 * p
        # more points than one launch takes
        n = 300
        c = limbs(lazy_vals(p, 40 * n, 7), "cuda").reshape(40, n, 16)
        pts = list(range(3, 43))
        before = polyeval.LAUNCHES["batch_eval"]
        got = polyeval.batch_eval_mont(F, c, pts)
        assert polyeval.LAUNCHES["batch_eval"] - before == len(polyeval.eval_launches(pts, p, 9)) > 1
        assert values(got, F) == values(polyeval.batch_eval_mont_plain(F, c, pts), F)
        T = scan.TILE_ROWS
        for n in (T - 1, T, T + 1, 33 * T + 5):
            a = limbs(lazy_vals(p, n, n), "cuda")
            before = polyeval.LAUNCHES["kate_div"]
            got = polyeval.kate_division_mont(F, a, p - 5)
            torch.cuda.synchronize()
            assert polyeval.LAUNCHES["kate_div"] == before + 1
            want = values(polyeval.kate_division_mont_plain(F, a, p - 5), F)
            assert values(got, F) == want and want[-1] == 0, (F.__name__, n)
            assert max(fo.limbs_to_ints(got)) < 2 * p
            for out in replayed(lambda: polyeval.kate_division_mont(F, a, p - 5)):
                assert values(out, F) == want, (F.__name__, n, "replay")
