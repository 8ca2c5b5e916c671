"""Kernels D and E (ops/polyeval.py, csrc/polyeval.cu): batched polynomial
evaluation, the powers of a point, and Kate division.

On the CPU: the plain versions equal the JAX package's `device_powers`,
batch evaluation (M = 3, a repeated point and the point 0) and Kate
division as values on Fp, Fq and FrBn at n = 3, with the values 0, p,
p - 1 and 2p - 1 among the coefficients; the launches' preparation (the
points' tables x^(2^j) and each polynomial's row in them, the row blocks,
b as words); CPU tensors take the plain versions and launch nothing, other
devices raise.
On the card (`gpu`): each kernel equals its plain version as values, its
output in [0, 2p); Kate division also at a tile's rows - 1, + 0 and + 1
and at more than 32 tiles, and after replays of a CUDA graph.
"""

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
from chip_smoke import replayed

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


@pytest.mark.parametrize("F,JF", FIELDS, ids=IDS)
def test_plain_versions_match_jax(F, JF):
    """The JAX package's three programs (device_powers :36, the jitted
    _batch_eval_kernel :71 behind batch_eval_mont, _kate_kernel :137 behind
    kate_division_mont) compiled as one program, one compile a field."""
    p = F.MODULUS
    tctx, jctx = fo.FieldCtx(F), fj.FieldCtx(JF)
    x, jx = both(lazy_vals(p, 7, 1)[-2:], (2,))
    c, jc = both(lazy_vals(p, 3 * N, 2), (3, N))
    a, ja = both(lazy_vals(p, N, 3), (N,))
    points, b = [7, 0, 7], p - 5
    uniq = sorted(set(points))  # batch_eval_mont's distinct points and selection
    sel = jnp.asarray([uniq.index(v) for v in points], dtype=jnp.int32)

    def programs(jx, jc, xs, sel, ja, jb):
        return (jpe.device_powers(jx, N, jctx), jpe._batch_eval_kernel(JF, 3, N, len(uniq))(jc, xs, sel),
                jpe._kate_kernel(JF, N)(ja, jb)[0])

    want = jax.jit(programs)(jx, jc, jctx.consts(uniq), sel, ja, jctx.const(b))
    q = polyeval.kate_division_mont_plain(F, a, b)
    got = (polyeval.device_powers_plain(x, N, tctx), polyeval.batch_eval_mont_plain(F, c, points), q)
    for g, w in zip(got, want):
        assert values(g, F) == jctx.decode_ints(w)
    # (a(X) - a(b)) = q(X) (X - b), at X = 3
    coeffs, quot = values(a, F), values(q, F)
    ev = lambda cs, x: sum(c * pow(x, i, p) for i, c in enumerate(cs)) % p  # noqa: E731
    assert quot[-1] == 0
    assert (ev(coeffs, 3) - ev(coeffs, b)) % p == ev(quot, 3) * (3 - b) % p


def test_point_tables():
    ctx = fo.FieldCtx(Fq)
    p = Fq.MODULUS
    points = [9, p + 2, 0, 9, 2]
    table, sel = polyeval.point_tables(ctx, points, 45)
    L = polyeval.table_bits(45)
    assert L == 6 and table.shape == (3, L, 16) and table.dtype == np.int32
    assert sel.tolist() == [2, 1, 0, 2, 1]  # sorted distinct points mod p: 0, 2, 9
    for row, x in zip(table, [0, 2, 9]):
        assert ctx.decode_ints(torch.as_tensor(row)) == [pow(x, 1 << j, p) for j in range(L)]
    assert [polyeval.table_bits(n) for n in (1, 2, 3, 4, 5, 1 << 14)] == [1, 1, 2, 2, 3, 14]
    assert [polyeval.eval_blocks(n) for n in (1, 1024, 1025, 1 << 14)] == [1, 1, 2, 16]
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
    assert polyeval.LAUNCHES == before
    meta = torch.empty((2, 4, 16), dtype=torch.int32, device="meta")
    for call in (lambda: polyeval.batch_eval_mont(Fp, meta, [1, 2]),
                 lambda: polyeval.device_powers(meta[0, 0], 4, ctx),
                 lambda: polyeval.kate_division_mont(Fp, meta[0], 3)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


@pytest.mark.gpu
def test_kernels_equal_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    for F in (Fp, Fq, FrBn):
        p, ctx = F.MODULUS, fo.FieldCtx(F)
        for n in (1, 9, 1000, (1 << 12) + 5):
            c = limbs(lazy_vals(p, 3 * n, n), "cuda").reshape(3, n, 16)
            outs = [
                (polyeval.batch_eval_mont(F, c, [7, 0, 7]), polyeval.batch_eval_mont_plain(F, c, [7, 0, 7])),
                (polyeval.device_powers(c[:, 0], n, ctx), polyeval.device_powers_plain(c[:, 0], n, ctx)),
                (polyeval.kate_division_mont(F, c[1], p - 5), polyeval.kate_division_mont_plain(F, c[1], p - 5)),
            ]
            torch.cuda.synchronize()
            for got, want in outs:
                assert values(got, F) == values(want, F), (F.__name__, n)
                assert max(fo.limbs_to_ints(got.reshape(-1, 16))) < 2 * p
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
