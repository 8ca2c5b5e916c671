"""The port's limb field arithmetic (halo2_tpu_torch.ops.field / ops.scan)
against the JAX package's (ops.field_jax / ops.scan) on the CPU.

Both packages get the same (n, 16) Montgomery limb arrays, made with numpy
from a seed, including non-reduced representatives in [p, 2p). Results are
compared exactly after canonicalisation: each side may return another
representative in [0, 2p) of the same residue.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_tpu.fields import Fp as JFp, Fq as JFq
from halo2_tpu.ops import field_jax as fj
from halo2_tpu.ops import scan as jscan
from halo2_tpu_torch.fields import Fp, Fq
from halo2_tpu_torch.interop import limbs_tensor
from halo2_tpu_torch.ops import field as fo
from halo2_tpu_torch.ops import polyeval as tpe
from halo2_tpu_torch.ops import scan as tscan

torch.set_num_threads(2)

FIELDS = [(Fp, JFp), (Fq, JFq)]


def lazy_mont(p: int, n: int, seed: int) -> np.ndarray:
    """n Montgomery limb vectors in [0, 2p): random residues, half of them
    lifted by p, plus 0, p, 1 and 2p - 1 (uint32, as the JAX package holds them)."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n - 4)]
    vals = [v + p if i % 2 else v for i, v in enumerate(vals)] + [0, p, 1, 2 * p - 1]
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").reshape(n, 16).astype(np.uint32)


def canon_jax(x, jctx) -> np.ndarray:
    return np.asarray(jctx.from_mont(x)).astype(np.int64)


def canon_torch(x, tctx) -> np.ndarray:
    return fo.from_mont(x, tctx).numpy().astype(np.int64)


@pytest.mark.parametrize("op", ["mont_mul", "add_mod", "sub_mod", "neg_mod", "from_mont"])
@pytest.mark.parametrize("F,JF", FIELDS, ids=["Fp", "Fq"])
def test_binary_ops_match_jax(F, JF, op):
    jctx, tctx = fj.FieldCtx(JF), fo.FieldCtx(F)
    a = lazy_mont(F.MODULUS, 96, seed=1)
    b = lazy_mont(F.MODULUS, 96, seed=2)[::-1].copy()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = limbs_tensor(a), limbs_tensor(b)
    if op == "from_mont":
        got = fo.from_mont(ta, tctx).numpy()
        want = np.asarray(fj.from_mont(ja, jctx))
        assert (got.astype(np.int64) == want.astype(np.int64)).all()
        return
    if op == "neg_mod":
        got = fo.neg_mod(ta, tctx)
        want = fj.neg_mod(ja, jctx)
    else:
        got = getattr(fo, op)(ta, tb, tctx)
        want = getattr(fj, op)(ja, jb, jctx)
    assert got.dtype == torch.int32 and tuple(got.shape) == (96, 16)
    # lazy domain: every limb in [0, 2^16) and the value below 2p
    assert int(got.min()) >= 0 and int(got.max()) < 1 << 16
    assert all(v < 2 * F.MODULUS for v in fo.limbs_to_ints(got))
    assert (canon_torch(got, tctx) == canon_jax(want, jctx)).all()


@pytest.mark.parametrize("F,JF", FIELDS, ids=["Fp", "Fq"])
def test_inv_mod_matches_jax(F, JF):
    jctx, tctx = fj.FieldCtx(JF), fo.FieldCtx(F)
    a = lazy_mont(F.MODULUS, 6, seed=3)
    got = fo.inv_mod(limbs_tensor(a), tctx)
    want = fj.inv_mod(jnp.asarray(a), jctx)
    assert (canon_torch(got, tctx) == canon_jax(want, jctx)).all()


@pytest.mark.parametrize("F,JF", FIELDS, ids=["Fp", "Fq"])
def test_batch_invert_matches_jax(F, JF):
    jctx, tctx = fj.FieldCtx(JF), fo.FieldCtx(F)
    a = lazy_mont(F.MODULUS, 37, seed=4)  # holds 0 and p: both invert to 0
    got = tscan.batch_invert(limbs_tensor(a), tctx)
    want = jscan.batch_invert(jnp.asarray(a), jctx)
    assert (canon_torch(got, tctx) == canon_jax(want, jctx)).all()


@pytest.mark.parametrize("scan", ["prefix_product", "exclusive_prefix_product"])
@pytest.mark.parametrize("F,JF", FIELDS, ids=["Fp", "Fq"])
def test_scans_match_jax(F, JF, scan):
    jctx, tctx = fj.FieldCtx(JF), fo.FieldCtx(F)
    a = lazy_mont(F.MODULUS, 45, seed=5)
    got = getattr(tscan, scan)(limbs_tensor(a), tctx)
    want = getattr(jscan, scan)(jnp.asarray(a), jctx)
    assert (canon_torch(got, tctx) == canon_jax(want, jctx)).all()


@pytest.mark.parametrize("F,JF", FIELDS, ids=["Fp", "Fq"])
def test_derived_ops_match_jax(F, JF):
    """double_mod, mont_sqr, pow_const, batch_invert_mod, and the lazy-domain
    predicates is_zero / eq_mod with select."""
    jctx, tctx = fj.FieldCtx(JF), fo.FieldCtx(F)
    a = lazy_mont(F.MODULUS, 24, seed=8)
    ja, ta = jnp.asarray(a), limbs_tensor(a)
    # the last row is 2p - 1: 2(2p - 1) >= 2^256, and the JAX package's
    # add_mod drops that carry (field_jax._sweep stops at 16 limbs), so the
    # port is held to host integers there instead
    assert fo.limbs_to_ints(fo.double_mod(ta[-1:], tctx)) == [2 * F.MODULUS - 2]
    for got, want in (
        (fo.double_mod(ta[:-1], tctx), fj.double_mod(ja[:-1], jctx)),
        (fo.mont_sqr(ta, tctx), fj.mont_sqr(ja, jctx)),
        (fo.pow_const(ta, 5, tctx), fj.pow_const(ja, 5, jctx)),
        (fo.pow_const(ta, 0, tctx), fj.pow_const(ja, 0, jctx)),
        (fo.batch_invert_mod(ta[:4], tctx), fj.batch_invert_mod(ja[:4], jctx)),
    ):
        assert (canon_torch(got, tctx) == canon_jax(want, jctx)).all()
    zero = fo.is_zero(ta, tctx)
    assert zero.tolist() == np.asarray(fj.is_zero(ja, jctx)).tolist()
    assert zero.sum() == 2  # 0 and p
    lifted = fo.add_mod(ta, limbs_tensor(lazy_mont(F.MODULUS, 24, seed=8)[::-1].copy()), tctx)
    other = fo.sub_mod(lifted, limbs_tensor(lazy_mont(F.MODULUS, 24, seed=8)[::-1].copy()), tctx)
    assert bool(fo.eq_mod(other, ta, tctx).all())
    assert not bool(fo.eq_mod(fo.add_mod(ta, tctx.one("cpu"), tctx), ta, tctx).any())
    picked = fo.select(zero, tctx.one("cpu").expand_as(ta), ta)
    assert (canon_torch(picked, tctx)[~zero.numpy()] == canon_torch(ta, tctx)[~zero.numpy()]).all()
    assert tctx.decode_ints(picked[zero]) == [1, 1]


def test_intt_inverts_the_forward_transform():
    from halo2_tpu_torch.ops.ntt import get_plan, intt

    k, p = 6, Fq.MODULUS
    omega = pow(Fq.ROOT_OF_UNITY, 1 << (Fq.S - k), p)
    a = limbs_tensor(lazy_mont(p, 1 << k, seed=9))
    back = intt(get_plan(Fq, k, omega)(a), Fq, pow(omega, -1, p), pow(1 << k, -1, p))
    tctx = fo.FieldCtx(Fq)
    assert (canon_torch(back, tctx) == canon_torch(a, tctx)).all()


def test_polyeval_matches_host_bigints():
    """batch_eval and kate_division_mont against Horner over host ints (the
    prove tests pin their use inside a proof to the JAX package's bytes)."""
    p = Fq.MODULUS
    tctx = fo.FieldCtx(Fq)
    stack = np.stack([lazy_mont(p, 33, seed=s) for s in (6, 7)])
    coeffs = [tctx.decode_ints(limbs_tensor(row)) for row in stack]
    points = [5, p - 3]

    def horner(cs, x):
        acc = 0
        for c in reversed(cs):
            acc = (acc * x + c) % p
        return acc

    assert tpe.batch_eval(Fq, limbs_tensor(stack), points) == [
        horner(cs, x) for cs, x in zip(coeffs, points)]
    quot = tctx.decode_ints(tpe.kate_division_mont(Fq, limbs_tensor(stack[0]), 11))
    x = 777  # (a(X) - a(11)) = q(X) (X - 11), checked at X = 777
    assert quot[-1] == 0
    assert (horner(coeffs[0], x) - horner(coeffs[0], 11)) % p == horner(quot, x) * (x - 11) % p


def test_host_packing_roundtrip():
    vals = [0, 1, (1 << 256) - 1, Fp.MODULUS - 1, 0x1234_5678_9ABC_DEF0 << 190]
    assert fo.limbs_to_ints(fo.ints_to_limbs(vals)) == vals
    ctx = fo.FieldCtx(Fp)
    assert ctx.decode_ints(ctx.encode_ints(vals[:2] + vals[3:4], "cpu")) == [0, 1, Fp.MODULUS - 1]
