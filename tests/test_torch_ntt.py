"""The port's constant-geometry NTT (halo2_tpu_torch.ops.ntt_cg) and its
evaluation domain against the JAX package on the CPU.

`halo2_tpu.ops.ntt.NttPlan` is the JAX package's own CPU reference for the
constant-geometry Pallas kernel (tests/test_ntt_pallas2.py). On a CPU tensor
the port's `cg_ntt_level` runs its plain torch version, so these tests drive
the level structure, slot order, gathers and inter-level twiddles that the
CUDA kernel sits in. MAX_LOG_F is lowered so that several levels run, and at
k = 11 a level has g = 256 columns per inter-twiddle table. Comparisons are
exact on canonical values. The plain level's contract (strided load of the
(B, f, g) columns, natural-order store, the last level's digit-reversed
placement) is held to the composition the first port ran in torch around
the level (transpose, level, rev gather). The kernel itself is held against
the plain version, bit for bit, by the `gpu` test below and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_tpu.fields import Fq as JFq
from halo2_tpu.ops.field_jax import FieldCtx as JFieldCtx
from halo2_tpu.ops.ntt import NttPlan as JNttPlan
from halo2_tpu.poly import COEFF as J_COEFF, LAGRANGE as J_LAGRANGE
from halo2_tpu.poly import FVec as JFVec, Polynomial as JPolynomial
from halo2_tpu.poly.domain import EvaluationDomain as JDomain
from halo2_tpu_torch.fields import Fq
from halo2_tpu_torch.interop import fvec, limbs_tensor
from halo2_tpu_torch.ops import ntt_cg
from halo2_tpu_torch.ops.field import FieldCtx, add_mod, from_mont, ints_to_limbs, mont_mul, sub_mod
from halo2_tpu_torch.ops.ntt import NttPlan, bitrev_perm
from halo2_tpu_torch.ops.ntt_cg import CgNttPlan, _cg_stage_tables
from halo2_tpu_torch.poly import COEFF, LAGRANGE, Polynomial
from halo2_tpu_torch.poly.domain import EvaluationDomain

torch.set_num_threads(2)


def mont_input(n: int, seed: int) -> np.ndarray:
    """(n, 16) uint32 Montgomery limbs in [0, 2p): random 254-bit values."""
    limbs = np.random.default_rng(seed).integers(0, 1 << 16, (n, 16), dtype=np.uint32)
    limbs[:, 15] &= 0x3FFF
    return limbs


def canon_j(x) -> np.ndarray:
    return np.asarray(JFieldCtx(JFq).from_mont(x)).astype(np.int64)


def canon_t(x) -> np.ndarray:
    return from_mont(x, FieldCtx(Fq)).numpy().astype(np.int64)


def test_cg_stage_tables_invariant():
    p = Fq.MODULUS
    for log_f in (1, 3, 5, 8):
        f = 1 << log_f
        w_f = pow(Fq.ROOT_OF_UNITY, 1 << (Fq.S - log_f), p)
        stages, rev = _cg_stage_tables(f, w_f, p, FieldCtx(Fq).r_int)
        assert len(stages) == log_f and all(len(s) == f // 2 for s in stages)
        assert sorted(int(v) for v in rev) == list(range(f))


@pytest.mark.parametrize("k,max_log_f", [(3, 2), (6, 3), (7, 3), (11, 3)])
def test_cg_plan_matches_jax(k, max_log_f, monkeypatch):
    p = Fq.MODULUS
    omega = pow(Fq.ROOT_OF_UNITY, 1 << (Fq.S - k), p)
    a = mont_input(1 << k, seed=k)
    want = JNttPlan(JFq, k, omega)(jnp.asarray(a))
    monkeypatch.setattr(CgNttPlan, "MAX_LOG_F", max_log_f)
    plan = CgNttPlan(Fq, k, omega)
    assert len(plan.levels) == -(-k // max_log_f)
    got = plan(limbs_tensor(a))
    assert (canon_t(got) == canon_j(want)).all()
    # the port's radix-2 whole-transform reference agrees too
    assert (canon_t(NttPlan(Fq, k, omega)(limbs_tensor(a))) == canon_j(want)).all()


def test_inverse_plan_inverts():
    k = 8
    p = Fq.MODULUS
    omega = pow(Fq.ROOT_OF_UNITY, 1 << (Fq.S - k), p)
    ctx = FieldCtx(Fq)
    a = limbs_tensor(mont_input(1 << k, seed=9))
    y = CgNttPlan(Fq, k, pow(omega, -1, p))(CgNttPlan(Fq, k, omega)(a))
    back = ctx.mul(y, ctx.const(pow(1 << k, -1, p), "cpu"))
    assert (canon_t(back) == canon_t(a)).all()


def _old_level(cols, stw, inter, ctx):
    """The first port's plain level on (cols, f, 16) columns, slot order out,
    followed by its wrapper's rev gather."""
    n, f, _ = cols.shape
    for s in range(stw.shape[0]):
        lo, hi = cols[:, : f // 2], cols[:, f // 2 :]
        t = mont_mul(hi, stw[s], ctx)
        cols = torch.stack([add_mod(lo, t, ctx), sub_mod(lo, t, ctx)], dim=2).reshape(n, f, 16)
    if inter is not None:
        cols = mont_mul(cols, inter[torch.arange(n) % inter.shape[0]], ctx)
    return cols[:, torch.as_tensor(bitrev_perm(f.bit_length() - 1))]


@pytest.mark.parametrize("log_f,B,g", [(2, 3, 4), (4, 2, 8), (6, 2, 2), (8, 1, 2)])
def test_plain_level_contract_matches_old_composition(log_f, B, g, monkeypatch):
    """Strided load of column (b, j2) from (B, f, g), natural-order store to
    (B, f, g); with g = 1 and perm, row k1 of column b lands at [k1, perm[b]]."""
    f = 1 << log_f
    ctx = FieldCtx(Fq)
    p = Fq.MODULUS
    monkeypatch.setattr(CgNttPlan, "MAX_LOG_F", log_f)
    log_n = log_f + g.bit_length() - 1
    plan = CgNttPlan(Fq, log_n, pow(Fq.ROOT_OF_UNITY, 1 << (Fq.S - log_n), p))
    stw, inter = (torch.as_tensor(plan.levels[0][name]) for name in ("stw", "inter"))
    assert tuple(stw.shape) == (log_f, f // 2, 16) and tuple(inter.shape) == (g, f, 16)
    x = limbs_tensor(mont_input(B * f * g, seed=log_f)).reshape(B, f, g, 16)
    got = ntt_cg.cg_ntt_level_plain(x, stw, inter, ctx)
    old = _old_level(x.transpose(1, 2).reshape(B * g, f, 16), stw, inter, ctx)
    assert torch.equal(got, old.reshape(B, g, f, 16).transpose(1, 2))
    # the last level's placement: no inter table, perm a permutation of the columns
    perm = torch.as_tensor(np.random.default_rng(log_f).permutation(B * g).astype(np.int32))
    x1 = x.reshape(B * g, f, 1, 16)
    got = ntt_cg.cg_ntt_level(x1, stw, None, ctx, perm)
    old = _old_level(x1.reshape(B * g, f, 16), stw, None, ctx)
    assert tuple(got.shape) == (f, B * g, 16)
    assert torch.equal(got[:, perm.long()], old.transpose(0, 1))


def test_last_level_perm_is_digit_reversal(monkeypatch):
    """2^8 at MAX_LOG_F = 3: levels f = 8, 8, 4; the last level's column
    b = k1 * 8 + k2 goes to k1 + 8 k2, row k3 of it to k3 * 64 + that."""
    monkeypatch.setattr(CgNttPlan, "MAX_LOG_F", 3)
    p = Fq.MODULUS
    plan = CgNttPlan(Fq, 8, pow(Fq.ROOT_OF_UNITY, 1 << (Fq.S - 8), p))
    assert [(lv["f"], lv["g"]) for lv in plan.levels] == [(8, 32), (8, 4), (4, 1)]
    assert all(lv["perm"] is None for lv in plan.levels[:-1])
    assert list(plan.levels[-1]["perm"]) == [k1 + 8 * k2 for k1 in range(8) for k2 in range(8)]


def test_level_wrapper_checks_device():
    ctx = FieldCtx(Fq)
    x = torch.zeros((2, 4, 16), dtype=torch.int32, device="meta")
    stw = torch.zeros((2, 2, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ntt_cg.cg_ntt_level(x, stw, None, ctx)


def _domains(k=5, j=4):
    return JDomain(JFq, j, k), EvaluationDomain(Fq, j, k, "cpu")


def test_domain_transforms_match_jax():
    jd, td = _domains()
    a = mont_input(jd.n, seed=21)
    jl = JPolynomial(J_LAGRANGE, JFVec(JFq, jnp.asarray(a)))
    tl = Polynomial(LAGRANGE, fvec("Fq", a))

    jc, tc = jd.lagrange_to_coeff(jl), td.lagrange_to_coeff(tl)
    assert tc.basis == COEFF and jc.basis == J_COEFF
    assert (canon_t(tc.vec.vals) == canon_j(jc.vec.vals)).all()

    je, te = jd.coeff_to_extended(jc), td.coeff_to_extended(tc)
    assert te.vec.vals.shape[0] == jd.extended_n
    assert (canon_t(te.vec.vals) == canon_j(je.vec.vals)).all()

    jparts, tparts = jd.coeff_to_extended_parts(jc), td.coeff_to_extended_parts(tc)
    assert len(tparts) == len(jparts)
    for jp, tp in zip(jparts, tparts):
        assert (canon_t(tp.vec.vals) == canon_j(jp.vec.vals)).all()

    jback, tback = jd.extended_to_coeff(je), td.extended_to_coeff(te)
    assert (canon_t(tback.vals) == canon_j(jback.vals)).all()

    jm = jd.lagrange_vecs_to_extended([jparts[:1], jparts[:2]])
    tm = td.lagrange_vecs_to_extended([tparts[:1], tparts[:2]])
    assert (canon_t(tm.vec.vals) == canon_j(jm.vec.vals)).all()

    jv, tv = jd.divide_by_vanishing_poly(je), td.divide_by_vanishing_poly(te)
    assert (canon_t(tv.vec.vals) == canon_j(jv.vec.vals)).all()


def edge_input(n: int, seed: int) -> np.ndarray:
    """(n, 16) Montgomery limbs: 0, 1, p - 1 and 2p - 1 (the lazy domain's
    ends) in the first rows, uniform values below 2p after them."""
    p = Fq.MODULUS
    rng = np.random.default_rng(seed)
    vals = [0, 1, p - 1, 2 * p - 1] + [int.from_bytes(rng.bytes(32), "little") % (2 * p)
                                       for _ in range(n - 4)]
    return ints_to_limbs(vals)


@pytest.mark.gpu
def test_cg_level_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    ctx = FieldCtx(Fq)
    p = Fq.MODULUS
    for log_n in (10, 14, 16):
        n = 1 << log_n
        w = pow(Fq.ROOT_OF_UNITY, 1 << (Fq.S - log_n), p)
        for omega in (w, pow(w, -1, p)):
            plan = CgNttPlan(Fq, log_n, omega)
            for li, (lv, tab) in enumerate(zip(plan.levels, plan._tables("cuda"))):
                f, g = lv["f"], lv["g"]
                x = torch.as_tensor(edge_input(n, seed=log_n + li), device="cuda")
                x = x.reshape(n // (f * g), f, g, 16)
                got = ntt_cg.cg_ntt_level(x, tab["stw"], tab["inter"], ctx, tab["perm"])
                want = ntt_cg.cg_ntt_level_plain(x, tab["stw"], tab["inter"], ctx, tab["perm"])
                torch.cuda.synchronize()
                assert torch.equal(got, want), f"2^{log_n} level {li}"
            # the whole transform: natural order, the radix-2 reference's values
            a = torch.as_tensor(edge_input(n, seed=log_n), device="cuda")
            assert torch.equal(from_mont(plan(a), ctx), from_mont(NttPlan(Fq, log_n, omega)(a), ctx))
