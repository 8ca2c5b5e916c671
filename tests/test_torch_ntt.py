"""The port's constant-geometry NTT (halo2_tpu_torch.ops.ntt_cg) and its
evaluation domain against the JAX package on the CPU.

`halo2_tpu.ops.ntt.NttPlan` is the JAX package's own CPU reference for the
constant-geometry Pallas kernel (tests/test_ntt_pallas2.py). On a CPU tensor
the port's `cg_ntt_level` runs its plain torch version, so these tests drive
the level structure, slot order, gathers and inter-level twiddles that the
CUDA kernel sits in. MAX_LOG_F is lowered so that several levels run, and at
k = 11 a level has g = 256 columns per inter-twiddle table. Comparisons are
exact on canonical values. The kernel itself is held against the plain
version on the card by the `gpu` test below and by chip_smoke.py.
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
from halo2_tpu_torch.ops.field import FieldCtx, from_mont
from halo2_tpu_torch.ops.ntt import NttPlan
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


@pytest.mark.gpu
def test_cg_level_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    ctx = FieldCtx(Fq)
    p = Fq.MODULUS
    for log_n in (10, 14):
        plan = CgNttPlan(Fq, log_n, pow(Fq.ROOT_OF_UNITY, 1 << (Fq.S - log_n), p))
        for lv, tab in zip(plan.levels, plan._tables("cuda")):
            x = limbs_tensor(mont_input((1 << log_n), seed=log_n), "cuda")
            x = x.reshape(-1, lv["f"], 16)
            got = ntt_cg.cg_ntt_level(x, tab["stw"], tab["inter"], ctx)
            want = ntt_cg.cg_ntt_level_plain(x, tab["stw"], tab["inter"], ctx)
            torch.cuda.synchronize()
            assert torch.equal(from_mont(got.reshape(-1, 16), ctx),
                               from_mont(want.reshape(-1, 16), ctx))
