"""The port's mixed-radix NTT (halo2_tpu_torch.ops.ntt_mr, the NTT=pallas
engine) and the engine switch `get_plan`, against the JAX package on the CPU.

On a CPU tensor `mr_col_ntt` runs its plain torch version, so these tests
drive the level tables, the bit reversal, the stages, the inter-level
twiddles and the (B, f, g) level contract that kernel 8 sits in. The tables
must equal those of the JAX package's `PallasNttPlan` (read host-side:
building that plan compiles nothing), a level must equal the same level
computed with the JAX package's field ops on the columns its (B, f, g) view
holds, and whole transforms must equal the JAX radix-2 `NttPlan` and, in a
subprocess, `PallasNttPlan` itself in interpret mode. Comparisons are exact
on canonical values. The kernel is held against the plain version on the
card, bit for bit, by the `gpu` tests below and by chip_smoke.py.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_tpu.fields import Fp as JFp, Fq as JFq, FrBn as JFrBn
from halo2_tpu.ops import field_jax
from halo2_tpu.ops.ntt import NttPlan as JNttPlan
from halo2_tpu.ops.ntt_pallas import PallasNttPlan as JPallasNttPlan
from halo2_tpu_torch.interop import field_of, limbs_tensor
from halo2_tpu_torch.ops import ntt_mr
from halo2_tpu_torch.ops.field import FieldCtx, from_mont, ints_to_limbs, limbs_to_ints
from halo2_tpu_torch.ops.mxu_mont import MxuNttPlan
from halo2_tpu_torch.ops.ntt import NttPlan, bitrev_perm, get_plan
from halo2_tpu_torch.ops.ntt_cg import CgNttPlan
from halo2_tpu_torch.ops.ntt_mr import MrNttPlan

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JFIELDS = {"Fq": JFq, "Fp": JFp, "FrBn": JFrBn}


def omega_for(field, k: int) -> int:
    return pow(field.ROOT_OF_UNITY, 1 << (field.S - k), field.MODULUS)


def mont_input(n: int, seed: int) -> np.ndarray:
    """(n, 16) uint32 limbs of random values below 2^253 (below 2p for all
    three fields), used as Montgomery residues."""
    limbs = np.random.default_rng(seed).integers(0, 1 << 16, (n, 16), dtype=np.uint32)
    limbs[..., 15] &= 0x1FFF
    return limbs


def canon_t(x, field) -> list:
    return limbs_to_ints(from_mont(x.reshape(-1, 16), FieldCtx(field)))


def canon_j(x, jfield) -> list:
    return limbs_to_ints(np.asarray(field_jax.FieldCtx(jfield).from_mont(jnp.asarray(x).reshape(-1, 16))))


@pytest.mark.parametrize("name,k", [("Fq", 4), ("Fp", 10), ("FrBn", 12), ("Fp", 17)])
def test_level_tables_match_pallas_plan(name, k):
    """stw, inter and the bit reversal of every level equal PallasNttPlan's;
    at k = 17 the first level has g = 512 > 2^8 inter-twiddle rows, which the
    JAX table tiles to its lane width and the port keeps at period g."""
    jfield = JFIELDS[name]
    field = field_of(name)
    jplan = JPallasNttPlan(jfield, k, omega_for(jfield, k))
    plan = MrNttPlan(field, k, omega_for(field, k))
    assert [(lv["f"], lv["g"]) for lv in plan.levels] == [(lv["f"], lv["g"]) for lv in jplan.levels]
    for lv, jlv in zip(plan.levels, jplan.levels):
        assert np.array_equal(lv["stw"], np.asarray(jlv["stw"]).astype(np.int32))
        assert np.array_equal(bitrev_perm(jlv["log_f"]), np.asarray(jlv["perm"]))
        if jlv["inter"] is None:
            assert lv["inter"] is None
            continue
        # JAX: (f, 16, tw_width), column j2 of the pattern tiled with period g
        jinter = np.transpose(np.asarray(jlv["inter"]), (2, 0, 1)).astype(np.int32)
        g = lv["g"]
        assert lv["inter"].shape == (g, lv["f"], 16)
        for start in range(0, jinter.shape[0], g):
            assert np.array_equal(lv["inter"], jinter[start : start + g])
    if k == 17:
        assert plan.levels[0]["g"] == 512


def _jax_level(x, stw, perm, inter, jfield):
    """One PallasNttPlan level with the JAX package's field ops: x (cols, f,
    16) natural rows, stw (log f, f/2, 16), inter (g, f, 16) or None."""
    ctx = field_jax.FieldCtx(jfield)
    cols, f, _ = x.shape
    x = x[:, perm]
    for s in range(stw.shape[0]):
        m = 1 << s
        blocks = x.reshape(cols, f // (2 * m), 2, m, 16)
        lo, hi = blocks[:, :, 0], blocks[:, :, 1]
        t = hi if s == 0 else field_jax.mont_mul(hi, stw[s].reshape(f // (2 * m), m, 16), ctx)
        x = jnp.stack([field_jax.add_mod(lo, t, ctx), field_jax.sub_mod(lo, t, ctx)], axis=2)
        x = x.reshape(cols, f, 16)
    if inter is not None:
        x = field_jax.mont_mul(x, inter[jnp.arange(cols) % inter.shape[0]], ctx)
    return x


def _columns(y, B, f, g, perm):
    """The (B g, f) columns of a level's output: (B, f, g), or (f, B) with perm."""
    if perm is None:
        return y.transpose(1, 2).reshape(B * g, f, 16)
    return y[:, torch.as_tensor(perm).long()].transpose(0, 1)


def _jax_level_on_view(x, lv, jfield):
    """_jax_level on the columns (b, j2) that x's (B, f, g) view holds."""
    B, f, g, _ = x.shape
    cols = jnp.asarray(np.ascontiguousarray(np.swapaxes(x, 1, 2)).reshape(B * g, f, 16))
    perm = jnp.asarray(bitrev_perm(f.bit_length() - 1))
    inter = None if lv["inter"] is None else jnp.asarray(lv["inter"].astype(np.uint32))
    stw = jnp.asarray(lv["stw"].astype(np.uint32))
    field_jax.FieldCtx(jfield)  # built eagerly: a context first built inside the trace would leak it
    return jax.jit(_jax_level, static_argnums=4)(cols, stw, perm, inter, jfield)


@pytest.mark.parametrize("name,k,level", [("Fq", 10, 0), ("FrBn", 10, 1)])
def test_level_plain_matches_jax_field_ops(name, k, level):
    """Level 0 of 2^10 is (B, f, g) = (1, 256, 4); level 1, the last, is
    (256, 4, 1) with perm."""
    jfield = JFIELDS[name]
    field = field_of(name)
    jlv = JPallasNttPlan(jfield, k, omega_for(jfield, k)).levels[level]
    lv = MrNttPlan(field, k, omega_for(field, k)).levels[level]
    f, g = lv["f"], lv["g"]
    assert (jlv["f"], jlv["g"]) == (f, g)
    B = (1 << k) // (f * g)
    x = mont_input((1 << k), seed=k + level).reshape(B, f, g, 16)
    want = _jax_level_on_view(x, lv, jfield)
    inter = None if lv["inter"] is None else torch.as_tensor(lv["inter"])
    perm = None if lv["perm"] is None else torch.as_tensor(lv["perm"])
    got = ntt_mr.mr_col_ntt(limbs_tensor(x), torch.as_tensor(lv["stw"]), inter, FieldCtx(field), perm)
    assert got.shape == ((f, B, 16) if perm is not None else x.shape)
    assert canon_t(_columns(got, B, f, g, lv["perm"]), field) == canon_j(want, jfield)


def test_level_contract_with_batch_and_period(monkeypatch):
    """MAX_LOG_F = 2 at k = 6: levels (B, f, g) = (1, 4, 16), (4, 4, 4) and
    (16, 4, 1) with perm. The middle level's plain output (B > 1, g > 1)
    equals the JAX field ops' level on the columns its view holds, the last
    level's perm is the digit reversal, and the levels chained in the
    contract give the radix-2 transform, bit for bit the plan's."""
    monkeypatch.setattr(MrNttPlan, "MAX_LOG_F", 2)
    name, k = "Fp", 6
    jfield, field = JFIELDS[name], field_of(name)
    ctx = FieldCtx(field)
    omega = omega_for(field, k)
    plan = MrNttPlan(field, k, omega)
    assert [(lv["f"], lv["g"]) for lv in plan.levels] == [(4, 16), (4, 4), (4, 1)]
    assert list(plan.levels[-1]["perm"]) == [k1 + 4 * k2 for k1 in range(4) for k2 in range(4)]
    a = limbs_tensor(mont_input(1 << k, seed=6))
    y = a
    for li, lv in enumerate(plan.levels):
        f, g = lv["f"], lv["g"]
        B = (1 << k) // (f * g)
        x = y.reshape(B, f, g, 16)
        inter = None if lv["inter"] is None else torch.as_tensor(lv["inter"])
        perm = None if lv["perm"] is None else torch.as_tensor(lv["perm"])
        y = ntt_mr.mr_col_ntt(x, torch.as_tensor(lv["stw"]), inter, ctx, perm)
        if li == 1:
            want = _jax_level_on_view(x.numpy().astype(np.uint32), lv, jfield)
            assert canon_t(_columns(y, B, f, g, None), field) == canon_j(want, jfield)
    assert canon_t(y, field) == canon_t(NttPlan(field, k, omega)(a), field)
    assert torch.equal(y.reshape(-1, 16), plan(a))


@pytest.mark.parametrize("k", [4, 9, 12])
@pytest.mark.parametrize("name", ["Fq", "Fp", "FrBn"])
def test_mr_plan_matches_jax_radix2(name, k):
    jfield = JFIELDS[name]
    field = field_of(name)
    a = mont_input(1 << k, seed=100 + k)
    got = MrNttPlan(field, k, omega_for(field, k))(limbs_tensor(a))
    # eagerly: the per-op programs are shared by all three fields, where a
    # jit of the whole plan compiles anew for each
    with jax.disable_jit():
        want = JNttPlan(jfield, k, omega_for(jfield, k))(jnp.asarray(a))
    assert canon_t(got, field) == canon_j(want, jfield)


def test_mr_plan_second_factor_above_2_8(monkeypatch):
    """Levels of f = 8 at k = 12 give g = 512, 64, 8, 1: inter-twiddle
    periods above 2^8, the case of the JAX comment at ntt_pallas.py:377-380,
    against the port's radix-2 plan and the inverse."""
    monkeypatch.setattr(MrNttPlan, "MAX_LOG_F", 3)
    field = field_of("Fq")
    k = 12
    omega = omega_for(field, k)
    plan = MrNttPlan(field, k, omega)
    assert [lv["g"] for lv in plan.levels] == [512, 64, 8, 1]
    a = limbs_tensor(mont_input(1 << k, seed=3))
    y = plan(a)
    assert canon_t(y, field) == canon_t(NttPlan(field, k, omega)(a), field)
    ctx = FieldCtx(field)
    back = ctx.mul(MrNttPlan(field, k, pow(omega, -1, field.MODULUS))(y),
                   ctx.const(pow(1 << k, -1, field.MODULUS), "cpu"))
    assert canon_t(back, field) == canon_t(a, field)


_PALLAS_SNIPPET = textwrap.dedent(
    """
    import json, os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, {repo!r})
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from halo2_tpu.fields import Fq
    from halo2_tpu.ops.field_jax import FieldCtx
    from halo2_tpu.ops.ntt_pallas import PallasNttPlan

    k = {k}
    a = np.asarray(json.loads(sys.stdin.read()), dtype=np.uint32)
    omega = pow(Fq.ROOT_OF_UNITY, 1 << (Fq.S - k), Fq.MODULUS)
    out = PallasNttPlan(Fq, k, omega)(jnp.asarray(a))
    print(json.dumps([str(v) for v in FieldCtx(Fq).decode_ints(out)]))
    """
)


def test_mr_plan_matches_pallas_interpret():
    """The JAX package's PallasNttPlan itself (interpret mode, its CPU mode)
    at k = 4, in a fresh process as tests/test_ntt_pallas.py runs it."""
    k = 4
    a = mont_input(1 << k, seed=44)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", _PALLAS_SNIPPET.format(repo=ROOT, k=k)],
                         input=json.dumps(a.tolist()), capture_output=True, text=True,
                         timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    want = [int(v) for v in json.loads(res.stdout.strip().splitlines()[-1])]
    field = field_of("Fq")
    got = MrNttPlan(field, k, omega_for(field, k))(limbs_tensor(a))
    assert canon_t(got, field) == want


@pytest.mark.parametrize("value,cls", [(None, CgNttPlan), ("auto", CgNttPlan), ("cg", CgNttPlan),
                                       ("pallas2", CgNttPlan), ("pallas", MrNttPlan),
                                       ("mxu", MxuNttPlan), ("jnp", NttPlan)])
def test_get_plan_follows_ntt_switch(value, cls, monkeypatch):
    if value is None:
        monkeypatch.delenv("NTT", raising=False)
    else:
        monkeypatch.setenv("NTT", value)
    field = field_of("Fq")
    assert type(get_plan(field, 5, omega_for(field, 5))) is cls


@pytest.mark.parametrize("value", ["", "Pallas", "radix2", "cuda"])
def test_get_plan_rejects_unknown_engine(value, monkeypatch):
    monkeypatch.setenv("NTT", value)
    field = field_of("Fq")
    with pytest.raises(ValueError, match="NTT="):
        get_plan(field, 5, omega_for(field, 5))


def edge_mont(field, n: int, seed: int) -> torch.Tensor:
    """(n, 16) Montgomery limbs: 0, 1, p - 1 and 2p - 1 (the ends of the lazy
    domain [0, 2p)) first, uniform values below 2p after them."""
    p = field.MODULUS
    rng = np.random.default_rng(seed)
    vals = [0, 1, p - 1, 2 * p - 1] + [int.from_bytes(rng.bytes(32), "little") % (2 * p)
                                       for _ in range(n - 4)]
    return torch.as_tensor(ints_to_limbs(vals))


@pytest.mark.gpu
def test_mr_level_kernel_matches_plain_on_card():
    """Every level of both plans, bit for bit (raw limbs), on edge inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    for name, log_n in (("Fp", 9), ("Fp", 10), ("Fp", 18), ("FrBn", 14)):
        field = field_of(name)
        ctx = FieldCtx(field)
        w = omega_for(field, log_n)
        for omega in (w, pow(w, -1, field.MODULUS)):
            plan = MrNttPlan(field, log_n, omega)
            for li, (lv, tab) in enumerate(zip(plan.levels, plan._tables("cuda"))):
                f, g = lv["f"], lv["g"]
                x = edge_mont(field, 1 << log_n, seed=log_n + li).to("cuda")
                x = x.reshape(-1, f, g, 16)
                got = ntt_mr.mr_col_ntt(x, tab["stw"], tab["inter"], ctx, tab["perm"])
                want = ntt_mr.mr_col_ntt_plain(x, tab["stw"], tab["inter"], ctx, tab["perm"])
                torch.cuda.synchronize()
                assert torch.equal(got, want), f"{name} 2^{log_n} level {li}"


@pytest.mark.gpu
def test_pallas_transform_equals_cg_transform_on_card():
    """The 2^14 NTT=pallas transform (kernel 8's levels) gives kernel 1's
    transform's canonical values, on edge inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    field = field_of("Fp")
    ctx = FieldCtx(field)
    a = edge_mont(field, 1 << 14, seed=14).to("cuda")
    omega = omega_for(field, 14)
    got = MrNttPlan(field, 14, omega)(a)
    want = CgNttPlan(field, 14, omega)(a)
    assert torch.equal(from_mont(got, ctx), from_mont(want, ctx))
