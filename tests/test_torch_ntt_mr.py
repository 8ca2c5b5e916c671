"""The port's mixed-radix NTT (halo2_tpu_torch.ops.ntt_mr, the NTT=pallas
engine) and the engine switch `get_plan`, against the JAX package on the CPU.

On a CPU tensor `mr_col_ntt` runs its plain torch version, so these tests
drive the level tables, the bit reversal, the stages and the inter-level
twiddles that kernel 8 sits in. The tables must equal those of the JAX
package's `PallasNttPlan` (read host-side: building that plan compiles
nothing), one level must equal the same level computed with the JAX
package's field ops, and whole transforms must equal the JAX radix-2
`NttPlan` and, in a subprocess, `PallasNttPlan` itself in interpret mode.
Comparisons are exact on canonical values. The kernel is held against the
plain version on the card by the `gpu` test below and by chip_smoke.py.
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
from halo2_tpu_torch.ops.field import FieldCtx, from_mont, limbs_to_ints
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


@pytest.mark.parametrize("name,k,level", [("Fq", 10, 0), ("FrBn", 10, 1)])
def test_level_plain_matches_jax_field_ops(name, k, level):
    jfield = JFIELDS[name]
    field = field_of(name)
    jlv = JPallasNttPlan(jfield, k, omega_for(jfield, k)).levels[level]
    lv = MrNttPlan(field, k, omega_for(field, k)).levels[level]
    f, g = lv["f"], lv["g"]
    x = mont_input((1 << k), seed=k + level).reshape(-1, f, 16)
    jinter = None
    if jlv["inter"] is not None:
        jinter = jnp.transpose(jlv["inter"], (2, 0, 1))[:g]
    want = jax.jit(_jax_level, static_argnums=4)(jnp.asarray(x), jlv["stw"], jlv["perm"], jinter, jfield)
    inter = None if lv["inter"] is None else torch.as_tensor(lv["inter"])
    got = ntt_mr.mr_col_ntt(limbs_tensor(x), torch.as_tensor(lv["stw"]), inter, FieldCtx(field))
    assert got.shape == x.shape
    assert canon_t(got, field) == canon_j(want, jfield)


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


@pytest.mark.gpu
def test_mr_level_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    for name, log_n in (("Fp", 10), ("Fp", 18), ("FrBn", 14)):
        field = field_of(name)
        ctx = FieldCtx(field)
        plan = MrNttPlan(field, log_n, omega_for(field, log_n))
        for lv, tab in zip(plan.levels, plan._tables("cuda")):
            x = limbs_tensor(mont_input(1 << log_n, seed=log_n), "cuda").reshape(-1, lv["f"], 16)
            got = ntt_mr.mr_col_ntt(x, tab["stw"], tab["inter"], ctx)
            want = ntt_mr.mr_col_ntt_plain(x, tab["stw"], tab["inter"], ctx)
            torch.cuda.synchronize()
            assert torch.equal(from_mont(got.reshape(-1, 16), ctx),
                               from_mont(want.reshape(-1, 16), ctx))
