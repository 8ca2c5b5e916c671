"""The port's Toeplitz Montgomery product and NTT (halo2_tpu_torch.ops.mxu_mont,
the NTT=mxu engine) against the JAX package on the CPU.

On a CPU tensor every contraction is an exact int64 matrix product. The
int8 route (`torch._int_mm`, which this CPU build has) is also held to it
here, with its row padding and its one product per constant; the bf16 route
(a float32-output product, not built for the CPU) and both card routes are
held to the int64 version on the card, by the `gpu` test below and by
chip_smoke.py. Comparisons are exact on canonical values.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_tpu.fields import Fp as JFp, Fq as JFq
from halo2_tpu.ops.field_jax import FieldCtx as JFieldCtx
from halo2_tpu.ops.mxu_mont import mont_mul_const as jmont_mul_const
from halo2_tpu.ops.ntt import NttPlan as JNttPlan
from halo2_tpu_torch.interop import field_of, limbs_tensor
from halo2_tpu_torch.ops import mxu_mont
from halo2_tpu_torch.ops.field import FieldCtx, from_mont, limbs_to_ints
from halo2_tpu_torch.ops.mxu_mont import MxuNttPlan, mont_mul_const

torch.set_num_threads(2)


def edge_values(p: int, seed: int):
    rng = random.Random(seed)
    vals = [rng.randrange(p) for _ in range(64)]
    vals[:4] = [0, 1, p - 1, (1 << 255) % p]  # the edge values of tests/test_mxu_mont.py
    return vals, rng.randrange(p)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("jfield", [JFp, JFq], ids=["Fp", "Fq"])
def test_mont_mul_const_matches_jax(jfield, dtype, monkeypatch):
    monkeypatch.setenv("MXU_DTYPE", dtype)
    field = field_of(jfield)
    ctx, jctx = FieldCtx(field), JFieldCtx(jfield)
    p = field.MODULUS
    vals, c = edge_values(p, seed=0xC0FFEE + (dtype == "int8"))
    c_mont = c * ctx.r_int % p
    got = ctx.decode_ints(mont_mul_const(field, ctx.encode_ints(vals, "cpu"), c_mont))
    want = jctx.decode_ints(jmont_mul_const(jfield, jctx.encode_ints(vals), c_mont))
    assert got == want == [v * c % p for v in vals]


@pytest.mark.parametrize("k", [6, 10])
def test_mxu_plan_matches_jax_radix2(k):
    field = field_of(JFq)
    p = field.MODULUS
    omega = pow(field.ROOT_OF_UNITY, 1 << (field.S - k), p)
    limbs = np.random.default_rng(k).integers(0, 1 << 16, (1 << k, 16), dtype=np.uint32)
    limbs[:, 15] &= 0x3FFF
    got = MxuNttPlan(field, k, omega)(limbs_tensor(limbs))
    want = JNttPlan(JFq, k, omega)(jnp.asarray(limbs))
    assert limbs_to_ints(from_mont(got, FieldCtx(field))) == JFieldCtx(JFq).decode_ints(want)


@pytest.mark.parametrize("batched", [False, True])
def test_int8_contraction_equals_int64(batched):
    """The int8 route: rows padded for torch._int_mm, columns to 128, one
    product per constant of a batch, against the int64 product."""
    rng = np.random.default_rng(7)
    consts = [int.from_bytes(rng.bytes(32), "little") for _ in range(3 if batched else 1)]
    tables = [mxu_mont.toeplitz(c, mxu_mont.NCOLS) for c in consts]
    op = mxu_mont._Operand(np.stack(tables) if batched else tables[0])
    x = torch.as_tensor(rng.integers(0, 17, (5, len(consts), mxu_mont.NNIB)))
    if not batched:
        x = x[:, 0]
    got = mxu_mont._contract(x, op, "int8")
    assert got.shape[-1] == mxu_mont.NCOLS
    assert torch.equal(got, mxu_mont._contract(x, op))


def test_mxu_dtype_rejects_unknown(monkeypatch):
    monkeypatch.setenv("MXU_DTYPE", "fp8")
    with pytest.raises(ValueError, match="MXU_DTYPE"):
        mxu_mont.mxu_dtype()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_mxu_plan_exact_on_card(dtype, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bf16 and int8 products run only there")
    monkeypatch.setenv("MXU_DTYPE", dtype)
    field = field_of(JFq)
    k = 12
    omega = pow(field.ROOT_OF_UNITY, 1 << (field.S - k), field.MODULUS)
    limbs = np.random.default_rng(k).integers(0, 1 << 16, (1 << k, 16), dtype=np.uint32)
    limbs[:, 15] &= 0x3FFF
    a = limbs_tensor(limbs)
    plan = MxuNttPlan(field, k, omega)
    got = plan(a.cuda())
    torch.cuda.synchronize()
    assert torch.equal(from_mont(got.cpu(), FieldCtx(field)), from_mont(plan(a), FieldCtx(field)))
