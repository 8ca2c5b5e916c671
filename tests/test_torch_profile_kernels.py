"""Kernels 9 and 10 (halo2_tpu_torch.ops.tile_bench) and the port's
kernel-profiling tool (halo2_tpu_torch.tools.profile_kernels) on the CPU.

The plain versions of `tile_mul` and `tile_padd` are held to the JAX
package's Pallas helpers called as plain jnp functions on (16, W) tiles:
`ntt_pallas._mont_mul` chained 8 times (the body of the TPU tool's
`mul_kernel`) and `msm_pallas._mixed_padd` (its `padd_kernel`), on the same
canonical inputs, exactly on canonical values. Every section of the tool
runs with `--device cpu` at a tiny size. The kernels are held to their plain
versions on the card by the `gpu` test below and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_tpu.curves import Pallas as JPallas
from halo2_tpu.ops.field_jax import FieldCtx as JFieldCtx
from halo2_tpu.ops.msm_pallas import _consts5, _mixed_padd
from halo2_tpu.ops.ntt_pallas import _mont_mul
from halo2_tpu_torch.curves import Pallas
from halo2_tpu_torch.interop import limbs_tensor
from halo2_tpu_torch.ops import tile_bench
from halo2_tpu_torch.ops.curve import CurveCtx
from halo2_tpu_torch.ops.field import from_mont, limbs_to_ints
from halo2_tpu_torch.tools import profile_kernels

torch.set_num_threads(2)

N = 64


def canonical(seed: int, count: int):
    """count arrays of N values below 2^254 (< p) as (N, 16) uint32 limbs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        limbs = rng.integers(0, 1 << 16, (N, 16), dtype=np.uint32)
        limbs[:, 15] &= 0x3FFF
        out.append(limbs)
    return out


def canon_j(tile) -> list:
    """(16, W) JAX tile -> canonical ints."""
    return JFieldCtx(JPallas.BASE).decode_ints(jnp.asarray(tile).T)


def canon_t(x) -> list:
    return limbs_to_ints(from_mont(x, CurveCtx(Pallas).fctx))


def test_tile_mul_plain_matches_jax_mont_mul_chain():
    a, b = canonical(1, 2)
    consts = _consts5(JPallas)

    @jax.jit
    def chain(a, b):
        o = a
        for _ in range(tile_bench.MULS_PER_ELEMENT):
            o = _mont_mul(o, b, consts[0][:, None], consts[1][:, None])
        return o

    want = chain(jnp.asarray(a.T), jnp.asarray(b.T))
    got = tile_bench.tile_mul(limbs_tensor(a), limbs_tensor(b), CurveCtx(Pallas).fctx)
    assert canon_t(got) == canon_j(want)


def test_tile_padd_plain_matches_jax_mixed_padd():
    coords = canonical(2, 5)
    consts = _consts5(JPallas)

    @jax.jit
    def padd(x1, y1, z1, x2, y2):
        return _mixed_padd((x1, y1, z1), (x2, y2), consts[0][:, None], consts[1][:, None],
                           consts[2][:, None], consts[3][:, None])

    want = padd(*(jnp.asarray(c.T) for c in coords))
    got = tile_bench.tile_padd(*(limbs_tensor(c) for c in coords), CurveCtx(Pallas))
    for g, w in zip(got, want):
        assert canon_t(g) == canon_j(w)


@pytest.mark.parametrize("argv,expect", [
    (["tilemul", "32"], "ns per element product"),
    (["msm_accum", "5"], "lane_reduce first call"),
    (["ntt_compile", "4", "6"], "k=6: set-up"),
    (["sortgather", "8"], "GB/s"),
    (["oplat", "3"], "cycles per operation"),
])
def test_profile_sections_run_on_cpu(argv, expect, capsys):
    profile_kernels.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("device: cpu\n")
    assert expect in out


def test_profile_tool_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_kernels.main(["tilemul", "32"])


def test_tilemul_section_returns_plain_results():
    res = profile_kernels.tilemul(16, device=torch.device("cpu"), iters=1)
    ctx = CurveCtx(Pallas).fctx
    assert torch.equal(res["mul_out"], tile_bench.tile_mul_plain(res["a"], res["b"], ctx))
    assert res["ns_per_product"] > 0 and res["ns_per_point"] > 0


def test_op_chain_plain_matches_host_arithmetic():
    """The latency probe's plain chains: x <- x * b / R, x + b, x - b mod p."""
    ctx = CurveCtx(Pallas).fctx
    p = ctx.p_int
    a, b = (limbs_tensor(c)[0] for c in canonical(2, 2))
    ia, ib = (limbs_to_ints(from_mont(t[None], ctx))[0] for t in (a, b))
    want = {"fe_mul": ia * ib ** 3 % p, "fe_add_cc": (ia + 3 * ib) % p, "fe_sub": (ia - 3 * ib) % p}
    for op, value in want.items():
        got = tile_bench.op_chain_plain(a, b, 3, op, ctx)
        assert limbs_to_ints(from_mont(got[None], ctx))[0] == value
    assert tile_bench.op_chain(a, b, 3, "fe_mul_cc", ctx)[1] is None


@pytest.mark.gpu
def test_op_chain_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    lat = profile_kernels.oplat(64, device=torch.device("cuda"))  # checks each op against plain
    assert all(c > 0 for c in lat.values())


@pytest.mark.gpu
def test_tile_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    cc = CurveCtx(Pallas)
    coords = [limbs_tensor(c, "cuda") for c in canonical(3, 5)]
    got = tile_bench.tile_mul(coords[0], coords[1], cc.fctx)
    want = tile_bench.tile_mul_plain(coords[0], coords[1], cc.fctx)
    torch.cuda.synchronize()
    assert torch.equal(from_mont(got, cc.fctx), from_mont(want, cc.fctx))
    for g, w in zip(tile_bench.tile_padd(*coords, cc), tile_bench.tile_padd_plain(*coords, cc)):
        assert torch.equal(from_mont(g, cc.fctx), from_mont(w, cc.fctx))
