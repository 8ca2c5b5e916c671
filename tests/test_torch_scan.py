"""Kernel C (ops/scan.py, csrc/scan.cu): prefix products and batch inversion.

On the CPU: the plain versions equal the JAX package's `prefix_product`,
`exclusive_prefix_product` (with and without init) and `batch_invert` as
values on Fp, Fq and FrBn, at an n that is not a power of two, with the
values 0, p (both zeros), 1, p - 1 and 2p - 1 in the first rows; the
launch's preparation; CPU tensors take the plain versions and launch
nothing, other devices raise. On the card (`gpu`): the kernel equals its
plain version as values, its output in [0, 2p), at a tile's rows - 1, + 0
and + 1 and at more than 32 tiles, also after replays of a CUDA graph.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_tpu.fields import Fp as JFp, Fq as JFq, FrBn as JFrBn
from halo2_tpu.ops import field_jax as fj
from halo2_tpu.ops import scan as jscan
from halo2_tpu_torch.fields import Fp, Fq, FrBn
from halo2_tpu_torch.ops import field as fo
from halo2_tpu_torch.ops import scan
from chip_smoke import replayed

torch.set_num_threads(2)

FIELDS = [(Fp, JFp), (Fq, JFq), (FrBn, JFrBn)]
IDS = ["Fp", "Fq", "FrBn"]


def lazy_vals(p: int, n: int, seed: int):
    """0, p, 1, p - 1 and 2p - 1, then values uniform below 2p."""
    rng = np.random.default_rng(seed)
    return ([0, p, 1, p - 1, 2 * p - 1]
            + [int.from_bytes(rng.bytes(40), "little") % (2 * p) for _ in range(n - 5)])[:n]


def limbs(vals, device="cpu"):
    return torch.as_tensor(fo.ints_to_limbs(vals), device=device)


def values(t, F):
    return fo.FieldCtx(F).decode_ints(t)


@pytest.mark.parametrize("F,JF", FIELDS, ids=IDS)
def test_plain_scans_match_jax(F, JF):
    p = F.MODULUS
    vals = lazy_vals(p, 21, 1)
    init = lazy_vals(p, 7, 2)[-1]
    tctx, jctx = fo.FieldCtx(F), fj.FieldCtx(JF)
    t, j = limbs(vals), jnp.asarray(fo.ints_to_limbs(vals).astype(np.uint32))
    ti, ji = limbs([init])[0], jnp.asarray(fo.ints_to_limbs([init])[0].astype(np.uint32))
    cases = [
        (scan.prefix_product_plain(t, tctx), jscan.prefix_product(j, jctx)),
        (scan.exclusive_prefix_product_plain(t, tctx), jscan.exclusive_prefix_product(j, jctx)),
        (scan.exclusive_prefix_product_plain(t, tctx, ti), jscan.exclusive_prefix_product(j, jctx, ji)),
        (scan.batch_invert_plain(t, tctx), jscan.batch_invert(j, jctx)),
    ]
    for got, want in cases:
        assert values(got, F) == jctx.decode_ints(want)
    inv = values(cases[-1][0], F)
    assert inv[:2] == [0, 0]  # 0 and p
    assert all(v * x % p == 1 for v, x in zip(inv[2:], values(t, F)[2:]))


@pytest.mark.parametrize("n", [1, 8, 9, 45])
def test_launch_args(n):
    vals = limbs(lazy_vals(Fp.MODULUS, n, 3)).t().contiguous().t()  # limb stride n
    init = limbs([5])
    rows, row, tiles = scan.launch_args(vals, init)
    assert rows.is_contiguous() and torch.equal(rows, vals)
    assert row.shape == (16,) and torch.equal(row, init[0])
    assert tiles == -(-n // scan.TILE_ROWS)
    assert scan.launch_args(vals.to(torch.int64))[0].dtype == torch.int32
    with pytest.raises(ValueError, match="expected"):
        scan.launch_args(vals[None])
    with pytest.raises(ValueError, match="init"):
        scan.launch_args(vals, limbs([1, 2]))


def test_cpu_tensors_take_the_plain_version():
    ctx = fo.FieldCtx(Fq)
    t = limbs(lazy_vals(Fq.MODULUS, 20, 4))
    before = dict(scan.LAUNCHES)
    assert torch.equal(scan.prefix_product(t, ctx), scan.prefix_product_plain(t, ctx))
    assert torch.equal(scan.exclusive_prefix_product(t, ctx, t[3]),
                       scan.exclusive_prefix_product_plain(t, ctx, t[3]))
    assert torch.equal(scan.batch_invert(t, ctx), scan.batch_invert_plain(t, ctx))
    assert scan.LAUNCHES == before
    meta = torch.empty((4, 16), dtype=torch.int32, device="meta")
    for fn in (scan.prefix_product, scan.exclusive_prefix_product, scan.batch_invert):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(meta, ctx)


@pytest.mark.gpu
def test_kernel_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    T = scan.TILE_ROWS
    for F in (Fp, Fq, FrBn):
        p, ctx = F.MODULUS, fo.FieldCtx(F)
        for n in (1, 9, 1000, T - 1, T, T + 1, (1 << 12) + 5, 33 * T + 5):
            x = limbs(lazy_vals(p, n, n), "cuda")
            init = limbs([3 * p // 2], "cuda")[0]
            for mode, kern, plain, extra in (
                    ("inclusive", scan.prefix_product, scan.prefix_product_plain, ()),
                    ("exclusive", scan.exclusive_prefix_product, scan.exclusive_prefix_product_plain, ()),
                    ("exclusive", scan.exclusive_prefix_product, scan.exclusive_prefix_product_plain, (init,)),
                    ("invert", scan.batch_invert, scan.batch_invert_plain, ())):
                before = scan.LAUNCHES["scan"]
                got = kern(x, ctx, *extra)
                torch.cuda.synchronize()
                assert scan.LAUNCHES["scan"] == before + scan.KERNELS_PER_CALL[mode]
                want = values(plain(x, ctx, *extra), F)
                assert values(got, F) == want, (F.__name__, n, kern)
                assert max(fo.limbs_to_ints(got)) < 2 * p
                if n in (T + 1, 33 * T + 5):
                    for out in replayed(lambda: kern(x, ctx, *extra)):
                        assert values(out, F) == want, (F.__name__, n, kern, "replay")
