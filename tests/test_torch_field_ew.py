"""Kernel A (ops/field_ew.py, csrc/field_ew.cu): the elementwise Montgomery
product, sum and difference behind ops/field.py's mont_mul, add_mod and
sub_mod on the card.

On the CPU: the launch's preparation (the broadcast shape collapsed to at
most four dimensions, each operand's element strides) modelled with
torch.as_strided equals the broadcast plain result bit for bit, for every
broadcast pattern the prover gives the kernel; the plain versions equal the
JAX package's mont_mul / add_mod / sub_mod limb for limb on seeded inputs
with the edge values 0, 1, p - 1 and 2p - 1 of all four moduli; CPU tensors
take the plain versions and launch nothing. On the card (`gpu`): the kernel
equals its plain version bit for bit on the same patterns and values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_tpu.fields import Fp as JFp, Fq as JFq, FqBn as JFqBn, FrBn as JFrBn
from halo2_tpu.ops import field_jax as fj
from halo2_tpu_torch.fields import Fp, Fq, FqBn, FrBn
from halo2_tpu_torch.ops import field as fo
from halo2_tpu_torch.ops import field_ew

torch.set_num_threads(2)

FIELDS = [(Fp, JFp), (Fq, JFq), (FrBn, JFrBn), (FqBn, JFqBn)]
OPS = ("mont_mul", "add_mod", "sub_mod")
PLAIN = {"mont_mul": fo.mont_mul_plain, "add_mod": fo.add_mod_plain, "sub_mod": fo.sub_mod_plain}


def lazy_vals(p: int, n: int, seed: int):
    """The edge values 0, 1, p - 1, 2p - 1 of the lazy domain, then values
    uniform below 2p."""
    rng = np.random.default_rng(seed)
    return [0, 1, p - 1, 2 * p - 1] + [int.from_bytes(rng.bytes(40), "little") % (2 * p)
                                       for _ in range(n - 4)]


def limbs(vals, shape=None, device="cpu"):
    t = torch.as_tensor(fo.ints_to_limbs(vals), device=device)
    return t if shape is None else t.reshape(*shape, 16)


def patterns(p: int, device="cpu"):
    """(name, a, b) for each kind of operand pair the prover hands the
    kernel: equal shapes, the Hillis-Steele slices out[d:] against s[:-d],
    an (M, n) product, an unsqueezed row against (B, L), a (16,) scalar on
    either side, limbs that are not contiguous, and more than four
    dimensions that do not merge."""
    x = limbs(lazy_vals(p, 96, 1))
    y = limbs(lazy_vals(p, 96, 2)[::-1])
    m = limbs(lazy_vals(p, 3 * 40, 3), (3, 40))
    rows = limbs(lazy_vals(p, 6, 4), (6,))
    table = limbs(lazy_vals(p, 6 * 8, 5), (6, 8))
    deep_a = limbs(lazy_vals(p, 2 * 3 * 5 * 2, 6), (2, 1, 3, 1, 5, 2))
    deep_b = limbs(lazy_vals(p, 4 * 6 * 2, 7), (1, 4, 1, 6, 1, 2))
    strided = limbs(lazy_vals(p, 16, 8)).t().contiguous().t()  # limb stride 16
    cases = [
        ("same", x, y),
        ("slices", x[3:], y[:-3]),
        ("stacked", m, limbs(lazy_vals(p, 3 * 40, 9), (3, 40))),
        ("unsqueeze", rows.unsqueeze(-2), table),
        ("scalar_right", x, y[5]),
        ("scalar_left", y[7], x),
        ("strided_limbs", strided, x[:16]),
        ("six_dims", deep_a, deep_b),
        ("expanded", x[:8].unsqueeze(0).expand(5, 8, 16), m[:, :8].reshape(3, 8, 16)[:1]),
    ]
    return [(name, a.to(device), b.to(device)) for name, a, b in cases]


PATTERNS = [name for name, _, _ in patterns(Fp.MODULUS)]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_launch_args_model_the_broadcast(pattern, op):
    ctx = fo.FieldCtx(Fp)
    _, a, b = next(c for c in patterns(Fp.MODULUS) if c[0] == pattern)
    shape, at, bt, sizes, sa, sb = field_ew.launch_args(a, b)
    assert shape == tuple(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]))
    assert len(sizes) == field_ew.MAX_DIMS == len(sa) == len(sb)
    assert all(s % 4 == 0 for s in sa + sb)  # 16-byte vectors at every element
    if pattern not in ("strided_limbs", "six_dims"):
        # a broadcast operand is read where it lies: no copy
        assert at.data_ptr() == a.data_ptr() and bt.data_ptr() == b.data_ptr()
    view_a = torch.as_strided(at, sizes + (16,), sa + (1,), at.storage_offset())
    view_b = torch.as_strided(bt, sizes + (16,), sb + (1,), bt.storage_offset())
    got = PLAIN[op](view_a, view_b, ctx).reshape(*shape, 16)
    want = PLAIN[op](*torch.broadcast_tensors(a, b), ctx)
    assert torch.equal(got, want)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("F,JF", FIELDS, ids=["Fp", "Fq", "FrBn", "FqBn"])
def test_plain_ops_match_jax_on_edge_values(F, JF, op):
    """Limb for limb, every pair of the edge values and uniform values;
    where a + b reaches 2^256 the JAX package's add_mod loses the carry (a
    known departure of the port), so the port is held to host integers."""
    p = F.MODULUS
    vals_a = lazy_vals(p, 20, 11)
    vals_b = lazy_vals(p, 20, 12)
    pairs = [(x, y) for x in vals_a[:4] + vals_a[4:8] for y in vals_b[:4] + vals_b[4:8]]
    pairs += list(zip(vals_a, vals_b[::-1]))
    a = np.stack([fo.int_to_limbs(x) for x, _ in pairs])
    b = np.stack([fo.int_to_limbs(y) for _, y in pairs])
    jctx, tctx = fj.FieldCtx(JF), fo.FieldCtx(F)
    got = PLAIN[op](torch.as_tensor(a), torch.as_tensor(b), tctx)
    want = np.asarray(getattr(fj, op)(jnp.asarray(a.astype(np.uint32)),
                                      jnp.asarray(b.astype(np.uint32)), jctx))
    got_ints, want_ints = fo.limbs_to_ints(got), fo.limbs_to_ints(want.astype(np.int32))
    for (x, y), g, w in zip(pairs, got_ints, want_ints):
        if op == "add_mod" and x + y >= 1 << 256:
            assert g == x + y - 2 * p
        else:
            assert g == w, (hex(x), hex(y))
        assert g < 1 << 256
    if op == "mont_mul":  # the product's integer: (a b + M p) / 2^256, M = -a b / p mod 2^256
        for (x, y), g in zip(pairs, got_ints):
            m = (-x * y * pow(p, -1, 1 << 256)) % (1 << 256)
            assert g == (x * y + m * p) >> 256


@pytest.mark.parametrize("op", OPS)
def test_cpu_tensors_take_the_plain_version(op):
    ctx = fo.FieldCtx(Fq)
    before = dict(field_ew.LAUNCHES)
    for _, a, b in patterns(Fq.MODULUS):
        assert torch.equal(getattr(fo, op)(a, b, ctx), PLAIN[op](a, b, ctx))
    assert field_ew.LAUNCHES == before
    meta = torch.empty((4, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(fo, op)(meta, meta, ctx)


@pytest.mark.gpu
def test_kernel_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    for F, _ in FIELDS:
        ctx = fo.FieldCtx(F)
        for name, a, b in patterns(F.MODULUS, "cuda"):
            for op in OPS:
                before = field_ew.LAUNCHES[op]
                got = getattr(fo, op)(a, b, ctx)
                torch.cuda.synchronize()
                assert field_ew.LAUNCHES[op] == before + 1
                assert torch.equal(got, PLAIN[op](a, b, ctx)), (F.__name__, name, op)
