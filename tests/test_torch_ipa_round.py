"""Kernel F (ops/ipa_round.py, csrc/ipa_round.cu): the rounds of an IPA
opening.

On the CPU: the plain versions equal the JAX package's round pair from
`halo2_tpu.poly.ipa._ipa_round_fns(field, 32)` as values on Fp, Fq and
FrBn for every m from 32 down to 2, each round on the previous round's
fold (the pair is shape-stable, so it compiles once a field, here as one
program), and the fused round (a fold at m, then the emit at m / 2) equals
the JAX fold followed by the JAX emit for every m from 32 down to 4; the
launch's preparation; CPU tensors take the plain versions and launch
nothing, other devices raise. On the card (`gpu`): each entry point is one
launch and equals its plain version as values, its outputs in [0, 2p),
also after replays of a CUDA graph and on two streams at once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_tpu.fields import Fp as JFp, Fq as JFq, FrBn as JFrBn
from halo2_tpu.ops import field_jax as fj
from halo2_tpu.poly.ipa import _ipa_round_fns
from halo2_tpu_torch.fields import Fp, Fq, FrBn
from halo2_tpu_torch.ops import field as fo
from halo2_tpu_torch.ops import ipa_round

torch.set_num_threads(2)

FIELDS = [(Fp, JFp), (Fq, JFq), (FrBn, JFrBn)]
IDS = ["Fp", "Fq", "FrBn"]
N = 32


def lazy_vals(p: int, n: int, seed: int):
    """0, p, p - 1 and 2p - 1, then values uniform below 2p."""
    rng = np.random.default_rng(seed)
    return ([0, p, p - 1, 2 * p - 1]
            + [int.from_bytes(rng.bytes(40), "little") % (2 * p) for _ in range(n - 4)])[:n]


def limbs(vals, device="cpu"):
    return torch.as_tensor(fo.ints_to_limbs(vals), device=device)


def jax_limbs(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def values(t, F):
    return fo.FieldCtx(F).decode_ints(t.reshape(-1, 16))


def operands(F, n, seed, device="cpu"):
    """p', b, s_mult (n, 16), z (16,), the blinding scalars (2, 16), u and
    u^-1 (16,) each: lazy values, u^-1 the inverse of u's value."""
    p, ctx = F.MODULUS, fo.FieldCtx(F)
    pp, b, s = (limbs(lazy_vals(p, n, seed + i), device) for i in range(3))
    z, r0, r1 = limbs(lazy_vals(p, 7, seed + 3)[-3:], device)
    u = 0x1234567 + seed
    return pp, b, s, z, torch.stack([r0, r1]), ctx.const(u, device), ctx.const(pow(u, -1, p), device)


@functools.lru_cache(maxsize=None)
def jax_rounds(i: int):
    """Every round of a 32-lane opening on FIELDS[i], m = 32 down to 2, each
    on the port's plain fold of the round before: (the operands z, rands, u,
    u^-1, and for each m its inputs p', b, s_mult with the JAX package's emit
    and fold of them as values). The JAX pair compiles once a field, as one
    program; the tests that read it share it."""
    F, JF = FIELDS[i]
    emit, fold = _ipa_round_fns(JF, N)
    jctx = fj.FieldCtx(JF)

    @jax.jit
    def round_pair(pp, b, s, mrow, z, rands, uu):
        return emit(pp, b, s, mrow, z, rands), fold(pp, b, s, mrow, uu)

    tctx = fo.FieldCtx(F)
    pp, b, s, z, rands, u, uinv = operands(F, N, 1)
    rounds = {}
    m = N
    while m >= 2:
        mrow = jnp.zeros(16, jnp.uint32).at[0].set(m)
        want_scal, want_fold = round_pair(*map(jax_limbs, (pp, b, s)), mrow, jax_limbs(z), jax_limbs(rands),
                                          jax_limbs(torch.stack([u, uinv])))
        rounds[m] = ((pp, b, s), jctx.decode_ints(want_scal.reshape(-1, 16)),
                     [jctx.decode_ints(w) for w in want_fold])
        pp, b, s = ipa_round.round_fold_plain(pp, b, s, m, u, uinv, tctx)
        m //= 2
    return (z, rands, u, uinv), rounds


@pytest.mark.parametrize("i", range(len(FIELDS)), ids=IDS)
def test_plain_rounds_match_jax(i):
    F = FIELDS[i][0]
    tctx = fo.FieldCtx(F)
    (z, rands, u, uinv), rounds = jax_rounds(i)
    for m, ((pp, b, s), want_scal, want_fold) in rounds.items():
        assert values(ipa_round.round_emit_plain(pp, b, s, m, z, rands, tctx), F) == want_scal, m
        folded = ipa_round.round_fold_plain(pp, b, s, m, u, uinv, tctx)
        for got, want in zip(folded, want_fold):
            assert values(got, F) == want, m


@pytest.mark.parametrize("i", range(len(FIELDS)), ids=IDS)
def test_plain_fold_emit_matches_jax(i):
    """round_fold_emit_plain at m against the JAX fold at m followed by the
    JAX emit at m / 2 (of the folded lanes), for m = 32 down to 4."""
    F = FIELDS[i][0]
    tctx = fo.FieldCtx(F)
    (z, rands, u, uinv), rounds = jax_rounds(i)
    for m in [m for m in rounds if m >= 4]:
        (pp, b, s), _, want_fold = rounds[m]
        *folded, scal = ipa_round.round_fold_emit_plain(pp, b, s, m, u, uinv, z, rands, tctx)
        assert values(scal, F) == rounds[m // 2][1], m
        for got, want in zip(folded, want_fold):
            assert values(got, F) == want, m


@pytest.mark.parametrize("m", [2, 8, 32])
def test_launch_args(m):
    pp, b, s, z, rands, u, uinv = operands(Fq, N, 2)
    n, blocks, tensors = ipa_round.launch_args(pp.t().contiguous().t(), b, s.to(torch.int64), m, z, rands)
    assert (n, blocks) == (N, 1)
    assert [tuple(t.shape) for t in tensors] == [(N, 16)] * 3 + [(16,), (2, 16)]
    assert all(t.dtype == torch.int32 and t.is_contiguous() for t in tensors)
    assert torch.equal(tensors[0], pp) and torch.equal(tensors[2], s)
    big = limbs(lazy_vals(Fq.MODULUS, 513, 3))
    assert ipa_round.launch_args(big, big, big, m)[:2] == (513, 5)  # blocks of 128 lanes
    with pytest.raises(ValueError, match="expected contiguous int32"):
        ipa_round.launch_args(big, b, s, m)
    for bad in (0, 1, 3, 2 * N):
        with pytest.raises(ValueError, match="power of two"):
            ipa_round.launch_args(pp, b, s, bad)


def test_cpu_tensors_take_the_plain_version():
    ctx = fo.FieldCtx(Fp)
    pp, b, s, z, rands, u, uinv = operands(Fp, N, 4)
    before = dict(ipa_round.LAUNCHES)
    assert torch.equal(ipa_round.round_emit(pp, b, s, 8, z, rands, ctx),
                       ipa_round.round_emit_plain(pp, b, s, 8, z, rands, ctx))
    for got, want in zip(ipa_round.round_fold(pp, b, s, 8, u, uinv, ctx),
                         ipa_round.round_fold_plain(pp, b, s, 8, u, uinv, ctx)):
        assert torch.equal(got, want)
    for got, want in zip(ipa_round.round_fold_emit(pp, b, s, 8, u, uinv, z, rands, ctx),
                         ipa_round.round_fold_emit_plain(pp, b, s, 8, u, uinv, z, rands, ctx)):
        assert torch.equal(got, want)
    assert ipa_round.LAUNCHES == before
    with pytest.raises(ValueError, match="no round to emit"):
        ipa_round.round_fold_emit(pp, b, s, 2, u, uinv, z, rands, ctx)
    meta = torch.empty((N, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ipa_round.round_emit(meta, meta, meta, 8, meta[0], meta[:2], ctx)
    with pytest.raises(ValueError, match="unsupported device"):
        ipa_round.round_fold(meta, meta, meta, 8, meta[0], meta[0], ctx)
    with pytest.raises(ValueError, match="unsupported device"):
        ipa_round.round_fold_emit(meta, meta, meta, 8, meta[0], meta[0], meta[0], meta[:2], ctx)


@pytest.mark.gpu
def test_kernel_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    from chip_smoke import replayed, two_streams

    for F in (Fp, Fq, FrBn):
        ctx, p = fo.FieldCtx(F), F.MODULUS
        for n in (2, 256, 1 << 12):
            pp, b, s, z, rands, u, uinv = operands(F, n, n, "cuda")
            m = n
            while m >= 2:
                before = ipa_round.LAUNCHES["ipa_round"]
                scal = ipa_round.round_emit(pp, b, s, m, z, rands, ctx)
                folded = ipa_round.round_fold(pp, b, s, m, u, uinv, ctx)
                fused = ipa_round.round_fold_emit(pp, b, s, m, u, uinv, z, rands, ctx) if m >= 4 else ()
                torch.cuda.synchronize()
                assert ipa_round.LAUNCHES["ipa_round"] == before + (3 if m >= 4 else 2)
                want_fold = ipa_round.round_fold_plain(pp, b, s, m, u, uinv, ctx)
                pairs = [(scal, ipa_round.round_emit_plain(pp, b, s, m, z, rands, ctx))]
                pairs += list(zip(folded, want_fold))
                if fused:
                    want_fused = (*want_fold, ipa_round.round_emit_plain(*want_fold, m // 2, z, rands, ctx))
                    pairs += list(zip(fused, want_fused))
                    for out in replayed(lambda: ipa_round.round_fold_emit(pp, b, s, m, u, uinv, z, rands,
                                                                          ctx)[3]):
                        pairs.append((out, want_fused[3]))
                    for out in two_streams(lambda: ipa_round.round_fold_emit(pp, b, s, m, u, uinv, z, rands,
                                                                             ctx)[3]):
                        pairs.append((out, want_fused[3]))
                for got, want in pairs:
                    assert values(got, F) == values(want, F), (F.__name__, n, m)
                    assert max(fo.limbs_to_ints(got.reshape(-1, 16))) < 2 * p
                pp, b, s = folded
                m //= 2
