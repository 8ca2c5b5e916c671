"""Kernels 9 and 10 (halo2_tpu_torch.ops.tile_bench) and the port's
kernel-profiling tool (halo2_tpu_torch.tools.profile_kernels) on the CPU.

The plain versions of `tile_mul` and `tile_padd` are held to the JAX
package's Pallas helpers called as plain jnp functions on (16, W) tiles:
`ntt_pallas._mont_mul` chained 8 times (the body of the TPU tool's
`mul_kernel`) and `msm_pallas._mixed_padd` (its `padd_kernel`), on the same
canonical inputs, exactly on canonical values. Every section of the tool
runs with `--device cpu` at a tiny size. The wrappers whose kernels load
16-byte vectors refuse a view that is not 16-byte aligned before any
launch. The kernels are held to their plain versions on the card by the
`gpu` tests below (ragged n, edge inputs, the Pasta and the generic forms)
and by chip_smoke.py.
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
from halo2_tpu_torch.curves import Bn254G1, Pallas, Vesta
from halo2_tpu_torch.fields import FrBn
from halo2_tpu_torch.interop import limbs_tensor
from halo2_tpu_torch.ops import _build, msm_bucket, msm_sorted, ntt_cg, ntt_mr, tile_bench
from halo2_tpu_torch.ops.curve import CurveCtx
from halo2_tpu_torch.ops.field import FieldCtx, from_mont, ints_to_limbs, limbs_to_ints
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
    assert torch.equal(got, want)  # bit for bit: fe_mul_cc gives fe_mul's integers
    for g, w in zip(tile_bench.tile_padd(*coords, cc), tile_bench.tile_padd_plain(*coords, cc)):
        assert torch.equal(from_mont(g, cc.fctx), from_mont(w, cc.fctx))


def misaligned(shape, offset=1):
    """A contiguous int32 view of `shape` that starts `offset` words into its
    storage (4 bytes past a 16-byte boundary for offset 1)."""
    numel = int(np.prod(shape))
    flat = torch.zeros(numel + 8, dtype=torch.int32)
    return flat[offset:offset + numel].view(shape)


@pytest.mark.parametrize("offset,aligned", [(0, True), (4, True), (1, False), (2, False), (3, False)])
def test_check_tensor_alignment(offset, aligned):
    view = misaligned((5, 16), offset)
    assert view.is_contiguous() and (view.data_ptr() % 16 == 0) == aligned
    _build.check_tensor(view, (5, 16), "v", view.device)  # no alignment asked: as before
    if aligned:
        _build.check_tensor(view, (5, 16), "v", view.device, align=16)
    else:
        with pytest.raises(ValueError, match="16-byte aligned"):
            _build.check_tensor(view, (5, 16), "v", view.device, align=16)


def _vector_wrapper_calls():
    """Each wrapper whose kernel loads 16-byte vectors, called on one
    misaligned input."""
    cc, ctx = CurveCtx(Pallas), CurveCtx(Pallas).fctx
    ok = torch.zeros((4, 16), dtype=torch.int32)
    bad = misaligned((4, 16))
    stw = torch.zeros((1, 1, 16), dtype=torch.int32)
    return {
        "tile_mul": lambda: tile_bench.tile_mul(ok, bad, ctx),
        "tile_padd": lambda: tile_bench.tile_padd(ok, ok, ok, ok, bad, cc),
        "op_chain": lambda: tile_bench.op_chain(misaligned((16,)), ok[0], 1, "fe_mul", ctx),
        "msm_fold": lambda: msm_bucket.msm_fold(misaligned((1, 1, 16, 3, 16)), CurveCtx(Vesta)),
        "cg_ntt_level": lambda: ntt_cg.cg_ntt_level(misaligned((1, 2, 1, 16)), stw, None, ctx),
        "mr_col_ntt": lambda: ntt_mr.mr_col_ntt(misaligned((1, 2, 1, 16)), stw, None, ctx),
        "msm_sorted_horner": lambda: msm_sorted.msm_sorted_horner(misaligned((16, 3, 16)), cc),
    }


@pytest.mark.parametrize("name", sorted(_vector_wrapper_calls()))
def test_vector_wrappers_refuse_misaligned_views(name, monkeypatch):
    """Taken as if on the card, the wrapper raises before it builds or
    launches anything."""
    monkeypatch.setattr(_build, "on_card", lambda t, what: True)
    monkeypatch.setattr(_build, "load", lambda *a: pytest.fail("reached the launch"))
    with pytest.raises(ValueError, match="16-byte aligned"):
        _vector_wrapper_calls()[name]()


def peak_step(row: list, form: str) -> list:
    """One step of a mul_peak form on one thread's 8 words, in Python ints."""
    m, c, mask = tile_bench.PEAK_M, tile_bench.PEAK_C, 0xFFFFFFFF
    if form in ("mad_lo", "mad_hi"):
        return [((x * m >> 32 if form == "mad_hi" else x * m) + c) & mask for x in row]
    if form in ("mad_lo_cc", "mad_hi_cc"):
        out, carry = [], 0
        for x in row:
            s = (x * m >> 32 if form == "mad_hi_cc" else x * m & mask) + c + carry
            out.append(s & mask)
            carry = s >> 32
        return out
    out = []
    for lo, hi in zip(row[0::2], row[1::2]):
        w = (lo * m + (hi << 32 | lo)) % (1 << 64)
        out += [w & mask, w >> 32]
    return out


@pytest.mark.parametrize("form", sorted(tile_bench.PEAK_FORMS))
def test_mul_peak_plain_matches_python_ints(form):
    rng = np.random.default_rng(4)
    words = rng.integers(0, 1 << 32, (tile_bench.PEAK_THREADS, tile_bench.PEAK_CHAINS), dtype=np.uint64)
    acc = torch.as_tensor(words.astype(np.uint32).view(np.int32))
    got = tile_bench.mul_peak(acc, 5, form)  # the plain version on the CPU
    want = []
    for row in words.tolist():
        for _ in range(5):
            row = peak_step(row, form)
        want.append(row)
    assert got.numpy().view(np.uint32).tolist() == want


def test_ptxas_usage_reads_the_build_log(tmp_path, monkeypatch):
    log = """ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__5ad04a6c_13_tile_bench_cu_2434383d11padd_kernelILb1ELb1EEEvNS_8PaddArgsE11FieldConsts' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__5ad04a6c_13_tile_bench_cu_2434383d11padd_kernelILb1ELb1EEEvNS_8PaddArgsE11FieldConsts
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__5ad04a6c_13_tile_bench_cu_2434383d16tile_padd_kernelEPKiS1_S1_S1_S1_PiS2_S2_x11FieldConsts' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 142 registers, used 0 barriers
"""
    monkeypatch.setattr(_build, "BUILD", tmp_path)
    with pytest.raises(FileNotFoundError, match="no ptxas output"):
        _build.ptxas_usage("tile_bench")  # no log for the current source: no numbers
    _build.log_path("tile_bench").write_text(log)
    assert _build.ptxas_usage("tile_bench") == {
        "padd_kernel<1,1>": {"spill_bytes": 12, "registers": 128, "stack_bytes": 0},
        "tile_padd_kernel": {"spill_bytes": 0, "registers": 142, "stack_bytes": 0},
    }
    with pytest.raises(FileNotFoundError):  # another build's log is not this one's
        _build.ptxas_usage("tile_bench", ("TILE_MUL_THREADS=128",))


def test_build_keys_each_library_and_its_log(tmp_path, monkeypatch):
    """Each set of -D defines is a library of its own, built with them, its
    ptxas output beside it under the same name; a library without its log
    is built again."""
    calls = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            calls.append(cmd)
            self.returncode = 0
            out = cmd[cmd.index("-o") + 1]
            open(out, "w").close()

        def communicate(self):
            return "ptxas info    : Used 40 registers\n", None

    monkeypatch.setattr(_build, "BUILD", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    variant = ("TILE_MUL_THREADS=128", "TILE_MUL_MIN_BLOCKS=1")
    assert _build._target("tile_bench") != _build._target("tile_bench", variant)
    _build.build_all(["tile_bench"], [(), variant])
    assert [[a for a in cmd if a.startswith("-D")] for cmd in calls] == [
        [], ["-DTILE_MUL_THREADS=128", "-DTILE_MUL_MIN_BLOCKS=1"]]
    for defs in ((), variant):
        lib = _build._target("tile_bench", defs)
        assert lib.exists() and _build.log_path("tile_bench", defs) == lib.with_suffix(".log")
        assert _build.log_path("tile_bench", defs).read_text().startswith("ptxas info")
    assert _build.build_all(["tile_bench"], [(), variant]) == 0.0 and len(calls) == 2
    _build.log_path("tile_bench").unlink()
    _build.build_all(["tile_bench"])
    assert len(calls) == 3


def test_pasta_curves_have_3b_15():
    """Kernel 10 multiplies by 3b as 16 x - x exactly when 3b = 15: both
    Pasta curves (y^2 = x^3 + 5)."""
    assert CurveCtx(Pallas).b3_int == 15 and CurveCtx(Vesta).b3_int == 15


def edge_rows(n: int, shift: int, ctx) -> torch.Tensor:
    """(n, 16) limbs on the card: the edge inputs 0, 1, p - 1, p, 2p - 1 and
    R mod p (Montgomery 1), rotated by `shift`, in the first 12 rows, values
    below 2p from a seed after them."""
    p = ctx.p_int
    edge = [0, 1, p - 1, p, 2 * p - 1, ctx.r_int]
    rng = np.random.default_rng(100 + shift)
    vals = [edge[(i + shift) % len(edge)] if i < 12 else int.from_bytes(rng.bytes(32), "little") % (2 * p)
            for i in range(n)]
    return torch.as_tensor(ints_to_limbs(vals), device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 255, 257, (1 << 12) + 3])
def test_tile_kernels_ragged_edge_inputs_on_card(n):
    """Against their plain versions: kernel 9 bit for bit on Pallas's base
    field (Pasta form) and on BN254's scalar field (generic form); kernel 10
    on Pallas on canonical values (3b = 15 as 16 x - x) and on BN254's G1
    (3b = 9, generic form with Montgomery products by 3b) bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    for ctx in (CurveCtx(Pallas).fctx, FieldCtx(FrBn)):
        a, b = edge_rows(n, 0, ctx), edge_rows(n, 1, ctx)
        assert torch.equal(tile_bench.tile_mul(a, b, ctx), tile_bench.tile_mul_plain(a, b, ctx)), ctx.p_int
    cc = CurveCtx(Pallas)
    pts = [edge_rows(n, s, cc.fctx) for s in range(5)]
    got = tile_bench.tile_padd(*pts, cc)
    plain = tile_bench.tile_padd_plain(*pts, cc)
    assert all(torch.equal(from_mont(g, cc.fctx), from_mont(w, cc.fctx)) for g, w in zip(got, plain))
    bn = CurveCtx(Bn254G1)
    assert bn.b3_int == 9
    pts = [edge_rows(n, s, bn.fctx) for s in range(5)]
    got = tile_bench.tile_padd(*pts, bn)
    assert all(torch.equal(g, w) for g, w in zip(got, tile_bench.tile_padd_plain(*pts, bn)))
