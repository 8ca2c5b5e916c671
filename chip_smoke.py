"""Smoke run of halo2_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the ten CUDA kernels from halo2_tpu_torch/csrc with nvcc (sm_90a),
holds each kernel against its plain torch version on the card at the
main path's shapes and times both (the bucket MSM's kernels 2-4 at both
window widths: c = 4 at M = 3, n = 2^14 + 1 and c = 8 at M = 2, n = 2^15,
each MSM also against msm_host, kernel 4 bit for bit, also on parts that hold
the identity, a pair P, P and a pair P, -P; kernel 1 bit for bit at every
level of the 2^14 and 2^16 plans, both directions, on edge inputs 0, 1,
p - 1 and 2p - 1 beside values below 2p, and timed at every level of both;
kernel 7 also on identity, equal and opposite windows), reproduces the
golden proof bytes of MulCircuit (k = 4), and drives four paths, each with
the kernels' launch counters set to 0 just before it and read just after:

* k = 14: IPA/Vesta params -> keygen_vk -> keygen_pk -> create_proof ->
  verify_proof for BenchCircuit, which runs kernels 1-4; the proof has the
  pinned bytes (BENCH_K14_PROOF_SHA256). It then proves the
  same circuit twice more, warm: once plain, once with the four kernels timed
  by CUDA events and every kernel on the card traced by torch.profiler, which
  gives the device time of one proof; and reproduces the proof bytes of
  BenchCircuit at k = 10.
* k = 16: the same entry points for BenchCircuit at k = 16, where keygen's
  sigma commits, the vanishing argument's random commit and the verifier's
  final MSM take the sorted-bucket MSM (kernels 5-7) and every other MSM the
  bucket MSM at c = 8 (kernels 2-4, timed by CUDA events through the proof
  beside kernels 5-7; kernel 1's launches counted too). The proof has the
  pinned bytes (BENCH_K16_PROOF_SHA256)
  and verifies, a flipped byte is rejected, and the proof made again with the sorted MSM
  switched off, then once more with it on, has the same bytes (those two
  proofs are both warm, so their times compare); commit_lagrange(v) =
  commit(intt(v)) on the k = 16 params. Kernels 5-7 are then held against
  their plain versions and msm_host at n = 2^16 + 1, kernels 5 and 6 also on
  scalars below 2^127 with zero rows (windows 8-15 empty; that MSM against
  the bucket MSM), and the sorted MSM, its pre-stage alone and the bucket
  MSM are timed on the same 2^16 + 1 scalars and bases.
* NTT=pallas: the k = 14 path again with every basis change on the
  mixed-radix plan (kernel 8, none of kernel 1), which must give the pinned
  VK and the proof bytes of the default route; then BenchCircuit at k = 10
  proved under NTT=pallas and NTT=mxu (bf16 Toeplitz products on the tensor
  cores), each to the JAX package's bytes. Before the paths, kernel 8 is
  held against its plain version bit for bit, on the edge inputs, at every
  level of both 2^14, 2^16 and 2^18 plans on Fp (2^18 has a second factor
  of 1024) and of both 2^14 plans on FrBn; a transform at 2^14 and 2^16 must
  launch its two levels and no other device kernel (a torch.profiler count),
  and is timed beside kernel 1's; the Toeplitz plan at 2^14 is held in both
  MXU_DTYPEs against its int64 version.
* the profiling tool: `halo2_tpu_torch.tools.profile_kernels.tilemul` over
  2^18 elements, which runs kernels 9 and 10 (eight chained Montgomery
  products per element; one mixed addition per point); both are then held
  against their plain versions on the tool's inputs (kernel 9 bit for bit,
  kernel 10 on canonical values: it multiplies by 3b = 15 as 16 x - x), and
  again at n = 1, 257 and 2^12 + 3 with the edge inputs 0, 1, p - 1, p,
  2p - 1 and R mod p in the first rows, on Pallas and, in the kernels'
  generic form, on BN254 (kernel 9 on its scalar field, kernel 10 on G1,
  3b = 9; both bit for bit); `-Xptxas -v` must show no spill in
  any kernel of csrc/tile_bench.cu. Its `oplat` probe then gives the clock
  cycles of one field operation on one thread, and the card's measured rate
  of 32-bit multiply instructions (mad.lo, mad.hi, their carry-chained
  forms, mad.wide.u32) beside the rate the bounds assume.

Each kernel is timed twice: `ms`, the median CUDA-event time of one call
(host launch included), and `device_ms`, the CUDA-event time per call of ten
calls replayed from one CUDA graph (the card's own time, which for a kernel
of tens of microseconds is well below the event time of one call).

Every phase prints one JSON line; any failure raises and exits non-zero. The
last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

It imports nothing of JAX or halo2_tpu, and exits non-zero without CUDA.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# BenchCircuit at k = 10, seed 42, ChaCha20Rng(b"\x2a" * 32): the sha256 of
# the proof the JAX package makes on the CPU (tests/test_torch_prove.py
# names the command).
BENCH_K10_PROOF_SHA256 = "08b4952d1b1cac2b4951ac6097ac2f6a260cddc729bb0d54cb788de8510af1db"
# BenchCircuit at k = 14 and k = 16, the same seed and rng: the sha256 of the
# proofs that the port made on an H100 before kernels 2 and 3 were redesigned
# (halo2_tpu_torch/tools/msm_ab.py --proofs on that commit).
BENCH_K14_PROOF_SHA256 = "24f3939ad97fc72b182872d727af9089a4beff8e3801f72c6d2e0c16be9f29d9"
BENCH_K16_PROOF_SHA256 = "5f9b3d057d85eada10660f86ab6c2899182c7e6bfeb5ac0c247277506b23987f"

# Bounds. Device memory moves 3.35e12 B/s (H100 SXM data sheet). For integer
# work the assumed peak is 64 32-bit multiply instructions per clock per SM
# (CUDA C++ Programming Guide, throughput table, compute capability 9.0) x
# 132 SMs x 1.98 GHz = 1.673e13 instructions/s. Only multiplies are counted,
# so the operation bound is a lower bound on what the card must spend.
HBM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 64 * 132 * 1.98e9
# Montgomery products per complete addition (RCB15, a = 0): 11 general
# products for the mixed addition (alg. 8), 12 for the full one (alg. 7). Each
# also multiplies twice by 3b = 15 on Pasta, which a shift and a subtraction do.
MIXED_ADD_PRODUCTS = 11
FULL_ADD_PRODUCTS = 12
# RCB15 algorithm 9 (a = 0): 9 products, one of them by 3b
DOUBLE_PRODUCTS = 8


def mont_mul_instrs(p: int) -> int:
    """32-bit multiply instructions one CIOS Montgomery product mod p needs:
    the 64 word products of a*b (low and high word, two instructions each),
    per iteration the low-only product m = t0 * n0 unless n0 = -1/p mod 2^32
    is -1 (then m = -t0, a negation), and m * p[j] for each word of p that is
    not 0, 1 or a power of two (a shift does those), two instructions each.
    The Pasta moduli have p = 1 mod 2^32 and 3 such words: 128 + 0 + 48."""
    words = [(p >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    general = sum(1 for w in words if w & (w - 1))
    n0 = -pow(p, -1, 1 << 32) % (1 << 32)
    m_muls = 0 if n0 == 0xFFFFFFFF else 8
    return 2 * 64 + m_muls + 8 * 2 * general


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(bytes_moved: float, mul_instrs: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = mul_instrs / INT32_MUL_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(name, fn, log):
    """fn with a CUDA event pair recorded around each call into `log`."""
    def run(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        log.append((name, start, end))
        return out
    return run


def time_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of fn() over `reps` warm runs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 10) -> float:
    """The card's time per call of fn(): `reps` calls captured in one CUDA
    graph, its replay timed by CUDA events. Unlike an event pair around one
    call it leaves out the host's launch time, which for a kernel of tens of
    microseconds is most of the event time; what remains between the
    kernels is the graph's launch gap of about a microsecond."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def require(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


@contextmanager
def environ(**values):
    """Set (or, for None, unset) environment variables, and restore them on
    the way out, also when the block raises."""
    saved = {name: os.environ.get(name) for name in values}
    try:
        for name, v in values.items():
            if v is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = v
        yield
    finally:
        for name, v in saved.items():
            if v is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = v


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from halo2_tpu_torch.circuits import MulCircuit, bench_circuit_for_k
    from halo2_tpu_torch.curves import Bn254G1, Pallas, Vesta
    from halo2_tpu_torch.fields import Fp, FrBn
    from halo2_tpu_torch.ops import _build, msm_bucket, msm_sorted, mxu_mont, ntt_cg, ntt_mr, tile_bench
    from halo2_tpu_torch.ops import msm as msm_mod
    from halo2_tpu_torch.ops.curve import CurveCtx, PointVec
    from halo2_tpu_torch.ops.field import FieldCtx, from_mont, ints_to_limbs, limbs_to_ints
    from halo2_tpu_torch.ops.msm import MSMBases, msm_host
    from halo2_tpu_torch.ops.ntt import NttPlan
    from halo2_tpu_torch.plonk.error import OpeningError
    from halo2_tpu_torch.plonk.keygen import keygen_pk, keygen_vk
    from halo2_tpu_torch.plonk.prover import create_proof
    from halo2_tpu_torch.plonk.verifier import verify_proof
    from halo2_tpu_torch.poly.commitment import Blind
    from halo2_tpu_torch.poly.ipa import ParamsIPA
    from halo2_tpu_torch.tools import profile_kernels
    from halo2_tpu_torch.transcript import Blake2bRead, Blake2bWrite, TranscriptError
    from halo2_tpu_torch.utils.chacha import ChaCha20Rng
    from halo2_tpu_torch.utils.measure import get_records, reset_records

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # ---- build ----
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})

    rng = np.random.default_rng(20261016)
    sctx = FieldCtx(Fp)
    q = Fp.MODULUS

    def rand_canon(shape, top=0x3FFF):
        """Uniform values below 2^(240 + bits of top) as canonical 16-bit limbs,
        from the seed: below q for the default top (< 2^254)."""
        limbs = rng.integers(0, 1 << 16, size=shape + (16,), dtype=np.int64)
        limbs[..., 15] &= top
        return torch.as_tensor(limbs.astype(np.int32), device=dev)

    errs = {}

    def same(name, a, b, ctx, what):
        """Record the largest limb difference of the canonical values; fail unless 0."""
        d = (from_mont(a.reshape(-1, 16), ctx) - from_mont(b.reshape(-1, 16), ctx)).abs().max()
        errs[name] = max(errs.get(name, 0), int(d))
        require(int(d) == 0, what)

    def canon_equal(a, b, ctx=sctx):
        return torch.equal(from_mont(a.reshape(-1, 16), ctx), from_mont(b.reshape(-1, 16), ctx))

    def level_bound(cols, f, tab, g):
        """Bound of one NTT level over `cols` columns of f elements (Fp): each
        element read and written once, the twiddle tables read once, and one
        product per twiddle other than 1 (stage 0's are all 1, and so are
        inter row 0 and the first entry of every inter row)."""
        inter = tab["inter"]
        nbytes = 4 * (cols * f * 16 * 2 + tab["stw"].numel() + (0 if inter is None else inter.numel()))
        one = sctx.const(1, dev)
        prods = cols * int((tab["stw"] != one).any(-1).sum())
        if inter is not None:
            prods += int((inter != one).any(-1).sum(-1)[torch.arange(cols, device=dev) % g].sum())
        return (*bound(nbytes, mont_mul_instrs(q) * prods), prods)

    def edge_mont(n, p=q):
        """(n, 16) Montgomery limbs mod p (Fp by default): 0, 1, p - 1 and
        2p - 1 (the ends of the lazy domain [0, 2p)) first, uniform values
        below 2p after them."""
        vals = [0, 1, p - 1, 2 * p - 1] + [int.from_bytes(rng.bytes(32), "little") % (2 * p)
                                           for _ in range(n - 4)]
        return torch.as_tensor(ints_to_limbs(vals), device=dev)

    def kernels_launched(fn):
        """The device kernels one call of fn() launches (a torch.profiler
        count: kernel launches and any torch copy around them)."""
        fn()
        torch.cuda.synchronize()
        counts = []
        for _ in range(3):  # a profiler session now and then misses kernels, never invents one
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            counts.append(sum(1 for e in prof.events()
                              if e.device_type == torch.autograd.DeviceType.CUDA))
        return max(counts)

    report = {}

    counters = (ntt_cg.LAUNCHES, msm_bucket.LAUNCHES, msm_sorted.LAUNCHES, ntt_mr.LAUNCHES,
                tile_bench.LAUNCHES)

    def zero_launches():
        for counts in counters:
            for name in counts:
                counts[name] = 0
        msm_mod.ROUTES.clear()

    def read_launches():
        return {name: c for counts in counters for name, c in counts.items()}

    def read_routes():
        return {f"{site}:{route}": cnt for (site, route), cnt in sorted(msm_mod.ROUTES.items())}

    def diff(after, before):
        return {name: after[name] - before.get(name, 0) for name in after}

    k14_kernels = [*ntt_cg.LAUNCHES, *msm_bucket.LAUNCHES]
    k16_kernels = list(msm_sorted.LAUNCHES)
    tool_kernels = list(tile_bench.LAUNCHES)

    # ---- kernel 1: constant-geometry NTT level, every level of 2^14 and 2^16 ----
    t0 = time.perf_counter()
    cg_levels = []
    for log_n in (14, 16):
        n = 1 << log_n
        omega = pow(Fp.ROOT_OF_UNITY, 1 << (Fp.S - log_n), q)
        omega_inv = pow(omega, -1, q)
        x = sctx.to_mont(rand_canon((n,)))
        fwd = ntt_cg.CgNttPlan(Fp, log_n, omega)
        inv = ntt_cg.CgNttPlan(Fp, log_n, omega_inv)
        # every level of both plans: kernel == plain, bit for bit, on edge inputs
        for plan in (fwd, inv):
            for li, (lv, tab) in enumerate(zip(plan.levels, plan._tables(dev))):
                f, g = lv["f"], lv["g"]
                xl = edge_mont(n).reshape(n // (f * g), f, g, 16)
                yk = ntt_cg.cg_ntt_level(xl, tab["stw"], tab["inter"], sctx, tab["perm"])
                yp = ntt_cg.cg_ntt_level_plain(xl, tab["stw"], tab["inter"], sctx, tab["perm"])
                require(torch.equal(yk, yp), f"cg_ntt_level 2^{log_n} level {li}: kernel != plain (limbs)")
                same("cg_ntt_level", yk, yp, sctx, f"cg_ntt_level 2^{log_n} level {li}: kernel != plain")
        y = fwd(x)
        require(canon_equal(y, NttPlan(Fp, log_n, omega)(x)), f"NTT 2^{log_n} != radix-2 reference")
        back = sctx.mul(inv(y), sctx.const(pow(n, -1, q), dev))
        require(canon_equal(back, x), f"inverse NTT 2^{log_n} does not invert")
        xe = edge_mont(n)
        require(canon_equal(fwd(xe), NttPlan(Fp, log_n, omega)(xe)), f"NTT 2^{log_n} on edge inputs")
        ms_full = time_ms(lambda: fwd(x))
        # each level of the forward plan, timed at its own shape
        for li, (lv, tab) in enumerate(zip(fwd.levels, fwd._tables(dev))):
            f, g = lv["f"], lv["g"]
            xl = x.reshape(n // (f * g), f, g, 16)
            b_ms, b_by, prods = level_bound(n // f, f, tab, g)

            def level():
                return ntt_cg.cg_ntt_level(xl, tab["stw"], tab["inter"], sctx, tab["perm"])

            row = dict(log_n=log_n, level=li, f=f, g=g, products=prods, bound_ms=b_ms, bound_by=b_by,
                       ms=time_ms(level), device_ms=device_ms(level))
            if (log_n, li) == (16, 0):
                row["plain_ms"] = time_ms(
                    lambda: ntt_cg.cg_ntt_level_plain(xl, tab["stw"], tab["inter"], sctx, tab["perm"]), 2)
            cg_levels.append(row)
            emit({"phase": "time", "kernel": "cg_ntt_level", **row})
        emit({"phase": "ntt", "log_n": log_n, "exact": True, "full_transform_ms": ms_full,
              "levels": [(lv["f"], lv["g"]) for lv in fwd.levels]})
    first = cg_levels[2]  # the first level of 2^16: the kernel's row
    report["cg_ntt_level"] = dict(
        route="cuda", source="halo2_tpu_torch/csrc/ntt_cg.cu",
        replaces="halo2_tpu/ops/ntt_pallas2.py:219",
        ms=first["ms"], device_ms=first["device_ms"], plain_ms=first["plain_ms"],
        bound_ms=first["bound_ms"], bound_by=first["bound_by"], library_ms=None,
        shape=f"B=1 f={first['f']} g={first['g']} (first level of 2^16)",
        levels=[{k: r[k] for k in ("log_n", "level", "f", "g", "ms", "device_ms", "bound_ms", "bound_by")}
                for r in cg_levels],
    )
    emit({"phase": "ntt_done", "seconds": time.perf_counter() - t0})

    # ---- kernel 8: mixed-radix NTT level (the NTT=pallas engine) ----
    t0 = time.perf_counter()
    for field, log_n in ((Fp, 14), (Fp, 16), (Fp, 18), (FrBn, 14)):
        fctx = FieldCtx(field)
        p = field.MODULUS
        n = 1 << log_n
        omega = pow(field.ROOT_OF_UNITY, 1 << (field.S - log_n), p)
        top = 0x3FFF if field is Fp else 0x1FFF  # below p
        x = fctx.to_mont(rand_canon((n,), top))
        fwd = ntt_mr.MrNttPlan(field, log_n, omega)
        inv = ntt_mr.MrNttPlan(field, log_n, pow(omega, -1, p))
        # every level of both plans: kernel == plain, bit for bit, on edge inputs
        for plan in (fwd, inv):
            for li, (lv, tab) in enumerate(zip(plan.levels, plan._tables(dev))):
                f, g = lv["f"], lv["g"]
                xl = edge_mont(n, p).reshape(n // (f * g), f, g, 16)
                yk = ntt_mr.mr_col_ntt(xl, tab["stw"], tab["inter"], fctx, tab["perm"])
                yp = ntt_mr.mr_col_ntt_plain(xl, tab["stw"], tab["inter"], fctx, tab["perm"])
                require(torch.equal(yk, yp),
                        f"mr_col_ntt {field.__name__} 2^{log_n} level {li}: kernel != plain (limbs)")
                same("mr_col_ntt", yk, yp, fctx,
                     f"mr_col_ntt {field.__name__} 2^{log_n} level {li}: kernel != plain")
        y = fwd(x)
        cg = ntt_cg.CgNttPlan(field, log_n, omega)
        require(canon_equal(y, NttPlan(field, log_n, omega)(x), fctx),
                f"mixed-radix NTT {field.__name__} 2^{log_n} != radix-2 reference")
        require(canon_equal(y, cg(x), fctx),
                f"mixed-radix NTT {field.__name__} 2^{log_n} != constant-geometry NTT")
        back = fctx.mul(inv(y), fctx.const(pow(n, -1, p), dev))
        require(canon_equal(back, x, fctx), f"inverse mixed-radix NTT 2^{log_n} does not invert")
        xe = edge_mont(n, p)
        require(canon_equal(fwd(xe), cg(xe), fctx),
                f"mixed-radix NTT {field.__name__} 2^{log_n} on edge inputs != constant-geometry NTT")
        row = {"phase": "ntt_mr", "field": field.__name__, "log_n": log_n, "exact": True,
               "levels": [(lv["f"], lv["g"]) for lv in fwd.levels],
               "full_transform_ms": time_ms(lambda: fwd(x)), "cg_full_transform_ms": time_ms(lambda: cg(x))}
        if field is Fp and log_n in (14, 16):
            # a transform is its levels' launches and nothing else: one kernel
            # a level by the wrapper's count, and no other device kernel in a
            # profiler trace (which can miss a kernel, so it bounds the count)
            before = ntt_mr.LAUNCHES["mr_col_ntt"]
            fwd(x)
            launched = ntt_mr.LAUNCHES["mr_col_ntt"] - before
            row["device_kernels_per_transform"] = kernels_launched(lambda: fwd(x))
            require(launched == len(fwd.levels) and row["device_kernels_per_transform"] <= launched,
                    f"NTT=pallas 2^{log_n}: {launched} kernel launches and "
                    f"{row['device_kernels_per_transform']} device kernels a transform, "
                    f"not its {len(fwd.levels)} levels")
            row["transform_device_ms"] = device_ms(lambda: fwd(x))
            row["cg_transform_device_ms"] = device_ms(lambda: cg(x))
        emit(row)
        if field is Fp and log_n == 16:
            lv, tab = fwd.levels[0], fwd._tables(dev)[0]
            f, g = lv["f"], lv["g"]
            cols = n // f
            xl = x.reshape(n // (f * g), f, g, 16)

            def level():
                return ntt_mr.mr_col_ntt(xl, tab["stw"], tab["inter"], sctx, tab["perm"])

            ms = time_ms(level)
            dev_ms = device_ms(level)
            plain_ms = time_ms(
                lambda: ntt_mr.mr_col_ntt_plain(xl, tab["stw"], tab["inter"], sctx, tab["perm"]), 2)
            b_ms, b_by, prods = level_bound(cols, f, tab, g)
            report["mr_col_ntt"] = dict(
                route="cuda", source="halo2_tpu_torch/csrc/ntt_mr.cu",
                replaces="halo2_tpu/ops/ntt_pallas.py:392", ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shape=f"B=1 f={f} g={g} (first level of 2^16)",
            )
            emit({"phase": "time", "kernel": "mr_col_ntt", "products": prods, **report["mr_col_ntt"]})
    emit({"phase": "ntt_mr_done", "seconds": time.perf_counter() - t0})

    # ---- the Toeplitz-product NTT (NTT=mxu) at 2^14, each operand type ----
    t0 = time.perf_counter()
    log_n = 14
    omega = pow(Fp.ROOT_OF_UNITY, 1 << (Fp.S - log_n), q)
    x = sctx.to_mont(rand_canon((1 << log_n,)))
    mplan = mxu_mont.MxuNttPlan(Fp, log_n, omega)
    exact = mplan(x.cpu()).to(dev)  # int64 products on the host: the plain version
    require(canon_equal(exact, NttPlan(Fp, log_n, omega)(x)), "MxuNttPlan int64 != radix-2 reference")
    mxu_ms = {}
    for dtype in mxu_mont.DTYPES:
        with environ(MXU_DTYPE=dtype):
            require(canon_equal(mplan(x), exact), f"MxuNttPlan {dtype} on the card != int64 version")
            mxu_ms[dtype] = time_ms(lambda: mplan(x), 3)
    emit({"phase": "mxu_ntt", "log_n": log_n, "exact": True, "full_transform_ms": mxu_ms,
          "seconds": time.perf_counter() - t0})

    # ---- the profiling tool's tilemul: kernels 9 and 10 over 2^18 elements ----
    t0 = time.perf_counter()
    zero_launches()
    tiles = profile_kernels.tilemul(1 << 18, device=dev)
    torch.cuda.synchronize()
    tile_launches = read_launches()
    for name in tool_kernels:
        require(tile_launches[name] > 0, f"kernel {name} was not launched by profile_kernels tilemul")
    pallas_cc = CurveCtx(Pallas)
    fctx = pallas_cc.fctx
    n = tiles["n"]
    mul_plain = tile_bench.tile_mul_plain(tiles["a"], tiles["b"], fctx)
    require(torch.equal(tiles["mul_out"], mul_plain), "tile_mul: kernel != plain (limbs)")
    same("tile_mul", tiles["mul_out"], mul_plain, fctx, "tile_mul: kernel != plain")
    for got, want in zip(tiles["padd_out"], tile_bench.tile_padd_plain(*tiles["pts"], pallas_cc)):
        same("tile_padd", got, want, fctx, "tile_padd: kernel != plain")

    edge_rng = np.random.default_rng(20261017)  # apart from `rng`, so later phases keep their inputs

    def tile_edge(n, shift, ctx):
        """(n, 16) Montgomery limbs of ctx's field: the edge inputs 0, 1, p - 1,
        p, 2p - 1 and R mod p (Montgomery 1), rotated by `shift`, in the first
        12 rows, uniform values below 2p after them."""
        p = ctx.p_int
        edge = [0, 1, p - 1, p, 2 * p - 1, ctx.r_int]
        vals = [edge[(i + shift) % len(edge)] if i < 12
                else int.from_bytes(edge_rng.bytes(32), "little") % (2 * p) for i in range(n)]
        return torch.as_tensor(ints_to_limbs(vals), device=dev)

    # Pallas takes the Pasta form (3b = 15 as 16 x - x: canonical values);
    # BN254's G1 (3b = 9) and scalar field the generic form (raw limbs)
    bn_cc = CurveCtx(Bn254G1)
    for n_edge in (1, 257, (1 << 12) + 3):  # ragged: 256 threads a block divides none of them
        for mctx in (fctx, FieldCtx(FrBn)):
            a_e, b_e = tile_edge(n_edge, 0, mctx), tile_edge(n_edge, 1, mctx)
            require(torch.equal(tile_bench.tile_mul(a_e, b_e, mctx),
                                tile_bench.tile_mul_plain(a_e, b_e, mctx)),
                    f"tile_mul n={n_edge} p={mctx.p_int:#x}: kernel != plain (limbs) on edge inputs")
        pts_e = [tile_edge(n_edge, s, fctx) for s in range(5)]
        for got, want in zip(tile_bench.tile_padd(*pts_e, pallas_cc),
                             tile_bench.tile_padd_plain(*pts_e, pallas_cc)):
            same("tile_padd", got, want, fctx, f"tile_padd n={n_edge}: kernel != plain on edge inputs")
        pts_e = [tile_edge(n_edge, s, bn_cc.fctx) for s in range(5)]
        require(all(torch.equal(g, w) for g, w in zip(tile_bench.tile_padd(*pts_e, bn_cc),
                                                      tile_bench.tile_padd_plain(*pts_e, bn_cc))),
                f"tile_padd n={n_edge} on Bn254G1: kernel != plain (limbs) on edge inputs")
    ptxas = _build.ptxas_usage("tile_bench")
    require(all(u.get("spill_bytes") == 0 for u in ptxas.values()), f"tile_bench.cu spills: {ptxas}")
    registers = {  # the kernels on Pallas (Pasta form, 3b = 15)
        "tile_mul": ptxas["mul_kernel<1>"]["registers"],
        "tile_padd": ptxas["padd_kernel<1,1>"]["registers"],
    }
    mul = mont_mul_instrs(fctx.p_int)
    for name, kern, plain, nbytes, muls, replaces, per in (
        ("tile_mul", lambda: tile_bench.tile_mul(tiles["a"], tiles["b"], fctx),
         lambda: tile_bench.tile_mul_plain(tiles["a"], tiles["b"], fctx), 3 * 64 * n,
         tile_bench.MULS_PER_ELEMENT * n * mul, "tools/profile_kernels.py:61", "ns_per_product"),
        ("tile_padd", lambda: tile_bench.tile_padd(*tiles["pts"], pallas_cc),
         lambda: tile_bench.tile_padd_plain(*tiles["pts"], pallas_cc), 8 * 64 * n,
         MIXED_ADD_PRODUCTS * n * mul, "tools/profile_kernels.py:92", "ns_per_point"),
    ):
        b_ms, b_by = bound(nbytes, muls)
        report[name] = dict(
            route="cuda", source="halo2_tpu_torch/csrc/tile_bench.cu", replaces=replaces,
            ms=tiles["mul_ms" if name == "tile_mul" else "padd_ms"], device_ms=device_ms(kern),
            plain_ms=time_ms(plain, 1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=f"n={n} (Pallas)",
            registers=registers[name], **{per: tiles[per]})
        emit({"phase": "time", "kernel": name, **report[name]})
    emit({"phase": "profile_tilemul", "n": n, "exact": True, "launches": tile_launches,
          "ptxas_tile_bench": ptxas, "seconds": time.perf_counter() - t0})
    # the tool's probes: cycles of one field operation on one thread (fe_mul
    # against the carry-chain forms), each checked against its plain
    # version, and the card's rate of 32-bit multiply instructions beside
    # the one every operations bound assumes
    lat = profile_kernels.oplat(256, device=dev)
    emit({"phase": "op_latency", "cycles_per_op": {op: lat[op] for op in tile_bench.OPS},
          "int32_mul_per_s": {"assumed": INT32_MUL_PER_S,
                              **{form: lat[f"{form}_per_s"] for form in tile_bench.PEAK_FORMS}},
          "exact": True})

    # ---- kernels 2-4: bucket MSM ----
    t0 = time.perf_counter()
    params14 = ParamsIPA.cached(Vesta, 14, device=dev)
    emit({"phase": "params_k14", "seconds": time.perf_counter() - t0})
    cc = CurveCtx(Vesta)
    pctx = cc.fctx

    for n, M, bases_pts in (
        ((1 << 14) + 1, 3, params14.g + [params14.w]),
        (1 << 15, 2, params14.g + params14.g_lagrange),
    ):
        t1 = time.perf_counter()
        bases = MSMBases(Vesta, bases_pts, dev)
        c, nwin, T, n_pad = msm_bucket.msm_geometry(Vesta, n, dev)
        canon = rand_canon((M, n))
        canon[0, :3] = 0  # zero scalars
        canon[0, 3] = torch.as_tensor(  # q - 1
            np.frombuffer((q - 1).to_bytes(32, "little"), dtype="<u2").astype(np.int32), device=dev)
        scal_t = torch.nn.functional.pad(canon.transpose(1, 2), (0, n_pad - n)).contiguous()
        db = bases.device_tables(n_pad, dev)
        bk = msm_bucket.msm_accum(scal_t, db.px, db.py, c, nwin, T, cc)
        bp = msm_bucket.msm_accum_plain(scal_t, db.px, db.py, c, nwin, T, cc)
        same("msm_accum", bk, bp, pctx, f"msm_accum n={n}: kernel != plain")
        fk = msm_bucket.msm_fold(bk, cc)
        fp = msm_bucket.msm_fold_plain(bk, cc)
        same("msm_fold", fk, fp, pctx, f"msm_fold n={n}: kernel != plain")
        rk = msm_bucket.msm_lane_reduce(fk, cc)
        rp = msm_bucket.msm_lane_reduce_plain(fk, cc)
        require(torch.equal(rk, rp), f"msm_lane_reduce n={n}: kernel != plain (limbs)")
        same("msm_lane_reduce", rk, rp, pctx, f"msm_lane_reduce n={n}: kernel != plain")
        # kernel 4 on edge parts: the identity in lanes 1 and T/2 + 3, lanes 0
        # and T/2 equal (P + P, the doubling case of the complete addition),
        # lane T/2 + 2 the negative of lane 2 (P + (-P)), and a row whose
        # lanes are all the identity
        ep = fk.clone()
        idv = cc.identity_vec((1,), dev)
        ident = torch.stack([idv.x[0], idv.y[0], idv.z[0]])  # (3, 16)
        h = T // 2
        ep[:, :, :, 1] = ident
        ep[:, :, :, h + 3] = ident
        ep[:, :, :, h] = ep[:, :, :, 0]
        ep[:, 1, :, h + 2] = pctx.neg(ep[:, 1, :, 2])
        ep[-1] = ident[:, :, None]
        ek = msm_bucket.msm_lane_reduce(ep, cc)
        ekp = msm_bucket.msm_lane_reduce_plain(ep, cc)
        require(torch.equal(ek, ekp), f"msm_lane_reduce n={n} edge parts: kernel != plain (limbs)")
        same("msm_lane_reduce", ek, ekp, pctx, f"msm_lane_reduce n={n} edge parts: kernel != plain")
        require(cc.decode_points(PointVec(ek[-1:, 0], ek[-1:, 1], ek[-1:, 2]))[0].is_identity(),
                "msm_lane_reduce: a row of identities did not sum to the identity")
        pts = msm_bucket.msm_bucket_many(canon, bases, mont=False)
        t2 = time.perf_counter()
        ints = limbs_to_ints(canon[0].cpu())
        require(pts[0] == msm_host(ints, bases_pts[:n], Vesta), f"MSM n={n} != msm_host")
        emit({"phase": "msm", "n": n, "M": M, "c": c, "nwin": nwin, "T": T, "exact": True,
              "host_checked": True, "msm_host_s": time.perf_counter() - t2,
              "seconds": time.perf_counter() - t1})
        rows, B = M * nwin, 1 << c
        d = torch.stack([(scal_t[:, (w * c) >> 4] >> ((w * c) & 15)) & (B - 1)
                         for w in range(nwin)], dim=1).reshape(rows, n_pad).long()
        nz = d != 0
        # the first point into a bucket is a copy; each later one an addition
        lane = torch.arange(n_pad, device=dev) % T
        key = (torch.arange(rows, device=dev)[:, None] * T + lane) * B + d
        occ = torch.zeros(rows * T * B, dtype=torch.bool, device=dev)
        occ[key[nz]] = True
        occ = occ.reshape(rows, T, B)[..., 1:]
        accum_adds = int(nz.sum()) - int(occ.sum())
        # fold: run += S_b over occupied buckets, total += run from the
        # highest occupied bucket down; the first of each is a copy
        top = (occ * torch.arange(1, B, device=dev)).amax(-1)
        fold_adds = int((occ.sum(-1) - 1).clamp(min=0).sum() + (top - 1).clamp(min=0).sum())
        mul = mont_mul_instrs(pctx.p_int)
        emit({"phase": "msm_work", "n": n, "M": M, "c": c, "nonzero_digits": int(nz.sum()),
              "accum_adds": accum_adds, "fold_adds": fold_adds,
              "bucket_occupancy": float(occ.float().mean()),
              "mont_mul_instrs": mul})
        timings = {
            "msm_accum": (
                lambda: msm_bucket.msm_accum(scal_t, db.px, db.py, c, nwin, T, cc),
                lambda: msm_bucket.msm_accum_plain(scal_t, db.px, db.py, c, nwin, T, cc),
                4 * (scal_t.numel() + db.px.numel() + db.py.numel() + bk.numel()),
                mul * MIXED_ADD_PRODUCTS * accum_adds,
                "halo2_tpu/ops/msm_pallas.py:232",
            ),
            "msm_fold": (
                lambda: msm_bucket.msm_fold(bk, cc),
                lambda: msm_bucket.msm_fold_plain(bk, cc),
                4 * (bk.numel() + fk.numel()),
                mul * FULL_ADD_PRODUCTS * fold_adds,
                "halo2_tpu/ops/msm_pallas.py:302",
            ),
            "msm_lane_reduce": (
                lambda: msm_bucket.msm_lane_reduce(fk, cc),
                lambda: msm_bucket.msm_lane_reduce_plain(fk, cc),
                4 * (fk.numel() + rk.numel()),
                mul * FULL_ADD_PRODUCTS * (T - 1) * rows,
                "halo2_tpu/ops/msm_pallas.py:357",
            ),
        }
        # the k = 14 commit shape (c = 4) is each kernel's row; c = 8 rides along
        for name, (kfn, pfn, nbytes, muls, replaces) in timings.items():
            b_ms, b_by = bound(nbytes, muls)
            row = dict(ms=time_ms(kfn), device_ms=device_ms(kfn, 5), plain_ms=time_ms(pfn, 1),
                       bound_ms=b_ms, bound_by=b_by, shape=f"M={M} n={n} c={c} T={T}")
            if c == 4:
                report[name] = dict(route="cuda", source="halo2_tpu_torch/csrc/msm_bucket.cu",
                                    replaces=replaces, library_ms=None, **row)
            else:
                report[name]["at_c8"] = row
            emit({"phase": "time", "kernel": name, "c": c, **row})

    # ---- golden proofs on the card ----
    golden = json.load(open(os.path.join(ROOT, "tests", "fixtures_golden.json")))
    t0 = time.perf_counter()
    params4 = ParamsIPA.cached(Vesta, 4, device=dev)
    vk = keygen_vk(params4, MulCircuit(7))
    pk = keygen_pk(params4, vk, MulCircuit(7))
    require(hex(vk.transcript_repr) == golden["vk_transcript_repr"], "k=4 VK repr")
    require(hashlib.sha256(vk.pinned_repr().encode()).hexdigest() == golden["vk_pinned_sha256"],
            "k=4 pinned VK")
    c_pub = 7 * 4 * 9
    tr = Blake2bWrite(Vesta)
    create_proof(params4, pk, [MulCircuit(7, 2, 3)], [[[c_pub]]], ChaCha20Rng(b"\x2a" * 32), tr)
    proof = tr.finalize()
    require(hashlib.sha256(proof).hexdigest() == golden["proof_sha256"], "k=4 proof bytes")
    require(verify_proof(params4, vk, [[[c_pub]]], Blake2bRead(Vesta, proof)) is True, "k=4 verify")
    emit({"phase": "golden_k4", "exact": True, "seconds": time.perf_counter() - t0})

    # ---- the main path: BenchCircuit at k = 14 ----
    k = 14
    zero_launches()
    stages = {}
    t0 = time.perf_counter()
    params = ParamsIPA.cached(Vesta, k, device=dev)
    circ = bench_circuit_for_k(k)
    t1 = time.perf_counter()
    vk = keygen_vk(params, circ.without_witnesses())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pk = keygen_pk(params, vk, circ.without_witnesses())
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    reset_records()
    tr = Blake2bWrite(Vesta)
    create_proof(params, pk, [circ], [[]], ChaCha20Rng(b"\x2a" * 32), tr)
    proof = tr.finalize()
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    prove_stages = get_records()
    ok = verify_proof(params, vk, [[]], Blake2bRead(Vesta, proof))
    t5 = time.perf_counter()
    launches = read_launches()
    require(ok is True, "k=14 verify")
    sha14 = hashlib.sha256(proof).hexdigest()
    require(sha14 == BENCH_K14_PROOF_SHA256, f"k=14 proof sha256 {sha14} != {BENCH_K14_PROOF_SHA256}")
    stages.update(params_s=t1 - t0, keygen_vk_s=t2 - t1, keygen_pk_s=t3 - t2, prove_s=t4 - t3,
                  verify_s=t5 - t4)
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    try:
        rejected = verify_proof(params, vk, [[]], Blake2bRead(Vesta, bytes(bad))) is not True
    except (OpeningError, TranscriptError):
        rejected = True
    require(rejected, "k=14 proof with a flipped byte was accepted")
    for name in k14_kernels:
        require(launches[name] > 0, f"kernel {name} was not launched on the k=14 path")
    require(launches["mr_col_ntt"] == 0, "kernel 8 ran on the default (NTT unset) k=14 path")
    emit({"phase": "main_path", "circuit": "BenchCircuit", "k": k, "rows": circ.rows,
          "proof_bytes": len(proof), "verified": True, "flipped_byte_rejected": True,
          "stages": stages, "prove_spans": prove_stages, "launches": launches})

    # ---- the same proof again, warm; its launches are those of one proof ----
    zero_launches()
    reset_records()
    t0 = time.perf_counter()
    tr = Blake2bWrite(Vesta)
    create_proof(params, pk, [circ], [[]], ChaCha20Rng(b"\x2a" * 32), tr)
    require(tr.finalize() == proof, "warm k=14 proof bytes differ from the first")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    emit({"phase": "warm_k14", "prove_s": warm_s, "prove_spans": get_records(),
          "launches": read_launches()})

    # ---- device time of one warm proof: the four kernels by CUDA events,
    # every kernel on the card by torch.profiler ----
    event_log = []
    wrapped = [(ntt_cg, "cg_ntt_level"), (msm_bucket, "msm_accum"), (msm_bucket, "msm_fold"),
               (msm_bucket, "msm_lane_reduce")]
    originals = {name: getattr(mod, name) for mod, name in wrapped}
    for mod, name in wrapped:
        setattr(mod, name, timed(name, originals[name], event_log))
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr = Blake2bWrite(Vesta)
            create_proof(params, pk, [circ], [[]], ChaCha20Rng(b"\x2a" * 32), tr)
            torch.cuda.synchronize()
            profiled_s = time.perf_counter() - t0
    finally:
        for mod, name in wrapped:
            setattr(mod, name, originals[name])
    require(tr.finalize() == proof, "profiled k=14 proof bytes differ from the first")
    proof_ms = {name: 0.0 for name in originals}
    for name, start, end in event_log:
        proof_ms[name] += start.elapsed_time(end)
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_symbol = {"cg_ntt_level": "cg_level_kernel", "msm_accum": "accum_kernel(",
                     "msm_fold": "fold_kernel(", "msm_lane_reduce": "lane_reduce_kernel<"}
    traced_ms = {name: sum(e.time_range.elapsed_us() for e in dev_events if sym in e.name) / 1e3
                 for name, sym in kernel_symbol.items()}
    busy_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3 if dev_events else None
    emit({"phase": "device_time_k14", "profiled_prove_s": profiled_s,
          "device_events": len(dev_events), "device_busy_ms": busy_ms,
          "device_busy_share_of_warm_prove": None if busy_ms is None else busy_ms / 1e3 / warm_s,
          "kernels_event_ms": proof_ms, "kernels_traced_ms": traced_ms})

    # ---- NTT=pallas: the k = 14 path with every basis change on kernel 8 ----
    pinned = vk.pinned_repr()
    zero_launches()
    mr_log = []
    with environ(NTT="pallas"):
        t1 = time.perf_counter()
        vk_mr = keygen_vk(params, circ.without_witnesses())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pk_mr = keygen_pk(params, vk_mr, circ.without_witnesses())
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        before = read_launches()
        original = ntt_mr.mr_col_ntt
        ntt_mr.mr_col_ntt = timed("mr_col_ntt", original, mr_log)
        reset_records()
        try:
            t4 = time.perf_counter()
            tr = Blake2bWrite(Vesta)
            create_proof(params, pk_mr, [circ], [[]], ChaCha20Rng(b"\x2a" * 32), tr)
            proof_mr = tr.finalize()
            torch.cuda.synchronize()
            t5 = time.perf_counter()
        finally:
            ntt_mr.mr_col_ntt = original
        mr_spans = get_records()
        per_proof_mr = diff(read_launches(), before)
        ok = verify_proof(params, vk_mr, [[]], Blake2bRead(Vesta, proof_mr))
        t6 = time.perf_counter()
    launches_mr = read_launches()
    require(ok is True, "k=14 NTT=pallas verify")
    require(vk_mr.pinned_repr() == pinned, "k=14 NTT=pallas pinned VK differs from the default route's")
    require(proof_mr == proof, "k=14 NTT=pallas proof bytes differ from the default route's")
    require(launches_mr["mr_col_ntt"] > 0 and per_proof_mr["mr_col_ntt"] > 0,
            "kernel 8 was not launched on the k=14 NTT=pallas path")
    require(launches_mr["cg_ntt_level"] == 0, "kernel 1 ran on the k=14 NTT=pallas path")
    mr_proof_ms = sum(start.elapsed_time(end) for _, start, end in mr_log)
    emit({"phase": "main_path_ntt_pallas", "circuit": "BenchCircuit", "k": k,
          "same_pinned_vk": True, "same_proof_bytes": True, "verified": True,
          "stages": dict(keygen_vk_s=t2 - t1, keygen_pk_s=t3 - t2, prove_s=t5 - t4, verify_s=t6 - t5),
          "default_route_prove_s": {"first": stages["prove_s"], "warm": warm_s},
          "prove_spans": mr_spans, "launches": launches_mr, "launches_per_proof": per_proof_mr,
          "mr_col_ntt_event_ms_per_proof": mr_proof_ms})

    t0 = time.perf_counter()
    params10 = ParamsIPA.cached(Vesta, 10, device=dev)
    circ = bench_circuit_for_k(10)
    vk = keygen_vk(params10, circ.without_witnesses())
    pk = keygen_pk(params10, vk, circ.without_witnesses())
    tr = Blake2bWrite(Vesta)
    create_proof(params10, pk, [circ], [[]], ChaCha20Rng(b"\x2a" * 32), tr)
    sha = hashlib.sha256(tr.finalize()).hexdigest()
    require(sha == BENCH_K10_PROOF_SHA256, f"k=10 proof sha256 {sha} != {BENCH_K10_PROOF_SHA256}")
    emit({"phase": "golden_k10", "exact": True, "seconds": time.perf_counter() - t0})
    # the same proof under the two other engines (bf16 Toeplitz products for mxu)
    for engine in ("pallas", "mxu"):
        t0 = time.perf_counter()
        with environ(NTT=engine, MXU_DTYPE=None):
            vk = keygen_vk(params10, circ.without_witnesses())
            pk = keygen_pk(params10, vk, circ.without_witnesses())
            tr = Blake2bWrite(Vesta)
            create_proof(params10, pk, [circ], [[]], ChaCha20Rng(b"\x2a" * 32), tr)
            sha = hashlib.sha256(tr.finalize()).hexdigest()
        require(sha == BENCH_K10_PROOF_SHA256, f"k=10 NTT={engine} proof sha256 {sha}")
        emit({"phase": "golden_k10", "ntt": engine, "exact": True, "seconds": time.perf_counter() - t0})

    # ---- the k = 16 path: BenchCircuit through the sorted-bucket MSM ----
    k = 16
    zero_launches()
    marks = {}
    t0 = time.perf_counter()
    params16 = ParamsIPA.cached(Vesta, k, device=dev)
    t1 = time.perf_counter()
    circ = bench_circuit_for_k(k)
    t2 = time.perf_counter()
    vk = keygen_vk(params16, circ.without_witnesses())
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    marks["keygen_vk"] = (read_launches(), read_routes())
    pk = keygen_pk(params16, vk, circ.without_witnesses())
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    marks["keygen_pk"] = (read_launches(), read_routes())
    # kernels 5-7 and the bucket MSM's kernels 2-4 timed by CUDA events through the proof
    sorted_log = []
    wrapped = ([(msm_sorted, name) for name in k16_kernels]
               + [(msm_bucket, name) for name in msm_bucket.LAUNCHES])
    originals = {name: getattr(mod, name) for mod, name in wrapped}
    for mod, name in wrapped:
        setattr(mod, name, timed(name, originals[name], sorted_log))
    reset_records()
    try:
        t5 = time.perf_counter()
        tr = Blake2bWrite(Vesta)
        create_proof(params16, pk, [circ], [[]], ChaCha20Rng(b"\x2a" * 32), tr)
        proof16 = tr.finalize()
        torch.cuda.synchronize()
        t6 = time.perf_counter()
    finally:
        for mod, name in wrapped:
            setattr(mod, name, originals[name])
    prove_spans16 = get_records()
    marks["prove"] = (read_launches(), read_routes())
    reset_records()
    ok = verify_proof(params16, vk, [[]], Blake2bRead(Vesta, proof16))
    t7 = time.perf_counter()
    verify_spans16 = get_records()
    marks["verify"] = (read_launches(), read_routes())
    require(ok is True, "k=16 verify")
    sha16 = hashlib.sha256(proof16).hexdigest()
    require(sha16 == BENCH_K16_PROOF_SHA256, f"k=16 proof sha256 {sha16} != {BENCH_K16_PROOF_SHA256}")
    launches16 = marks["verify"][0]
    routes16 = marks["verify"][1]
    stage_launches, stage_routes, prev = {}, {}, ({}, {})
    for stage, (counts, routes) in marks.items():
        stage_launches[stage] = diff(counts, prev[0])
        stage_routes[stage] = {key: c for key, c in diff(routes, prev[1]).items() if c}
        prev = (counts, routes)
    for stage in ("keygen_vk", "prove", "verify"):
        for name in k16_kernels:
            require(stage_launches[stage][name] > 0, f"{name} was not launched in k=16 {stage}")
    require(launches16["cg_ntt_level"] > 0, "kernel 1 was not launched on the k=16 path")
    overflows = {key: cnt for key, cnt in routes16.items() if key.endswith(":overflow")}
    require(not overflows, f"sorted-MSM overflows on the k=16 path: {overflows}")
    bad = bytearray(proof16)
    bad[len(bad) // 2] ^= 1
    try:
        rejected = verify_proof(params16, vk, [[]], Blake2bRead(Vesta, bytes(bad))) is not True
    except (OpeningError, TranscriptError):
        rejected = True
    require(rejected, "k=16 proof with a flipped byte was accepted")
    # the verifier's final MSM gets a list of host points: the host time to
    # make its bases and their row tables afresh, as msm() does per call
    t8 = time.perf_counter()
    MSMBases(Vesta, params16.g + [params16.w, params16.u], dev).device_rows(dev)
    torch.cuda.synchronize()
    host_bases_s = time.perf_counter() - t8
    k16_proof_ms = {name: 0.0 for name in originals}
    for name, start, end in sorted_log:
        k16_proof_ms[name] += start.elapsed_time(end)
    sorted_proof_ms = {name: k16_proof_ms[name] for name in k16_kernels}
    bucket_proof_ms = {name: k16_proof_ms[name] for name in msm_bucket.LAUNCHES}
    emit({"phase": "main_path_k16", "circuit": "BenchCircuit", "k": k, "rows": circ.rows,
          "proof_bytes": len(proof16), "verified": True, "flipped_byte_rejected": True,
          "stages": dict(params_read_s=t1 - t0, synthesis_setup_s=t2 - t1, keygen_vk_s=t3 - t2,
                         keygen_pk_s=t4 - t3, prove_s=t6 - t5, verify_s=t7 - t6),
          "prove_spans": prove_spans16, "verify_spans": verify_spans16,
          "verifier_host_bases_s": host_bases_s, "launches": launches16,
          "launches_by_stage": stage_launches, "routes": routes16,
          "routes_by_stage": stage_routes,
          "sorted_overflows": sum(overflows.values()),
          "sorted_kernels_event_ms_per_proof": sorted_proof_ms,
          "bucket_kernels_event_ms_per_proof": bucket_proof_ms,
          "bucket_launches_by_stage": {stage: {name: counts[name] for name in msm_bucket.LAUNCHES}
                                       for stage, counts in stage_launches.items()}})

    # the same proof with the sorted MSM switched off: the same bytes; then
    # once more with it on, so that both timed proofs are warm
    def prove16():
        reset_records()
        t0 = time.perf_counter()
        tr = Blake2bWrite(Vesta)
        create_proof(params16, pk, [circ], [[]], ChaCha20Rng(b"\x2a" * 32), tr)
        out = tr.finalize()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, get_records()

    zero_launches()
    saved = msm_mod.SORTED_MSM_MIN
    msm_mod.SORTED_MSM_MIN = 1 << 18
    try:
        unsorted_proof, unsorted_s, unsorted_spans = prove16()
    finally:
        msm_mod.SORTED_MSM_MIN = saved
    require(unsorted_proof == proof16, "k=16 proof bytes differ with the sorted MSM switched off")
    require(all(msm_sorted.LAUNCHES[name] == 0 for name in k16_kernels),
            "the sorted MSM ran while switched off")
    unsorted_launches = read_launches()
    zero_launches()
    warm_proof, warm_s, warm_spans = prove16()
    require(warm_proof == proof16, "warm k=16 proof bytes differ from the first")
    msm_span = f"msm n={(1 << k) + 1}"
    emit({"phase": "k16_unsorted_same_bytes", "exact": True,
          "prove_s": {"sorted_first": t6 - t5, "unsorted_warm": unsorted_s, "sorted_warm": warm_s},
          "msm_span_s": {"sorted_first": prove_spans16.get(msm_span),
                         "unsorted_warm": unsorted_spans.get(msm_span),
                         "sorted_warm": warm_spans.get(msm_span)},
          "launches": {"unsorted_warm": unsorted_launches, "sorted_warm": read_launches()}})

    # the k = 16 params: commit_lagrange(v) = commit(intt(v)), both sorted
    zero_launches()
    n16 = 1 << 16
    omega = pow(Fp.ROOT_OF_UNITY, 1 << (Fp.S - k), q)
    values = sctx.to_mont(rand_canon((n16,)))
    coeffs = sctx.mul(ntt_cg.CgNttPlan(Fp, k, pow(omega, -1, q))(values), sctx.const(pow(n16, -1, q), dev))
    blind = Blind(int(rng.integers(1, 1 << 62)))
    lhs = params16.commit_lagrange(sctx.decode_ints(values), blind)
    rhs = params16.commit(sctx.decode_ints(coeffs), blind)
    require(lhs == rhs, "k=16 params: commit_lagrange(v) != commit(intt(v))")
    require(read_routes() == {"commit:sorted": 1, "commit_lagrange:sorted": 1},
            f"k=16 params check did not take the sorted MSM: {read_routes()}")
    emit({"phase": "params_k16", "lagrange_equals_monomial": True, "routes": read_routes()})

    # ---- kernels 5-7: sorted MSM at n = 2^16 + 1 on the k = 16 bases ----
    t0 = time.perf_counter()
    n = n16 + 1
    bases = params16._bases_g  # g ++ [w]
    canon = rand_canon((n,))
    edge = [0, 1, q - 1, 1 << 15, ((1 << 15) << 48) % q, (1 << 16) - 1]
    canon[: len(edge)] = torch.as_tensor(
        np.frombuffer(b"".join(v.to_bytes(32, "little") for v in edge), dtype="<u2")
        .reshape(len(edge), 16).astype(np.int32), device=dev)
    px, py = bases.device_rows(dev)
    classes = msm_sorted._cap_classes(n, msm_sorted.LANES, msm_sorted.KB, q)
    entries, gstart, overflow = msm_sorted.prestage(canon, 16, classes)
    require(not bool(overflow), "random scalars overflowed the sorted MSM")
    bk = msm_sorted.msm_sorted_accum(entries, gstart, px, py, cc)
    bp = msm_sorted.msm_sorted_accum_plain(entries, gstart, px, py, cc)
    same("msm_sorted_accum", bk, bp, pctx, "msm_sorted_accum: kernel != plain")
    wk = msm_sorted.msm_sorted_fold(bk, entries, gstart, px, py, cc)
    wp = msm_sorted.msm_sorted_fold_plain(bk, entries, gstart, px, py, cc)
    same("msm_sorted_fold", wk, wp, pctx, "msm_sorted_fold: kernel != plain")
    hk = msm_sorted.msm_sorted_horner(wk, cc)
    hp = msm_sorted.msm_sorted_horner_plain(wk, cc)
    require(torch.equal(hk, hp), "msm_sorted_horner: kernel != plain (limbs)")
    same("msm_sorted_horner", hk, hp, pctx, "msm_sorted_horner: kernel != plain")
    # kernel 7 on edge windows: identity windows (the top one, a run, the
    # bottom; one with Z = p), all identity, equal windows (2^16 W_15 meets
    # W_14 = 2^16 W_15: P + P inside the addition) and opposite ones (it meets
    # -(2^16 W_15)); projective, each point scaled by its own lambda
    gen = Vesta.generator()
    base_pts = [gen.mul(int(rng.integers(1, 1 << 62))) for _ in range(16)]
    ident = Vesta.identity()
    cases = {"identity_windows": [ident if w in (15, 14, 9, 8, 7, 0) else pt
                                  for w, pt in enumerate(base_pts)],
             "all_identity": [ident] * 16,
             "equal_windows": base_pts[:14] + [base_pts[15].mul(1 << 16), base_pts[15]],
             "opposite_windows": base_pts[:14] + [-base_pts[15].mul(1 << 16), base_pts[15]]}
    edge_wins = []
    for case, pts in cases.items():
        pv = cc.encode_points(pts, dev)
        lam = pctx.consts([int(rng.integers(2, 1 << 62)) for _ in range(16)], dev)
        ew = torch.stack([pctx.mul(t, lam) for t in pv], dim=1).contiguous()
        if case == "identity_windows":
            ew[9, 2] = torch.as_tensor(ints_to_limbs([Vesta.p()])[0], device=dev)
        want = ident
        for pt in reversed(pts):
            want = want.mul(1 << 16) + pt
        ek = msm_sorted.msm_sorted_horner(ew, cc)
        require(cc.decode_points(PointVec(ek[None, 0], ek[None, 1], ek[None, 2]))[0] == want,
                f"msm_sorted_horner {case}: != sum_w 2^(16 w) W_w on the host")
        edge_wins.append((case, ew, ek))
    # the plain version takes the four cases as one batch of independent chains
    ep = msm_sorted.msm_sorted_horner_plain(torch.stack([ew for _, ew, _ in edge_wins], 1), cc)
    for i, (case, _, ek) in enumerate(edge_wins):
        require(torch.equal(ek, ep[i]), f"msm_sorted_horner {case}: kernel != plain (limbs)")
        same("msm_sorted_horner", ek, ep[i], pctx, f"msm_sorted_horner {case}: kernel != plain")
    got = msm_sorted.msm_sorted(canon, bases)
    t1 = time.perf_counter()
    want = msm_host(limbs_to_ints(canon.cpu()), bases.host_points[:n], Vesta)
    host_s = time.perf_counter() - t1
    require(got == want, "sorted MSM n=2^16+1 != msm_host")
    require(got == msm_bucket.msm_bucket_many(canon[None], bases, mont=False)[0],
            "sorted MSM n=2^16+1 != bucket MSM")
    # scalars below 2^127 with zero rows: windows 8-15 empty (their buckets and
    # sums the identity), window 7's digits non-negative and spread over all
    # lanes (its limb below 2^15 - 1 carries nothing into window 8)
    low = rand_canon((n,))
    low[:, 7] %= 0x7FFF
    low[:, 8:] = 0
    low[:5] = 0
    le, lg, lo = msm_sorted.prestage(low, 16, classes)
    require(not bool(lo), "scalars below 2^127 overflowed the sorted MSM")
    lbk = msm_sorted.msm_sorted_accum(le, lg, px, py, cc)
    same("msm_sorted_accum", lbk, msm_sorted.msm_sorted_accum_plain(le, lg, px, py, cc), pctx,
         "msm_sorted_accum (scalars below 2^127): kernel != plain")
    lwk = msm_sorted.msm_sorted_fold(lbk, le, lg, px, py, cc)
    same("msm_sorted_fold", lwk, msm_sorted.msm_sorted_fold_plain(lbk, le, lg, px, py, cc), pctx,
         "msm_sorted_fold (scalars below 2^127): kernel != plain")
    require(all(p.is_identity() for p in cc.decode_points(PointVec(lwk[8:, 0], lwk[8:, 1], lwk[8:, 2]))),
            "empty windows 8-15 gave a window sum")
    require(msm_sorted.msm_sorted(low, bases)
            == msm_bucket.msm_bucket_many(low[None], bases, mont=False)[0],
            "sorted MSM of scalars below 2^127 != bucket MSM")
    gcnt = (gstart[:, 1:] - gstart[:, :-1]).long()
    # The work sum_w 2^(16 w) sum_b b * S_b needs on this data, counted from
    # the digits: a point into an empty bucket is a copy, each later one a
    # mixed addition; the side list (|e| = 2^15) is bucket 2^15; per window a
    # running sum from the highest occupied bucket down, run += S_b over the
    # occupied buckets and total += run at every bucket below the top, the
    # first of each a copy; then Horner's 16 doublings and one addition per
    # window below the top.
    nb = 1 << msm_sorted.BUCKET_BITS
    digits = msm_sorted._recode_signed(canon, 16).abs().long()
    per_bucket = torch.zeros((16, nb + 1), dtype=torch.long, device=dev)
    per_bucket.scatter_add_(1, digits, torch.ones_like(digits))
    occ = per_bucket[:, 1:] > 0  # buckets 1 .. 2^15
    accum_mixed = int(per_bucket[:, 1:nb].sum() - occ[:, : nb - 1].sum())
    side_mixed = int((per_bucket[:, nb] - 1).clamp(min=0).sum())
    top = (occ * torch.arange(1, nb + 1, device=dev)).amax(-1)
    fold_adds = int(((occ.sum(-1) - 1).clamp(min=0) + (top - 1).clamp(min=0)).sum())
    horner_adds, horner_dbls = 15, 15 * 16
    mul = mont_mul_instrs(pctx.p_int)
    work = {
        "msm_sorted_accum": mul * MIXED_ADD_PRODUCTS * accum_mixed,
        "msm_sorted_fold": mul * (MIXED_ADD_PRODUCTS * side_mixed + FULL_ADD_PRODUCTS * fold_adds),
        "msm_sorted_horner": mul * (FULL_ADD_PRODUCTS * horner_adds + DOUBLE_PRODUCTS * horner_dbls),
    }
    emit({"phase": "msm_sorted", "n": n, "exact": True, "host_checked": True, "msm_host_s": host_s,
          "nonzero_digits": int(gcnt.sum()), "side_points": int(gcnt[:, msm_sorted.LANES].sum()),
          "max_lane": int(gcnt[:, : msm_sorted.LANES].max()), "caps": classes,
          "occupied_buckets": int(occ.sum()), "accum_mixed_adds": accum_mixed,
          "fold_side_mixed_adds": side_mixed, "fold_adds": fold_adds,
          "horner_adds": horner_adds, "horner_doublings": horner_dbls,
          "seconds": time.perf_counter() - t0})

    # the two routes of msm() for one MSM of 2^16 + 1 points, on the same
    # scalars and bases, each ending in its host readback
    route_ms = {
        "sorted": time_ms(lambda: msm_sorted.msm_sorted(canon, bases)),
        "sorted_prestage": time_ms(lambda: msm_sorted.prestage(canon, 16, classes)),
        "bucket": time_ms(lambda: msm_bucket.msm_bucket_many(canon[None], bases, mont=False)),
    }
    emit({"phase": "msm_routes", "n": n, "ms": route_ms,
          "bucket_geometry": msm_bucket.msm_geometry(Vesta, n, dev)[:3]})

    inputs = 4 * (entries.numel() + gstart.numel() + 2 * n * 16)
    timings = {
        "msm_sorted_accum": (
            lambda: msm_sorted.msm_sorted_accum(entries, gstart, px, py, cc),
            lambda: msm_sorted.msm_sorted_accum_plain(entries, gstart, px, py, cc),
            inputs + 4 * bk.numel(), "halo2_tpu/ops/msm_sorted.py:275"),
        "msm_sorted_fold": (
            lambda: msm_sorted.msm_sorted_fold(bk, entries, gstart, px, py, cc),
            lambda: msm_sorted.msm_sorted_fold_plain(bk, entries, gstart, px, py, cc),
            4 * (bk.numel() + wk.numel() + gstart.numel() + 32 * int(gcnt[:, msm_sorted.LANES].sum())),
            "halo2_tpu/ops/msm_sorted.py:433"),
        "msm_sorted_horner": (
            lambda: msm_sorted.msm_sorted_horner(wk, cc),
            lambda: msm_sorted.msm_sorted_horner_plain(wk, cc),
            4 * (wk.numel() + hk.numel()), "halo2_tpu/ops/msm_sorted.py:497"),
    }
    for name, (kfn, pfn, nbytes, replaces) in timings.items():
        b_ms, b_by = bound(nbytes, work[name])
        report[name] = dict(
            route="cuda", source="halo2_tpu_torch/csrc/msm_sorted.cu", replaces=replaces,
            ms=time_ms(kfn), device_ms=device_ms(kfn, 5), plain_ms=time_ms(pfn, 1),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=None, shape=f"n={n} nw=16 W={msm_sorted.LANES} KB={msm_sorted.KB}",
        )
        emit({"phase": "time", "kernel": name, **report[name]})

    # each kernel's main path: its launches there and its CUDA-event time in one proof
    paths = {name: ("k14", launches, proof_ms) for name in k14_kernels}
    paths.update({name: ("k16", launches16, sorted_proof_ms) for name in k16_kernels})
    paths["mr_col_ntt"] = ("k14 NTT=pallas", launches_mr, {"mr_col_ntt": mr_proof_ms})
    paths.update({name: ("profile_kernels tilemul", tile_launches, {}) for name in tool_kernels})
    kernels = []
    for name, rec in report.items():
        path, counts, per_proof = paths[name]
        kernels.append({"name": name, "route": rec["route"], "source": rec["source"],
                        "replaces": rec["replaces"], "launches": counts[name], "main_path": path,
                        "max_abs_err": errs[name], "ms": rec["ms"], "device_ms": rec["device_ms"],
                        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                        "shape": rec["shape"], "ms_per_warm_proof": per_proof.get(name),
                        **({"registers": rec["registers"]} if "registers" in rec else {}),
                        **({"at_c8": rec["at_c8"], "ms_per_k16_proof": bucket_proof_ms[name],
                            "launches_k16": launches16[name]} if "at_c8" in rec else {}),
                        **({"levels": rec["levels"], "launches_k16": launches16[name]}
                           if "levels" in rec else {})})
    require(sorted(report) == sorted(paths), "every kernel has a report row")
    require(len(report) == 10, "ten kernels")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
