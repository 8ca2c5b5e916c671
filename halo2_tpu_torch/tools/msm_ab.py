"""Times the bucket MSM's kernels 2-4, the sorted MSM's kernels 5-7 and the
BenchCircuit proofs of one tree of this repository (with `--ntt`, the NTT
kernels 1 and 8 and kernels 9-10; with `--tile`, kernels 9 and 10), so that
two trees (a parent commit unpacked beside the checkout, and the checkout)
can be read on one card in one run.

    python3 halo2_tpu_torch/tools/msm_ab.py [--tree DIR] [--sorted] [--ntt] [--tile] [--fold]
                                            [--jit M] [--sites] [--sweep] [--trace] [--proofs]

It imports `halo2_tpu_torch` from DIR (default: the checkout this file lies
in), so run it as a script, not with `-m`. It prints one JSON line per
shape and, with `--proofs`, per proof:

- the kernels alone at the k = 14 commit shape (M = 3, n = 2^14 + 1, c = 4)
  and at M = 2, n = 2^15, c = 8 (bases of the k = 14 params, scalars from a
  numpy seed): the median CUDA-event time of each kernel over 5 warm
  launches and its device time (`device_ms`: per call of calls replayed from
  one CUDA graph, without the host's launch time), the sha256 of the bucket
  tensor (the bytes kernel 2 writes, in the first port's (rows, B, 3, 16, T)
  order whatever the tree's layout), of the window sums as affine points
  (the group elements kernels 3 and 4 give, whatever their projective
  coordinates) and of kernel 4's output limbs (its projective coordinates,
  which kernel 4's redesign keeps bit for bit); with `--sweep` (trees that
  have LANE_REDUCE_THREADS), kernel 4's device time at each block size of
  LANE_REDUCE_SWEEP, each output checked against the default's bit for bit;
- with `--sorted`, in place of those two shapes: the sorted MSM at
  n = 2^16 + 1 on the k = 16 params' bases (g ++ [w]), for uniform scalars
  below q with the edge scalars in the first rows, and for scalars below
  2^127 (windows 8-15 empty) with zero rows: the median CUDA-event time of
  kernels 5, 6 and 7 (and their device times) and of the pre-stage, the
  sorted route and the bucket route (each route ending in its host
  readback), the sha256 of kernel 5's
  bucket tensor (nw, W, KB, 3, 16) and of kernel 6's window sums as affine
  points, whether kernels 5 and 6 equal their plain versions (canonical
  values) and whether the sorted MSM equals the bucket MSM; with `--sweep`
  (trees that have ACCUM_GEOMETRY and FOLD_GEOMETRY), kernels 5 and 6 timed
  at each geometry of ACCUM_SWEEP and FOLD_SWEEP on the uniform scalars,
  each checked against the default geometry's buckets (bit for bit) or
  window sums (as affine points);
- with `--ntt`, in place of the bucket shapes: the constant-geometry NTT
  (kernel 1) and the mixed-radix NTT (kernel 8, `NTT=pallas`) on Fp at 2^14
  and 2^16, forward, on values from a numpy seed: for each, the median
  CUDA-event time and the device time at each level of the plan, in the
  tree's own level contract ((B, f, g) columns, perm at the last level,
  since the kernel's redesign; (cols, f) columns before it, with the
  transposes in torch), and of the whole transform, the device kernels one
  transform launches (a torch.profiler
  count: the kernel's launches and any torch copy around them) and the
  sha256 of the transform's output limbs, which must be equal on the parent
  and the change; with `--sweep`, for each engine in the (B, f, g)
  contract, the device time of every level and of the transform at each
  LEVEL_SWEEP block size (its LEVEL_THREADS), the output checked bit for bit
  against the default's, and kernel 1's transform at each MAX_LOG_F of
  NTT_LOG_F_SWEEP (checked as canonical values: other levels leave other
  representatives); and, to show that the kernels it leaves alone keep
  their times, kernels 9 and 10 through the profiling tool's `tilemul` at
  2^18 elements;
- with `--tile`, in place of the bucket shapes: kernels 9 and 10 through
  the profiling tool's `tilemul` inputs at 2^18 elements (canonical values
  below 2^254 from its numpy seed, the same on every tree): for each, the
  median CUDA-event time and the device time, the sha256 of kernel 9's
  output limbs, which must be equal on the parent and the change, and of
  kernel 10's outputs as limbs and as canonical values (its multiply by
  3b = 15 as 16 x - x leaves other representatives than the parent's
  Montgomery product, so only the canonical hash must be equal), whether
  each equals its plain version (kernel 9 on limbs, kernel 10 on canonical
  values), the `-Xptxas -v` lines of the build of the library it loaded
  (entry function, spills, registers; a tree whose logs are not keyed to
  their library reports them only while its build directory holds one
  tile_bench library) and the SASS instruction mix of the two kernels as the
  tree launches them on Pallas (`cuobjdump -sass` of its library:
  instructions by opcode); with `--sweep` (trees whose build takes `-D`
  defines), csrc/tile_bench.cu built again at each pair of TILE_SWEEP
  (kernel 9's and kernel 10's threads a block and min blocks an SM), and for
  each the registers and spills, and the device time of each kernel with
  its output checked against the default build's (kernel 9 on limbs, kernel
  10 on canonical values);
- with `--fold`, in place of the bucket shapes: kernel B (the quotient
  fold) on part 0 of the first proof of each of k14 (BenchCircuit at
  k = 14), poseidon11, sinsemilla14 and sha256_k17, the fold's inputs
  captured as chip_smoke.py's `fold_capture` captures them: the program's
  instructions, products, live slots, columns and (trees that bundle them)
  bundles, kernel B's median CUDA-event ms and device ms, its bound and
  x bound (chip_smoke.py's formula, this checkout's copy for every tree),
  the scalar table's device ms, the sha256 of kernel B's output limbs
  (clusters in order), which must be equal on the parent and the change,
  the proof's sha256 and prove seconds, and the launches of kernels A and B
  inside the proof's "evaluate_h + vanishing" span; with `--sweep` (trees
  whose scheduler has WINDOW), the k14 and sinsemilla14 programs scheduled
  at every width of FOLD_WIDTH_SWEEP (each a build of csrc/fold.cu with
  FOLD_WIDTH) and window of FOLD_WINDOW_SWEEP: bundles, live slots, device
  ms and whether the output equals the default's bit for bit; with
  `--trace`, the sha256_k17 proof's "evaluate_h + vanishing" span traced by
  torch.profiler and cProfile: its wall seconds, device busy ms, the host's
  share, the device ms of the kernels by name, the host ops' self CPU ms
  and the port's Python functions by cumulative seconds;
- with `--jit M`, in place of the bucket shapes: the JAX package's jitted
  scans, evaluations, Kate division and IPA rounds as the tree computes
  them (kernels C-F, or rounds of kernel A before them) on Fp at 2^14 rows
  from a numpy seed: prefix_product, exclusive_prefix_product from an
  init, batch_invert, batch_eval_mont of M polynomials at four points and
  of one polynomial at one point ("_m1"), device_powers of a point on the
  card, point_powers of a host point (device_powers of it on a tree
  without point_powers), kate_division_mont, an IPA round's emit and fold
  at m = n, and one round ("round": the fold at m = n and the emit at
  m / 2, round_fold_emit where the tree has it, else the two calls): each
  call's median CUDA-event ms, whether it waits for the card (a copy to or
  from the host under torch.cuda.set_sync_debug_mode), its device ms (None
  where it waits: a CUDA graph cannot hold it), the card's busy ms in one
  call (the traced durations of its device operations, which a call that
  waits has too), kernel A's launches, the
  device kernels it launches (a torch.profiler count) and the sha256 of
  its output's canonical values, which must be equal on the parent and the
  change; the scans, Kate division, the evaluations, the powers and the
  round also at 2^17 rows (names ending in "_2^17"), the prefix product and
  batch inversion of one row (a launch's fixed cost, and the inverse of the
  total; "_n1"); and the grand products' z columns and the Horner fold as
  the tree computes them (kernels G and H, or its provers' z columns and its
  stacked fold on kernels A and C before them): a lookup's z column, a
  permutation chunk's of 2 and of 6 columns, a proof's z columns
  ("z_columns": BenchCircuit's lookup and chunk of 2 columns, one call of
  kernel G where the tree has `z_columns`, else a call a column;
  "z_columns_5": two lookups and three chained chunks of 6 columns) and
  the fold of 3 pieces, at 2^14 and (but the 6 columns) 2^17; with
  `--sweep` (trees whose scans take
  SCAN_ROWS / SCAN_THREADS), csrc/scan.cu and csrc/polyeval.cu built again
  at each (rows a thread, threads a tile) of SCAN_SWEEP, and for each the
  device ms of those calls at 2^14 and 2^17, whether each output's
  canonical sha256 equals the default build's, and the kernels' registers
  and spills; and (trees whose kernel D has eval_geometry) kernel D's
  calls at each (groups, rows a thread) of EVAL_GEOMETRY_SWEEP, the same
  way;
- with `--sites`, in place of the bucket shapes: kernel A's launches in a
  first and a warm BenchCircuit k = 14 proof by call site (the calling
  function, as this checkout's chip_smoke.kernel_a_sites names it), with the
  proof's sha256 and the launches of kernels C-H that the tree has, and the
  seconds of the host loop that built omega^i for every proof before kernel
  G (ops/ntt.py powers at 2^14);
- BenchCircuit at k = 14 (a first and a warm proof) and k = 16 (seed 42,
  `ChaCha20Rng(b"\\x2a" * 32)`): the sha256 of the proof, prove seconds,
  kernels 2-7's launches and CUDA-event milliseconds in the proof, and the
  host seconds and calls of kernel D's entry points in it (HostSeconds).

It needs a CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import cProfile
import hashlib
import json
import os
import pstats
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("msm_accum", "msm_fold", "msm_lane_reduce")
SORTED_KERNELS = ("msm_sorted_accum", "msm_sorted_fold", "msm_sorted_horner")
# (lanes, threads) a block of kernel 5: from about a bucket a thread (1, 32)
# to runs of about 16 points (32 lanes, 128 threads)
ACCUM_SWEEP = ((1, 32), (2, 64), (4, 64), (4, 128), (8, 64), (8, 128), (16, 64), (16, 128),
               (32, 64), (32, 128))
# (l, threads) of kernel 6: segments of 2^l buckets, 1-32 blocks a window
FOLD_SWEEP = ((2, 256), (3, 128), (3, 256), (4, 64), (4, 128), (4, 256), (5, 32), (5, 64),
              (5, 128))
# threads a block of kernel 1 (f/2 a column), and the largest level size 2^MAX_LOG_F
LEVEL_SWEEP = (32, 64, 128, 256, 512)
# threads a block of kernel 4 (a row a block, 4 lanes an addition at the first level)
LANE_REDUCE_SWEEP = (64, 128, 256)
NTT_LOG_F_SWEEP = (6, 7, 8, 9)
# kernel B's bundle widths (each a build of csrc/fold.cu with FOLD_WIDTH)
# and the scheduler's lookahead windows
FOLD_WIDTH_SWEEP = (2, 4, 8)
# (rows a thread, threads a tile) of kernels C and E's one-pass scans, each a
# build of csrc/scan.cu and csrc/polyeval.cu; the default is (2, 128)
SCAN_SWEEP = ((1, 256), (1, 512), (2, 128), (2, 256), (4, 128), (4, 256))
FOLD_WINDOW_SWEEP = (32, 64, 128)
# kernel D's (groups of threads a block, rows a thread), in place of the
# ones its wrapper chooses from the shape
EVAL_GEOMETRY_SWEEP = ((1, 1), (1, 2), (1, 4), (2, 1), (2, 2), (4, 1), (4, 2))
# (kernel 9's, kernel 10's) (threads a block, min blocks an SM of
# __launch_bounds__), one build of csrc/tile_bench.cu each; the default
# build's are (256, 1) and (256, 2)
TILE_SWEEP = (((128, 1), (128, 3)), ((256, 1), (128, 4)), ((512, 1), (256, 1)),
              ((1024, 1), (256, 2)))


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


def device_ms(fn, reps: int = 20) -> float:
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
    with torch.cuda.graph(graph, stream=side):  # the stream the calls warmed up on
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sorted_section(params16, msm_bucket, msm_sorted, dev, rng, sweep: bool = False,
                   n: int = (1 << 16) + 1) -> None:
    """Kernels 5-7, the pre-stage and both routes at n points (see the
    module's docstring); the modules are the tree's own."""
    from halo2_tpu_torch.ops.curve import PointVec
    from halo2_tpu_torch.ops.field import from_mont

    bases = params16._bases_g  # g ++ [w]
    cc = bases.cc

    def affine(wk):
        return [p.xy for p in cc.decode_points(PointVec(wk[:, 0], wk[:, 1], wk[:, 2]))]

    def canon_equal(a, b):
        return torch.equal(from_mont(a.reshape(-1, 16), cc.fctx), from_mont(b.reshape(-1, 16), cc.fctx))

    q = bases.curve.SCALAR.MODULUS
    px, py = bases.device_rows(dev)
    classes = msm_sorted._cap_classes(n, msm_sorted.LANES, msm_sorted.KB, q)
    edge = [0, 1, q - 1, 1 << 15, ((1 << 15) << 48) % q, (1 << 16) - 1]
    uniform = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.int64)
    uniform[:, 15] &= 0x3FFF  # below q
    uniform[: len(edge)] = np.frombuffer(
        b"".join(v.to_bytes(32, "little") for v in edge), dtype="<u2").reshape(len(edge), 16)
    low = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.int64)
    low[:, 7] %= 0x7FFF  # window 7 uniform over its lanes, no carry into window 8
    low[:, 8:] = 0
    low[:5] = 0
    for label, limbs in (("uniform", uniform), ("below_2^127", low)):
        canon = torch.as_tensor(limbs.astype(np.int32), device=dev)
        entries, gstart, overflow = msm_sorted.prestage(canon, 16, classes)

        def accum():
            return msm_sorted.msm_sorted_accum(entries, gstart, px, py, cc)

        def fold():
            return msm_sorted.msm_sorted_fold(bk, entries, gstart, px, py, cc)

        bk = accum()
        wk = fold()
        wins = affine(wk)
        got = msm_sorted.msm_sorted(canon, bases)
        row = {"sorted_shape": label, "n": n, "overflow": bool(overflow),
               "buckets_sha256": hashlib.sha256(bk.contiguous().cpu().numpy().tobytes()).hexdigest(),
               "window_sums_affine_sha256": hashlib.sha256(repr(wins).encode()).hexdigest(),
               "msm_affine": repr(got.xy),
               "kernels_equal_plain": {
                   "msm_sorted_accum": canon_equal(
                       bk, msm_sorted.msm_sorted_accum_plain(entries, gstart, px, py, cc)),
                   "msm_sorted_fold": canon_equal(
                       wk, msm_sorted.msm_sorted_fold_plain(bk, entries, gstart, px, py, cc))},
               "equals_bucket_msm": got == msm_bucket.msm_bucket_many(canon[None], bases, mont=False)[0]}
        if label == "uniform":
            row["ms"] = {
                "prestage": time_ms(lambda: msm_sorted.prestage(canon, 16, classes)),
                "msm_sorted_accum": time_ms(accum),
                "msm_sorted_fold": time_ms(fold),
                "msm_sorted_horner": time_ms(lambda: msm_sorted.msm_sorted_horner(wk, cc)),
                "device": {"msm_sorted_accum": device_ms(accum, 5), "msm_sorted_fold": device_ms(fold, 5),
                           "msm_sorted_horner": device_ms(
                               lambda: msm_sorted.msm_sorted_horner(wk, cc), 5)},
                "route_sorted": time_ms(lambda: msm_sorted.msm_sorted(canon, bases)),
                "route_bucket": time_ms(lambda: msm_bucket.msm_bucket_many(canon[None], bases, mont=False)),
            }
        emit(row)
        if sweep and label == "uniform" and hasattr(msm_sorted, "FOLD_GEOMETRY"):
            default = msm_sorted.ACCUM_GEOMETRY, msm_sorted.FOLD_GEOMETRY
            try:
                for geo in ACCUM_SWEEP:
                    msm_sorted.ACCUM_GEOMETRY = geo
                    emit({"sweep": "msm_sorted_accum", "lanes_threads": geo,
                          "same_buckets": torch.equal(accum(), bk), "ms": time_ms(accum)})
                msm_sorted.ACCUM_GEOMETRY = default[0]
                for geo in FOLD_SWEEP:
                    msm_sorted.FOLD_GEOMETRY = geo
                    emit({"sweep": "msm_sorted_fold", "l_threads": geo,
                          "same_window_sums": affine(fold()) == wins, "ms": time_ms(fold)})
            finally:
                msm_sorted.ACCUM_GEOMETRY, msm_sorted.FOLD_GEOMETRY = default


def self_chip_smoke():
    """This checkout's chip_smoke.py (its bound and capture helpers), loaded
    by path, so that both trees are measured by one formula."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(HERE)), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_self", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class SpanLaunches:
    """Wraps utils.measure.span: the kernel A and kernel B launches inside
    each span named `name`, and with `profile`, a torch.profiler trace of
    the first such span."""

    def __init__(self, measure, field_ew, fold_mod, name, profile=False):
        self.measure, self.field_ew, self.fold_mod = measure, field_ew, fold_mod
        self.name, self.profile = name, profile
        self.original = measure.span
        self.counts = {"field_ew": 0, "fold_program": 0}
        self.prof, self.wall_s, self.host_profile = None, None, None

    def read(self):
        return sum(self.field_ew.LAUNCHES.values()), self.fold_mod.LAUNCHES["fold_program"]

    def __enter__(self):
        outer = self

        class Span:
            def __init__(self, name, *args, **kwargs):
                self.inner = outer.original(name, *args, **kwargs)
                self.mine = name == outer.name

            def __enter__(self):
                if self.mine:
                    if outer.profile and outer.prof is None:
                        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                        self.prof = torch.profiler.profile(activities=acts)
                        self.cprof = cProfile.Profile()
                        torch.cuda.synchronize()
                        self.prof.__enter__()
                        self.cprof.enable()
                        self.t0 = time.perf_counter()
                    self.before = outer.read()
                return self.inner.__enter__()

            def __exit__(self, *exc):
                out = self.inner.__exit__(*exc)
                if self.mine:
                    after = outer.read()
                    outer.counts["field_ew"] += after[0] - self.before[0]
                    outer.counts["fold_program"] += after[1] - self.before[1]
                    if getattr(self, "prof", None) is not None:
                        torch.cuda.synchronize()
                        outer.wall_s = time.perf_counter() - self.t0
                        self.cprof.disable()
                        self.prof.__exit__(None, None, None)
                        outer.prof = self.prof
                        outer.host_profile = host_functions(self.cprof)
                return out

        self.measure.span = Span
        return self

    def __exit__(self, *exc):
        self.measure.span = self.original


def trace_summary(prof, wall_s: float, spans, top: int = 15) -> dict:
    """A quotient stage's trace: wall seconds, device busy ms (every kernel
    and copy on the card; the spans' annotations on the device's timeline,
    named as in `spans`, left out), the host's share of the wall time, the
    device ms of the kernels by name, and the spans' and host ops' self CPU
    ms (a span's self time is host work in no torch op)."""
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False) and e.name not in spans]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    by_kernel = collections.Counter()
    launches = collections.Counter()
    for e in dev:
        by_kernel[e.name] += e.time_range.elapsed_us() / 1e3
        launches[e.name] += 1
    host = collections.Counter()
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host[e.key] += e.self_cpu_time_total / 1e3
    return {"wall_s": wall_s, "device_events": len(dev), "device_busy_ms": busy_ms,
            "host_share": 1 - busy_ms / 1e3 / wall_s,
            "device_ms_by_kernel": [(k[:120], v, launches[k]) for k, v in by_kernel.most_common(top)],
            "host_self_cpu_ms": [(k[:120], v) for k, v in host.most_common(top)]}


def host_functions(cprof, top: int = 20) -> list:
    """The port's Python functions by cumulative seconds in a cProfile run:
    (file:line function, calls, cumulative s, own s)."""
    stats = pstats.Stats(cprof).stats
    rows = [(f"{os.path.relpath(fn, os.path.dirname(os.path.dirname(HERE)))}:{line} {name}", cc, ct, tt)
            for (fn, line, name), (cc, _nc, tt, ct, _callers) in stats.items()
            if "halo2_tpu_torch" in fn]
    return sorted(rows, key=lambda r: -r[2])[:top]


def jit_section(dev, eval_m: int, log_n: int = 14, sweep: bool = False) -> None:
    """The scans, evaluations, powers, Kate division and IPA rounds of the
    tree on Fp at 2^log_n, and at 2^17 (see the module's docstring); the
    modules are the tree's own: kernels C-F where the tree has them, rounds
    of kernel A before."""
    from halo2_tpu_torch.fields import Fp
    from halo2_tpu_torch.ops import field_ew, polyeval, scan
    from halo2_tpu_torch.ops.field import FieldCtx, from_mont

    try:
        from halo2_tpu_torch.ops.ipa_round import round_emit, round_fold
    except ImportError:  # before kernel F: the rounds in poly/ipa
        from halo2_tpu_torch.poly.ipa import _round_emit as round_emit, _round_fold as round_fold
    try:
        from halo2_tpu_torch.ops.ipa_round import round_fold_emit
    except ImportError:  # before the fused round: the fold, then the emit

        def round_fold_emit(pp, b, s, m, u, uinv, z, rands, ctx):
            pp, b, s = round_fold(pp, b, s, m, u, uinv, ctx)
            return pp, b, s, round_emit(pp, b, s, m // 2, z, rands, ctx)
    ctx, p, n = FieldCtx(Fp), Fp.MODULUS, 1 << log_n
    lookup_z, perm_z, horner_fold, proof_z = z_columns(Fp, ctx, dev)
    point_powers = getattr(polyeval, "point_powers", None)
    if point_powers is None:  # before the powers of a host point

        def point_powers(ctx, x, n, device):
            return polyeval.device_powers(ctx.const(x, device), n, ctx)
    rng = np.random.default_rng(20261024)

    def rows(count):  # Montgomery values below 2p
        limbs = rng.integers(0, 1 << 16, size=(count, 16), dtype=np.int64)
        limbs[:, 15] %= (2 * p) >> 240
        return torch.as_tensor(limbs.astype(np.int32), device=dev)

    x, coeffs, pp, b, s = rows(n), rows(eval_m * n).reshape(eval_m, n, 16), rows(n), rows(n), rows(n)
    z, rands, init = rows(1)[0], rows(2), rows(1)[0]
    points = [int(v) % p for v in rng.integers(1, 1 << 62, size=4)]
    points = [points[i % 4] for i in range(eval_m)]
    u, uinv = ctx.const(3, dev), ctx.const(pow(3, -1, p), dev)
    x17 = rows(1 << 17)
    coeffs17 = rows(eval_m << 17).reshape(eval_m, 1 << 17, 16)
    pp17, b17, s17 = rows(1 << 17), rows(1 << 17), rows(1 << 17)
    # a z column's inputs: four columns of a lookup (a chunk takes the first
    # c as its columns, the next c as its sigma columns), omega^i, the
    # blinding rows; three quotient pieces
    zc, zc17 = [rows(n) for _ in range(12)], [rows(1 << 17) for _ in range(4)]
    omega, omega17 = rows(n), rows(1 << 17)
    beta, gamma = points[0], points[1]
    blind = rows(5)
    dp6 = [beta * (j + 2) % p for j in range(6)]
    calls = {
        "prefix_product": lambda: scan.prefix_product(x, ctx),
        "exclusive_prefix_product_init": lambda: scan.exclusive_prefix_product(x, ctx, init),
        "batch_invert": lambda: scan.batch_invert(x, ctx),
        "batch_eval_mont": lambda: polyeval.batch_eval_mont(Fp, coeffs, points),
        "batch_eval_mont_m1": lambda: polyeval.batch_eval_mont(Fp, coeffs[:1], points[:1]),
        "device_powers": lambda: polyeval.device_powers(x[5], n, ctx),
        "point_powers": lambda: point_powers(ctx, points[1], n, dev),
        "kate_division_mont": lambda: polyeval.kate_division_mont(Fp, x, points[1]),
        "round_emit": lambda: round_emit(pp, b, s, n, z, rands, ctx),
        "round_fold": lambda: torch.stack(round_fold(pp, b, s, n, u, uinv, ctx)),
        "round": lambda: round_fold_emit(pp, b, s, n, u, uinv, z, rands, ctx),
        "prefix_product_2^17": lambda: scan.prefix_product(x17, ctx),
        "exclusive_prefix_product_init_2^17": lambda: scan.exclusive_prefix_product(x17, ctx, init),
        "batch_invert_2^17": lambda: scan.batch_invert(x17, ctx),
        "kate_division_mont_2^17": lambda: polyeval.kate_division_mont(Fp, x17, points[1]),
        "batch_eval_mont_2^17": lambda: polyeval.batch_eval_mont(Fp, coeffs17, points),
        "batch_eval_mont_m1_2^17": lambda: polyeval.batch_eval_mont(Fp, coeffs17[:1], points[:1]),
        "device_powers_2^17": lambda: polyeval.device_powers(x[5], 1 << 17, ctx),
        "point_powers_2^17": lambda: point_powers(ctx, points[1], 1 << 17, dev),
        "round_2^17": lambda: round_fold_emit(pp17, b17, s17, 1 << 17, u, uinv, z, rands, ctx),
        # one row: a launch's fixed cost, and batch inversion's inverse of its total
        "prefix_product_n1": lambda: scan.prefix_product(x[:1], ctx),
        "batch_invert_n1": lambda: scan.batch_invert(x[:1], ctx),
        # the grand products' z columns and the Horner fold (kernels G and H,
        # or kernel A around kernel C before them)
        "lookup_z": lambda: lookup_z(zc[:4], beta, gamma, blind),
        "perm_z_2": lambda: perm_z(zc[:2], zc[2:4], omega, beta, gamma, dp6[:2], init, blind),
        "perm_z_6": lambda: perm_z(zc[:6], zc[6:12], omega, beta, gamma, dp6, init, blind),
        "horner_fold": lambda: horner_fold(zc[:3], points[2]),
        "z_columns": lambda: proof_z([zc[:4]], [(zc[:2], zc[2:4], dp6[:2])], omega, beta, gamma, blind),
        "z_columns_5": lambda: proof_z([zc[:4], zc[4:8]], [(zc[:6], zc[6:12], dp6)] * 3, omega, beta, gamma, blind),
        "z_columns_2^17": lambda: proof_z([zc17], [(zc17[:2], zc17[2:4], dp6[:2])], omega17, beta, gamma, blind),
        "lookup_z_2^17": lambda: lookup_z(zc17, beta, gamma, blind),
        "perm_z_2_2^17": lambda: perm_z(zc17[:2], zc17[2:4], omega17, beta, gamma, dp6[:2], init, blind),
        "horner_fold_2^17": lambda: horner_fold(zc17[:3], points[2]),
    }

    def canonical_sha256(out):  # a tensor, or a tuple or list of them (one round's, a proof's z columns)
        h = hashlib.sha256()
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            h.update(from_mont(t.reshape(-1, 16), ctx).cpu().numpy().tobytes())
        return h.hexdigest()

    def size(name):
        return 1 << 17 if name.endswith("_2^17") else 1 if name.endswith("_n1") else n

    hashes = {}
    for name, fn in calls.items():
        out = fn()
        before = sum(field_ew.LAUNCHES.values())
        fn()
        a_launches = sum(field_ew.LAUNCHES.values()) - before
        traces = []
        for _ in range(3):  # a profiler session now and then misses kernels, never invents one
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            traces.append((len(events), sum(e.time_range.elapsed_us() for e in events) / 1e3))
        kernels = max(count for count, _ in traces)
        # the card's busy ms in the call: its device operations' traced durations
        busy_ms = min(busy for count, busy in traces if count == kernels)
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            syncs = False
        except RuntimeError:  # a copy to or from the host that waits for the card
            syncs = True
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        dev_ms = None if syncs else device_ms(fn, 10)  # a CUDA graph cannot hold such a copy
        hashes[name] = canonical_sha256(out)
        emit({"jit": name, "n": size(name),
              "M": eval_m if name.startswith("batch_eval_mont") and "_m1" not in name else
              1 if name.startswith("batch_eval_mont") else None,
              "ms": time_ms(fn), "device_ms": dev_ms, "traced_busy_ms": busy_ms, "host_sync": syncs,
              "kernel_a_launches": a_launches, "device_kernels": kernels, "canonical_sha256": hashes[name]})
    if not sweep:
        return
    from halo2_tpu_torch.ops import _build

    def same(names):
        return all(canonical_sha256(calls[name]()) == hashes[name] for name in names)

    if hasattr(scan, "SCAN_THREADS"):
        swept = [name for name in calls if name.startswith(("prefix", "exclusive", "batch_invert", "kate"))]
        defaults = {name: _build.load(name, sig) for name, sig in (("scan", scan._SIG), ("polyeval", polyeval._SIG))}
        geometry = (scan.SCAN_ROWS, scan.SCAN_THREADS, scan.TILE_ROWS)
        variants = [(f"SCAN_ROWS={r}", f"SCAN_THREADS={t}") for r, t in SCAN_SWEEP]
        emit({"sweep": "scan_build", "seconds": _build.build_all(["scan", "polyeval"], variants)})
        try:
            for (r, t), defs in zip(SCAN_SWEEP, variants):
                # the wrappers launch the variant's kernels over tiles of r t rows
                scan.SCAN_ROWS, scan.SCAN_THREADS, scan.TILE_ROWS = r, t, r * t
                for name, sig in (("scan", scan._SIG), ("polyeval", polyeval._SIG)):
                    _build._libs[(name, ())] = _build.load(name, sig, defs)
                usage = {**_build.ptxas_usage("scan", defs), **_build.ptxas_usage("polyeval", defs)}
                emit({"sweep": "scan_geometry", "rows": r, "threads": t,
                      "device_ms": {name: device_ms(calls[name], 10) for name in swept},
                      "same_canonical": same(swept),
                      "ptxas": {k: v for k, v in usage.items() if k.startswith(("scan", "invert", "kate"))}})
        finally:
            scan.SCAN_ROWS, scan.SCAN_THREADS, scan.TILE_ROWS = geometry
            for name, lib in defaults.items():
                _build._libs[(name, ())] = lib
    if not hasattr(polyeval, "eval_geometry"):
        return
    # kernel D at each (groups G, rows a thread) that its blocks of
    # EVAL_THREADS allow: the wrapper's eval_geometry replaced for the sweep
    d_calls = [name for name in calls if name.startswith(("batch_eval_mont", "point_powers"))]
    chosen = polyeval.eval_geometry
    try:
        for G, rows in EVAL_GEOMETRY_SWEEP:

            def geometry(n, per_point, G=G, rows=rows):
                g = G if max(per_point) > 0 else 1
                return g, rows, polyeval.eval_blocks(n, rows, g)

            polyeval.eval_geometry = geometry
            emit({"sweep": "batch_eval", "groups": G, "rows": rows,
                  "device_ms": {name: device_ms(calls[name], 10) for name in d_calls},
                  "same_canonical": same(d_calls)})
    finally:
        polyeval.eval_geometry = chosen


def z_columns(F, ctx, dev):
    """(lookup_z(cols, beta, gamma, rand_rows), perm_z(cols, sigmas, omega_pw,
    beta, gamma, dpows, init, rand_rows) -> z, horner_fold(pieces, x),
    proof_z(lookups, chunks, omega_pw, beta, gamma, rand_rows) -> every z
    and the chunks' last_z) as the tree computes them: kernels G and H
    where it has them (a proof's z columns one call of kernel G where it
    has z_columns, else a call a column, the chunks chained by last_z),
    else its provers' z columns and its stacked fold (kernel A around
    kernel C). proof_z's lookups are lists of four columns, its chunks
    (cols, sigmas, dpows), all with the same random rows."""

    def chained(lookup_z, perm_z):  # a proof's z columns as a call a column
        def proof_z(lookups, chunks, omega_pw, beta, gamma, rand_rows):
            out, init = [lookup_z(cols, beta, gamma, rand_rows) for cols in lookups], None
            for cols, sigmas, dpows in chunks:
                z, init = perm_z(cols, sigmas, omega_pw, beta, gamma, dpows, init, rand_rows)
                out += [z, init]
            return out

        return proof_z

    from halo2_tpu_torch.ops import polyeval

    try:
        from halo2_tpu_torch.ops import grand_product as gp
    except ImportError:  # before kernel G
        from halo2_tpu_torch.plonk.lookup_prover import _lookup_z
        from halo2_tpu_torch.plonk.permutation_prover import _perm_z

        def lookup_z(cols, beta, gamma, rand_rows):
            return _lookup_z(F, rand_rows.shape[0], *cols, ctx.const(beta, dev), ctx.const(gamma, dev), rand_rows)

        def perm_zl(cols, sigmas, omega_pw, beta, gamma, dpows, init, rand_rows):
            return _perm_z(F, rand_rows.shape[0], torch.stack(cols), torch.stack(sigmas), omega_pw,
                           ctx.const(beta, dev), ctx.const(gamma, dev), ctx.consts(dpows, dev), init, rand_rows)

        def horner_fold(pieces, x):
            return polyeval.horner_fold_mont(F, torch.stack(pieces), x)

        return (lookup_z, lambda *args: perm_zl(*args)[0], horner_fold, chained(lookup_z, perm_zl))

    def lookup_z(cols, beta, gamma, rand_rows):
        return gp.lookup_z(F, rand_rows.shape[0], *cols, beta, gamma, rand_rows)

    def perm_zl(cols, sigmas, omega_pw, beta, gamma, dpows, init, rand_rows):
        return gp.perm_z(F, rand_rows.shape[0], cols, sigmas, omega_pw, beta, gamma, dpows, init, rand_rows)

    def horner_fold(pieces, x):
        return polyeval.horner_fold_mont(F, pieces, x)

    if not hasattr(gp, "z_columns"):
        return lookup_z, lambda *args: perm_zl(*args)[0], horner_fold, chained(lookup_z, perm_zl)

    def proof_z(lookups, chunks, omega_pw, beta, gamma, rand_rows):
        lzs, czs, lasts = gp.z_columns(F, rand_rows.shape[0], beta, gamma,
                                       [gp.LookupColumns(*cols, rand_rows) for cols in lookups],
                                       [[gp.Chunk(cols, sigmas, dpows, rand_rows) for cols, sigmas, dpows in chunks]],
                                       omega_pw)
        return [*lzs, *(t for pair in zip(czs[0], lasts[0]) for t in pair)]

    return lookup_z, lambda *args: perm_zl(*args)[0], horner_fold, proof_z


def sites_section(dev) -> None:
    """Kernel A's launches in a warm BenchCircuit k = 14 proof by call site
    (this checkout's chip_smoke.kernel_a_sites on the tree's code), with the
    proof's sha256 and its launches of each kernel C-H the tree has."""
    from halo2_tpu_torch.circuits import bench_circuit_for_k
    from halo2_tpu_torch.curves import Vesta
    from halo2_tpu_torch.ops import field_ew
    from halo2_tpu_torch.plonk.keygen import keygen_pk, keygen_vk
    from halo2_tpu_torch.plonk.prover import create_proof
    from halo2_tpu_torch.poly.ipa import ParamsIPA
    from halo2_tpu_torch.transcript import Blake2bWrite
    from halo2_tpu_torch.utils.chacha import ChaCha20Rng
    import importlib

    cs = self_chip_smoke()
    params = ParamsIPA.cached(Vesta, 14, device=dev)
    circ = bench_circuit_for_k(14)
    vk = keygen_vk(params, circ.without_witnesses())
    pk = keygen_pk(params, vk, circ.without_witnesses())
    counters = {}
    for name in ("scan", "polyeval", "ipa_round", "grand_product"):
        try:
            counters.update({key: (mod, key) for mod in (importlib.import_module(f"halo2_tpu_torch.ops.{name}"),)
                             for key in mod.LAUNCHES})
        except ImportError:
            pass
    # the per-proof omega^i table of the provers before kernel G: a host loop
    from halo2_tpu_torch.ops.field import FieldCtx
    from halo2_tpu_torch.ops.ntt import powers

    ctx = FieldCtx(vk.domain.field)
    t0 = time.perf_counter()
    powers(vk.domain.omega, params.n, ctx, dev)
    torch.cuda.synchronize()
    emit({"sites": "omega_table", "n": params.n, "host_s": time.perf_counter() - t0})
    for proof in ("first", "warm"):
        sites = {}
        before = {key: mod.LAUNCHES[key] for key, (mod, _) in counters.items()}
        a_before = sum(field_ew.LAUNCHES.values())
        tr = Blake2bWrite(Vesta)
        with cs.kernel_a_sites(sites):
            create_proof(params, pk, [circ], [[]], ChaCha20Rng(b"\x2a" * 32), tr)
        torch.cuda.synchronize()
        emit({"sites": proof, "proof_sha256": hashlib.sha256(tr.finalize()).hexdigest(),
              "kernel_a_launches": sum(field_ew.LAUNCHES.values()) - a_before,
              "launches": {key: mod.LAUNCHES[key] - before[key] for key, (mod, _) in counters.items()},
              "launches_by_site": dict(sorted(sites.items(), key=lambda kv: -kv[1]))})


def fold_section(dev, sweep: bool = False, trace: bool = False) -> None:
    """Kernel B on the part-0 folds of the first k14, poseidon11,
    sinsemilla14 and sha256_k17 proofs (see the module's docstring)."""
    from halo2_tpu_torch import circuits
    from halo2_tpu_torch.curves import Vesta
    from halo2_tpu_torch.ops import field_ew
    from halo2_tpu_torch.ops import fold as fold_mod
    from halo2_tpu_torch.plonk.keygen import keygen_pk, keygen_vk
    from halo2_tpu_torch.plonk.prover import create_proof
    from halo2_tpu_torch.poly.ipa import ParamsIPA
    from halo2_tpu_torch.transcript import Blake2bWrite
    from halo2_tpu_torch.utils import measure
    from halo2_tpu_torch.utils.chacha import ChaCha20Rng

    cs = self_chip_smoke()
    workloads = (("k14", (14, circuits.bench_circuit_for_k(14), [], b"\x2a" * 32)),
                 ("poseidon11", circuits.poseidon_k11()), ("sinsemilla14", circuits.sinsemilla_k14()),
                 ("sha256_k17", circuits.sha256_k17()))
    for tag, (k, circ, instances, seed) in workloads:
        params = ParamsIPA.cached(Vesta, k, device=dev)
        vk = keygen_vk(params, circ.without_witnesses())
        pk = keygen_pk(params, vk, circ.without_witnesses())
        caps = []
        profile = trace and tag == "sha256_k17"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with SpanLaunches(measure, field_ew, fold_mod, "evaluate_h + vanishing", profile) as quotient, \
                cs.fold_capture(caps, 1):
            tr = Blake2bWrite(Vesta)
            create_proof(params, pk, [circ], [instances], ChaCha20Rng(seed), tr)
            proof = tr.finalize()
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
        f, arrays, cx, scal, out = caps[0]
        prog = f.program
        cols = [arrays[j] for j in prog.array_ids]
        table = fold_mod.scalar_table(prog, scal, cx.device)
        n = cx.shape[0]
        counts = prog.counts()
        if hasattr(prog, "columns_read"):
            loaded = prog.columns_read()
        else:  # the parent's program: a LOAD instruction a column read
            loaded = {a for op, _, a, _ in prog.instrs if op == fold_mod.LOAD}
        recorded = getattr(prog, "vinstrs", prog.instrs)
        nbytes = (64 * n * (len(loaded) + (counts["COSET_X"] > 0) + len(prog.clusters))
                  + 16 * (len(recorded) + 4 * len(prog.scalar_defs)))
        bound_ms, bound_by = cs.bound(nbytes, counts["MUL"] * n * cs.product_s(f.field.MODULUS))

        def limbs_sha(res):
            return hashlib.sha256(torch.stack([res[c] for c in prog.clusters]).cpu().numpy().tobytes()).hexdigest()

        def run(p=prog):
            return fold_mod.run_program(p, cols, cx, table)

        dms = device_ms(run, 5)
        sizes = getattr(prog, "bundle_sizes", None)

        def table_call():
            return fold_mod.scalar_table(prog, scal, cx.device)

        # the parent's table (kernel A on (16,) tensors) copies its constants
        # from the host, which a CUDA graph cannot capture
        table_dms = device_ms(table_call, 5) if hasattr(prog, "scalar_program") else None
        emit({"fold": tag, "rows": n, "clusters": list(prog.clusters), "instructions": len(recorded),
              "operations": len(prog.instrs),
              "mul": counts["MUL"], "live_slots": prog.slots, "columns": len(prog.array_ids),
              "bundles": len(sizes) if sizes else None, "width": getattr(prog, "width", None),
              "ms": time_ms(run), "device_ms": dms, "bound_ms": bound_ms, "bound_by": bound_by,
              "x_bound": dms / bound_ms, "scalar_table_ms": time_ms(table_call),
              "scalar_table_device_ms": table_dms,
              "out_limbs_sha256": limbs_sha(out), "rerun_same": limbs_sha(run()) == limbs_sha(out),
              "proof_sha256": hashlib.sha256(proof).hexdigest(), "prove_s": prove_s,
              "quotient_span_launches": quotient.counts})
        if quotient.prof is not None:
            spans = measure.get_records()
            emit({"trace": tag, "span": "evaluate_h + vanishing",
                  **trace_summary(quotient.prof, quotient.wall_s, set(spans)),
                  "host_functions": quotient.host_profile, "spans_s": spans})
        if sweep and hasattr(fold_mod, "WINDOW") and tag in ("k14", "sinsemilla14"):
            default = fold_mod.WINDOW
            try:
                for width in FOLD_WIDTH_SWEEP:
                    for window in FOLD_WINDOW_SWEEP:
                        fold_mod.WINDOW = window
                        p = prog.with_width(width)
                        emit({"sweep": "fold", "fold": tag, "width": width, "window": window,
                              "bundles": len(p.bundle_sizes), "live_slots": p.slots,
                              "same_output": limbs_sha(run(p)) == limbs_sha(out),
                              "device_ms": device_ms(lambda: run(p), 5)})
            finally:
                fold_mod.WINDOW = default


def ntt_section(dev, rng, sweep: bool = False) -> None:
    """Kernels 1 and 8 per level and their whole transforms at 2^14 and 2^16
    (see the module's docstring); the modules are the tree's own."""
    from halo2_tpu_torch.curves import Pallas
    from halo2_tpu_torch.fields import Fp
    from halo2_tpu_torch.ops import ntt_cg, ntt_mr, tile_bench
    from halo2_tpu_torch.ops.curve import CurveCtx
    from halo2_tpu_torch.ops.field import FieldCtx, from_mont
    from halo2_tpu_torch.tools import profile_kernels

    ctx = FieldCtx(Fp)
    p = Fp.MODULUS
    # each engine: its plan, its level wrapper, its module (LEVEL_THREADS) and
    # its level contract in this tree: (B, f, g) columns with perm at the last
    # level since the engine's redesign, (cols, f) columns before it
    engines = (
        ("cg_ntt_level", ntt_cg.CgNttPlan, ntt_cg, hasattr(ntt_cg, "LEVEL_THREADS")),
        ("mr_col_ntt", ntt_mr.MrNttPlan, ntt_mr, hasattr(ntt_mr, "LEVEL_THREADS")),
    )

    def level_fn(mod, kernel, new, x, lv, tab):
        f, g = lv["f"], lv["g"]
        n = x.shape[0]
        fn = getattr(mod, kernel)
        if not new:
            xl = x.reshape(n // f, f, 16)
            return lambda: fn(xl, tab["stw"], tab["inter"], ctx)
        xl = x.reshape(n // (f * g), f, g, 16)
        return lambda: fn(xl, tab["stw"], tab["inter"], ctx, tab["perm"])

    def digest(y):
        return hashlib.sha256(y.contiguous().cpu().numpy().tobytes()).hexdigest()

    def kernels_launched(fn):
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

    for log_n in (14, 16):
        n = 1 << log_n
        omega = pow(Fp.ROOT_OF_UNITY, 1 << (Fp.S - log_n), p)
        limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.int64)
        limbs[:, 15] &= 0x3FFF  # below p
        x = ctx.to_mont(torch.as_tensor(limbs.astype(np.int32), device=dev))
        for kernel, plan_cls, mod, new in engines:
            plan = plan_cls(Fp, log_n, omega)
            tabs = plan._tables(dev)
            y = plan(x)
            levels = [level_fn(mod, kernel, new, x, lv, tab) for lv, tab in zip(plan.levels, tabs)]
            emit({"ntt_log_n": log_n, "kernel": kernel, "contract": "B,f,g" if new else "cols,f",
                  "levels": [(lv["f"], lv["g"]) for lv in plan.levels],
                  "level_ms": [time_ms(fn) for fn in levels],
                  "level_device_ms": [device_ms(fn) for fn in levels],
                  "transform_ms": time_ms(lambda: plan(x)),
                  "transform_device_ms": device_ms(lambda: plan(x)),
                  "device_kernels_per_transform": kernels_launched(lambda: plan(x)),
                  "output_sha256": digest(y)})
            if not (sweep and new):
                continue
            default = mod.LEVEL_THREADS
            try:
                for threads in LEVEL_SWEEP:
                    mod.LEVEL_THREADS = threads
                    emit({"sweep": kernel, "log_n": log_n, "threads": threads,
                          "same_output": torch.equal(plan(x), y),
                          "level_device_ms": [device_ms(fn) for fn in levels],
                          "transform_device_ms": device_ms(lambda: plan(x))})
            finally:
                mod.LEVEL_THREADS = default
            if kernel != "cg_ntt_level":
                continue
            saved = ntt_cg.CgNttPlan.MAX_LOG_F
            try:
                for log_f in NTT_LOG_F_SWEEP:
                    ntt_cg.CgNttPlan.MAX_LOG_F = log_f
                    other = ntt_cg.CgNttPlan(Fp, log_n, omega)
                    emit({"sweep": "MAX_LOG_F", "log_n": log_n, "max_log_f": log_f,
                          "levels": [(lv["f"], lv["g"]) for lv in other.levels],
                          "same_values": torch.equal(from_mont(other(x), ctx), from_mont(y, ctx)),
                          "transform_device_ms": device_ms(lambda: other(x))})
            finally:
                ntt_cg.CgNttPlan.MAX_LOG_F = saved
    # the kernels this tree's NTT work leaves alone: kernels 9 and 10
    tiles = profile_kernels.tilemul(1 << 18, device=dev)
    cc = CurveCtx(Pallas)

    def mul():
        return tile_bench.tile_mul(tiles["a"], tiles["b"], cc.fctx)

    def padd():
        return tile_bench.tile_padd(*tiles["pts"], cc)

    emit({"other_kernels_ms": {"tile_mul": tiles["mul_ms"], "tile_padd": tiles["padd_ms"]},
          "other_kernels_device_ms": {"tile_mul": device_ms(mul), "tile_padd": device_ms(padd)}})


def sass_mix(lib: str, names: dict) -> dict:
    """{label: {opcode: count}} of the SASS of each kernel of `lib` whose
    mangled name holds names[label] (`cuobjdump -sass`, predicates and
    operands dropped)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    mix, label = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            label = next((k for k, v in names.items() if v in fn), None)
            if label is not None:
                mix[label] = collections.Counter()
        elif label is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m:
                mix[label][m.group(1)] += 1
    return {k: dict(c.most_common()) for k, c in mix.items()}


def tile_section(dev, sweep: bool = False, n: int = 1 << 18) -> None:
    """Kernels 9 and 10 at n elements (see the module's docstring); the
    modules are the tree's own."""
    from halo2_tpu_torch.curves import Pallas
    from halo2_tpu_torch.ops import _build, tile_bench
    from halo2_tpu_torch.ops.curve import CurveCtx
    from halo2_tpu_torch.ops.field import from_mont
    from halo2_tpu_torch.tools import profile_kernels

    cc = CurveCtx(Pallas)
    ctx = cc.fctx
    tiles = profile_kernels.tilemul(n, device=dev)
    a, b, pts = tiles["a"], tiles["b"], tiles["pts"]

    def mul():
        return tile_bench.tile_mul(a, b, ctx)

    def padd():
        return tile_bench.tile_padd(*pts, cc)

    def digest(ts):
        return hashlib.sha256(b"".join(t.contiguous().cpu().numpy().tobytes() for t in ts)).hexdigest()

    def canon(ts):
        return [from_mont(t, ctx) for t in ts]

    y, r = mul(), padd()
    emit({"tile": "tile_mul", "n": n, "ms": time_ms(mul), "device_ms": device_ms(mul),
          "output_sha256": digest([y]),
          "equals_plain_limbs": torch.equal(y, tile_bench.tile_mul_plain(a, b, ctx))})
    rc = canon(r)
    emit({"tile": "tile_padd", "n": n, "ms": time_ms(padd), "device_ms": device_ms(padd),
          "output_sha256": digest(r), "canonical_sha256": digest(rc),
          "equals_plain_canonical": all(torch.equal(u, v) for u, v in zip(
              rc, canon(tile_bench.tile_padd_plain(*pts, cc))))})
    keep = ("Compiling entry function", "spill stores", "Used ")
    if hasattr(_build, "log_path"):  # logs keyed to their library
        log = _build.log_path("tile_bench")
        names = {"tile_mul": "mul_kernelILb1EE", "tile_padd": "padd_kernelILb1ELb1EE"}
    else:
        libs = list(_build.BUILD.glob("libtile_bench-*.so"))
        log = _build.BUILD / "tile_bench.log"
        log = log if len(libs) == 1 and log.exists() else None
        names = {"tile_mul": "tile_mul_kernel", "tile_padd": "tile_padd_kernel"}
    emit({"tile": "ptxas", "log": str(log), "lines": None if log is None else [
        " ".join(line.split()) for line in log.read_text().splitlines()
        if any(k in line for k in keep)]})
    emit({"tile": "sass", "opcodes": sass_mix(str(_build._target("tile_bench")), names)})
    if not (sweep and hasattr(_build, "log_path")):
        return
    variants = [tuple(f"TILE_{k}_{v}={x}" for k, geo in (("MUL", g9), ("PADD", g10))
                      for v, x in zip(("THREADS", "MIN_BLOCKS"), geo))
                for g9, g10 in TILE_SWEEP]
    emit({"sweep": "tile_build", "seconds": _build.build_all(["tile_bench"], variants)})
    default = _build._libs[("tile_bench", ())]
    try:
        for (g9, g10), defs in zip(TILE_SWEEP, variants):
            # the wrappers launch the variant's kernels
            _build._libs[("tile_bench", ())] = _build.load("tile_bench", tile_bench._SIG, defs)
            usage = _build.ptxas_usage("tile_bench", defs)
            emit({"sweep": "tile_mul", "threads_min_blocks": g9,
                  "ptxas": usage["mul_kernel<1>"], "same_output": torch.equal(mul(), y),
                  "device_ms": device_ms(mul)})
            emit({"sweep": "tile_padd", "threads_min_blocks": g10,
                  "ptxas": usage["padd_kernel<1,1>"],
                  "same_canonical": all(torch.equal(u, v) for u, v in zip(canon(padd()), rc)),
                  "device_ms": device_ms(padd)})
    finally:
        _build._libs[("tile_bench", ())] = default


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--sorted", action="store_true")
    ap.add_argument("--ntt", action="store_true")
    ap.add_argument("--tile", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--proofs", action="store_true")
    ap.add_argument("--fold", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--jit", type=int, default=0, metavar="M",
                    help="kernels C-H (or their plain rounds), kernel D at M polynomials")
    ap.add_argument("--sites", action="store_true",
                    help="kernel A's launches in a k = 14 proof by call site")
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("msm_ab: CUDA is not available", file=sys.stderr)
        return 1
    tree = os.path.abspath(ns.tree)
    sys.path.insert(0, tree)
    import halo2_tpu_torch
    from halo2_tpu_torch.circuits import bench_circuit_for_k
    from halo2_tpu_torch.curves import Vesta
    from halo2_tpu_torch.ops import msm_bucket, msm_sorted
    from halo2_tpu_torch.ops.curve import PointVec
    from halo2_tpu_torch.ops.msm import MSMBases
    from halo2_tpu_torch.plonk.keygen import keygen_pk, keygen_vk
    from halo2_tpu_torch.plonk.prover import create_proof
    from halo2_tpu_torch.poly.ipa import ParamsIPA
    from halo2_tpu_torch.transcript import Blake2bWrite
    from halo2_tpu_torch.utils.chacha import ChaCha20Rng

    pkg = os.path.dirname(os.path.abspath(halo2_tpu_torch.__file__))
    if os.path.dirname(pkg) != tree:
        raise RuntimeError(f"imported halo2_tpu_torch from {pkg}, not from {tree}")
    dev = torch.device("cuda")
    emit({"tree": tree, "device": torch.cuda.get_device_name(0)})

    params14 = ParamsIPA.cached(Vesta, 14, device=dev)
    rng = np.random.default_rng(20261017)
    bucket_shapes = (
        ("k14_commit", (1 << 14) + 1, 3, params14.g + [params14.w]),
        ("c8_M2", 1 << 15, 2, params14.g + params14.g_lagrange),
    )
    if ns.fold:
        fold_section(dev, ns.sweep, ns.trace)
        bucket_shapes = ()
    if ns.jit:
        jit_section(dev, ns.jit, sweep=ns.sweep)
        bucket_shapes = ()
    if ns.sites:
        sites_section(dev)
        bucket_shapes = ()
    if ns.ntt:
        ntt_section(dev, np.random.default_rng(20261018), ns.sweep)
        bucket_shapes = ()
    if ns.tile:
        tile_section(dev, ns.sweep)
        bucket_shapes = ()
    if ns.sorted:
        sorted_section(ParamsIPA.cached(Vesta, 16, device=dev), msm_bucket, msm_sorted, dev, rng,
                       ns.sweep)
        bucket_shapes = ()
    for label, n, M, pts in bucket_shapes:
        bases = MSMBases(Vesta, pts, dev)
        cc = bases.cc
        c, nwin, T, n_pad = msm_bucket.msm_geometry(Vesta, n, dev)
        limbs = rng.integers(0, 1 << 16, size=(M, n, 16), dtype=np.int64)
        limbs[..., 15] &= 0x3FFF  # below q
        limbs[0, :3] = 0
        canon = torch.as_tensor(limbs.astype(np.int32), device=dev)
        scal = torch.nn.functional.pad(canon.transpose(1, 2), (0, n_pad - n)).contiguous()
        db = bases.device_tables(n_pad, dev)
        bk = msm_bucket.msm_accum(scal, db.px, db.py, c, nwin, T, cc)
        fk = msm_bucket.msm_fold(bk, cc)
        rk = msm_bucket.msm_lane_reduce(fk, cc)
        wins = cc.decode_points(PointVec(rk[:, 0], rk[:, 1], rk[:, 2]))
        affine = repr([p.xy for p in wins]).encode()
        if ns.sweep and hasattr(msm_bucket, "LANE_REDUCE_THREADS"):
            default = msm_bucket.LANE_REDUCE_THREADS
            try:
                for threads in LANE_REDUCE_SWEEP:
                    msm_bucket.LANE_REDUCE_THREADS = threads
                    emit({"sweep": "msm_lane_reduce", "shape": label, "threads": threads,
                          "same_output": torch.equal(msm_bucket.msm_lane_reduce(fk, cc), rk),
                          "device_ms": device_ms(lambda: msm_bucket.msm_lane_reduce(fk, cc), 5)})
            finally:
                msm_bucket.LANE_REDUCE_THREADS = default
        calls = {
            "msm_accum": lambda: msm_bucket.msm_accum(scal, db.px, db.py, c, nwin, T, cc),
            "msm_fold": lambda: msm_bucket.msm_fold(bk, cc),
            "msm_lane_reduce": lambda: msm_bucket.msm_lane_reduce(fk, cc),
        }
        ms = {name: time_ms(fn) for name, fn in calls.items()}
        ms["device"] = {name: device_ms(fn, 5) for name, fn in calls.items()}
        if bk.shape[-1] != T:  # (rows, T, B, 3, 16) -> the first port's (rows, B, 3, 16, T)
            bk = bk.permute(0, 2, 3, 4, 1)
        emit({"shape": label, "M": M, "n": n, "c": c, "nwin": nwin, "T": T, "ms": ms,
              "buckets_sha256": hashlib.sha256(bk.contiguous().cpu().numpy().tobytes()).hexdigest(),
              "window_sums_affine_sha256": hashlib.sha256(affine).hexdigest(),
              "lane_reduce_limbs_sha256": hashlib.sha256(rk.cpu().numpy().tobytes()).hexdigest()})

    if not ns.proofs:
        return 0
    for k in (14, 16):
        params = params14 if k == 14 else ParamsIPA.cached(Vesta, k, device=dev)
        circ = bench_circuit_for_k(k)
        vk = keygen_vk(params, circ.without_witnesses())
        pk = keygen_pk(params, vk, circ.without_witnesses())
        log = []
        wrapped = ([(msm_bucket, name) for name in KERNELS]
                   + [(msm_sorted, name) for name in SORTED_KERNELS])
        originals = {name: getattr(mod, name) for mod, name in wrapped}

        def timed(name):
            def run(*args, **kwargs):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = originals[name](*args, **kwargs)
                end.record()
                log.append((name, start, end))
                return out
            return run

        for warm in ((False, True) if k == 14 else (False,)):
            log.clear()
            for mod, name in wrapped:
                setattr(mod, name, timed(name))
            try:
                with HostSeconds(KERNEL_D_CALLS) as d_host:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    tr = Blake2bWrite(Vesta)
                    create_proof(params, pk, [circ], [[]], ChaCha20Rng(b"\x2a" * 32), tr)
                    proof = tr.finalize()
                    torch.cuda.synchronize()
                    prove_s = time.perf_counter() - t0
            finally:
                for mod, name in wrapped:
                    setattr(mod, name, originals[name])
            ms = {name: 0.0 for name in originals}
            launches = {name: 0 for name in originals}
            for name, start, end in log:
                ms[name] += start.elapsed_time(end)
                launches[name] += 1
            emit({"proof_k": k, "warm": warm, "sha256": hashlib.sha256(proof).hexdigest(), "bytes": len(proof),
                  "prove_s": prove_s, "launches": launches, "event_ms": ms,
                  "kernel_d_host_s": d_host.seconds, "kernel_d_calls": d_host.calls})
    return 0


# the entry points of kernel D that a proof calls (device_powers on trees
# without point_powers)
KERNEL_D_CALLS = ("batch_eval_mont", "point_powers", "device_powers")


class HostSeconds:
    """Inside the block, the host's wall seconds in each call of the
    functions of ops/polyeval named in `names`, wherever a module of the
    port holds them (a call on the card returns without waiting for it, so
    this is the wrapper's own host time: its tables, its launch), and the
    number of calls; a call inside another is counted once."""

    def __init__(self, names):
        self.names, self.seconds, self.calls, self.depth = names, 0.0, 0, 0

    def __enter__(self):
        from halo2_tpu_torch.ops import polyeval

        self.saved = []
        for name in self.names:
            original = getattr(polyeval, name, None)
            if original is None:
                continue
            wrapper = self.wrap(original)
            for mod in [m for key, m in sys.modules.items() if key.startswith("halo2_tpu_torch") and m]:
                if getattr(mod, name, None) is original:
                    self.saved.append((mod, name, original))
                    setattr(mod, name, wrapper)
        return self

    def wrap(self, fn):
        def run(*args, **kwargs):
            self.depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.depth -= 1
                if self.depth == 0:
                    self.seconds += time.perf_counter() - t0
                    self.calls += 1
        return run

    def __exit__(self, *exc):
        for mod, name, original in self.saved:
            setattr(mod, name, original)
        return False


if __name__ == "__main__":
    sys.exit(main())
