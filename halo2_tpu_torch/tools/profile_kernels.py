"""Microbenchmarks of the port's kernels: the counterpart of
`tools/profile_kernels.py`.

    python -m halo2_tpu_torch.tools.profile_kernels <section> [args] [--device cpu]

Sections:

- `tilemul [n]`: kernels 9 and 10 (`ops/tile_bench.py`) over n elements
  (default 128 * 2048, the TPU tool's grid): ns per element product of
  `tile_mul` (eight chained Montgomery products per element) and ns per point
  of `tile_padd` (one complete mixed addition on Pallas). The TPU tool drew
  uniform 16-bit limbs, values up to 2^256 and so outside [0, 2p), where both
  packages' arithmetic is defined; this one draws canonical values below
  2^254 < p from a numpy seed.
- `oplat [n]`: the latency of one field operation of `csrc/field.cuh` on one
  thread, each of `tile_bench.OPS` run n times in a dependent chain (default
  256) on Pasta's Fq: clock cycles per operation, the result checked against
  the plain version (the card's own `mont_mul` / `add_mod` / `sub_mod`).
  Then the card's throughput of 32-bit multiply instructions, each form of
  `tile_bench.PEAK_FORMS` (mad.lo, mad.hi, their carry-chained forms,
  mad.wide.u32) on 8 blocks of 256 threads an SM, 4096 steps a thread,
  checked against the plain version over 16 steps first; on the CPU only
  the check runs.
- `msm_accum [K]`: the bucket MSM's kernels 2-4 (`ops/msm_bucket.py`)
  separately, at 2^K points (default 16) over 2^10 random Pallas bases
  repeated.
- `ntt_compile [k ...]`: `MrNttPlan` (kernel 8) at each k (default 14 16 18
  20): its set-up, then its first call, then a warm call. Set-up is the host
  twiddle tables; the first call adds the kernel's build at first use (nvcc,
  once per process) and the tables' copy to the device. The port has no
  compile step beyond that: PyTorch runs eagerly.
- `sortgather [log_n]`: torch sort, argsort, row gather, scatter-add
  histogram and cumsum at 2^log_n (default 20), the building blocks of a
  sort-based MSM.

It runs on CUDA unless `--device cpu` is given, and times the card with CUDA
events (the host clock on the CPU, where a time says nothing of the card).
Importing the module runs nothing.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..curves import Pallas
from ..fields import Fq
from ..ops import msm_bucket, tile_bench
from ..ops.curve import CurveCtx
from ..ops.field import FieldCtx
from ..ops.msm import MSMBases
from ..ops.ntt_mr import MrNttPlan
from ..poly.ipa import resolve_device


def timeit(fn, device: torch.device, iters: int = 10, warm: int = 2) -> float:
    """Seconds per call of fn, after `warm` calls: CUDA events on the card,
    the host clock on the CPU."""
    for _ in range(warm):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _canon(rng: np.random.Generator, n: int, device) -> torch.Tensor:
    """n uniform values below 2^254 (below every Pasta modulus) as (n, 16)
    int32 limbs."""
    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.int64)
    limbs[:, 15] &= 0x3FFF
    return torch.as_tensor(limbs.astype(np.int32), device=device)


def tilemul(n: int = 128 * 2048, *, device, seed: int = 0, iters: int = 10) -> dict:
    """Kernels 9 and 10 over n elements; returns their inputs, outputs and
    times."""
    cc = CurveCtx(Pallas)
    ctx = cc.fctx
    rng = np.random.default_rng(seed)
    a, b = _canon(rng, n, device), _canon(rng, n, device)
    pts = [_canon(rng, n, device) for _ in range(5)]
    mul_out = tile_bench.tile_mul(a, b, ctx)
    mul_s = timeit(lambda: tile_bench.tile_mul(a, b, ctx), device, iters)
    padd_out = tile_bench.tile_padd(*pts, cc)
    padd_s = timeit(lambda: tile_bench.tile_padd(*pts, cc), device, iters)
    products = n * tile_bench.MULS_PER_ELEMENT
    print(f"tile_mul: {mul_s * 1e3:.4f} ms for {n} elements x {tile_bench.MULS_PER_ELEMENT}, "
          f"{mul_s / products * 1e9:.4f} ns per element product", flush=True)
    print(f"tile_padd: {padd_s * 1e3:.4f} ms for {n} points, "
          f"{padd_s / n * 1e9:.4f} ns per point", flush=True)
    return dict(n=n, a=a, b=b, pts=pts, mul_out=mul_out, padd_out=padd_out,
                mul_ms=mul_s * 1e3, padd_ms=padd_s * 1e3,
                ns_per_product=mul_s / products * 1e9, ns_per_point=padd_s / n * 1e9)


def oplat(n: int = 256, *, device, seed: int = 3) -> dict:
    """Cycles per operation of each of tile_bench.OPS in a chain of n."""
    ctx = FieldCtx(Fq)
    rng = np.random.default_rng(seed)
    a, b = _canon(rng, 1, device)[0], _canon(rng, 1, device)[0]
    out = {}
    for op in tile_bench.OPS:
        got, cycles = tile_bench.op_chain(a, b, n, op, ctx)
        if not torch.equal(got, tile_bench.op_chain_plain(a, b, n, op, ctx)):
            raise AssertionError(f"op_chain {op}: kernel != plain")
        out[op] = None if cycles is None else cycles / n
        print(f"{op}: {out[op]} cycles per operation, chain of {n}", flush=True)
    out.update(mul_rate(device))
    return out


def mul_rate(device, iters: int = 4096, check_iters: int = 16) -> dict:
    """Instructions per second of each multiply form of tile_bench.PEAK_FORMS
    over a full-card grid (None on the CPU), each checked against its plain
    version."""
    on_card = device.type == "cuda"
    blocks = 8 * torch.cuda.get_device_properties(device).multi_processor_count if on_card else 1
    rng = np.random.default_rng(11)
    words = rng.integers(0, 1 << 32, (blocks * tile_bench.PEAK_THREADS, tile_bench.PEAK_CHAINS),
                         dtype=np.uint64)
    acc0 = torch.as_tensor(words.astype(np.uint32).view(np.int32), device=device)
    out = {}
    for form, per_step in tile_bench.PEAK_FORMS.items():
        got = tile_bench.mul_peak(acc0.clone(), check_iters, form)
        if not torch.equal(got, tile_bench.mul_peak_plain(acc0, check_iters, form)):
            raise AssertionError(f"mul_peak {form}: kernel != plain")
        rate = None
        if on_card:
            acc = acc0.clone()
            secs = timeit(lambda: tile_bench.mul_peak(acc, iters, form), device, iters=3, warm=1)
            rate = acc.shape[0] * per_step * iters / secs
        out[f"{form}_per_s"] = rate
        print(f"{form}: {'not measured' if rate is None else f'{rate:.6e}'} instructions/s, "
              f"{blocks} blocks x {tile_bench.PEAK_THREADS} threads x {per_step} a step x "
              f"{iters} steps", flush=True)
    return out


def msm_accum(K: int = 16, *, device) -> dict:
    """The bucket MSM's three kernels separately at 2^K points."""
    n = 1 << K
    m = min(1 << 10, n)
    rng = np.random.default_rng(5)
    g = Pallas.generator()
    bases = MSMBases(Pallas, [g.mul(int(rng.integers(1, 1 << 62))) for _ in range(m)], device)
    cc = bases.cc
    c, nwin, T, n_pad = msm_bucket.msm_geometry(Pallas, n, device)
    db = bases.device_tables(m, device)
    px, py = db.px.repeat(1, n_pad // m), db.py.repeat(1, n_pad // m)
    scal = _canon(rng, n_pad, device).t().contiguous()[None]  # (1, 16, n_pad), < 2^254 < q
    out = dict(n=n, c=c, nwin=nwin, T=T)

    def stage(name, fn):
        t0 = time.perf_counter()
        res = fn()
        _sync(device)
        first = time.perf_counter() - t0
        dt = timeit(fn, device, iters=3, warm=1)
        print(f"{name} first call {first:.3f}s, warm {dt * 1e3:.3f} ms "
              f"({n / dt / 1e6:.3f} M points/s equivalent)", flush=True)
        out[f"{name}_first_s"], out[f"{name}_ms"] = first, dt * 1e3
        return res

    buckets = stage("accum", lambda: msm_bucket.msm_accum(scal, px, py, c, nwin, T, cc))
    parts = stage("fold", lambda: msm_bucket.msm_fold(buckets, cc))
    stage("lane_reduce", lambda: msm_bucket.msm_lane_reduce(parts, cc))
    return out


def ntt_compile(*ks: int, device) -> dict:
    """MrNttPlan set-up, first call and warm call at each k."""
    ks = ks or (14, 16, 18, 20)
    rng = np.random.default_rng(0)
    p = Fq.MODULUS
    out = {}
    for K in ks:
        omega = pow(Fq.ROOT_OF_UNITY, 1 << (Fq.S - K), p)
        a = _canon(rng, 1 << K, device)
        t0 = time.perf_counter()
        plan = MrNttPlan(Fq, K, omega)
        setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan(a)
        _sync(device)
        first = time.perf_counter() - t0
        dt = timeit(lambda: plan(a), device, iters=3, warm=1)
        print(f"k={K}: set-up {setup:.2f}s  first call {first:.2f}s  warm {dt * 1e3:.3f} ms  "
              f"{(1 << K) / dt / 1e6:.1f} M elems/s", flush=True)
        out[K] = dict(setup_s=setup, first_s=first, warm_ms=dt * 1e3)
    return out


def sortgather(log_n: int = 20, *, device) -> dict:
    """torch sort / argsort / gather / scatter-add / cumsum at 2^log_n."""
    n = 1 << log_n
    rng = np.random.default_rng(0)
    keys = torch.as_tensor(rng.integers(0, 1 << 16, n).astype(np.int32), device=device)
    vals = torch.as_tensor(rng.integers(0, 1 << 16, (n, 32)).astype(np.int32), device=device)
    idx = torch.argsort(keys)
    ones = torch.ones(n, dtype=torch.int32, device=device)
    hist = torch.zeros(1 << 16, dtype=torch.int32, device=device)
    ops = {
        "sort": lambda: torch.sort(keys),
        "argsort": lambda: torch.argsort(keys),
        "gather": lambda: vals[idx],
        "scatter_add_histogram": lambda: hist.zero_().scatter_add_(0, keys.long(), ones),
        "cumsum": lambda: torch.cumsum(vals, 0),
    }
    out = {}
    for name, fn in ops.items():
        out[f"{name}_ms"] = timeit(fn, device) * 1e3
        print(f"{name} 2^{log_n}: {out[f'{name}_ms']:.3f} ms", flush=True)
    gb = n * 32 * 4 * 2 / 1e9
    print(f"gather (2^{log_n}, 32) int32 rows: {gb / out['gather_ms'] * 1e3:.0f} GB/s", flush=True)
    return out


SECTIONS = {"tilemul": tilemul, "oplat": oplat, "msm_accum": msm_accum,
            "ntt_compile": ntt_compile, "sortgather": sortgather}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m halo2_tpu_torch.tools.profile_kernels",
                                     description="Microbenchmarks of the port's kernels.")
    parser.add_argument("section", choices=sorted(SECTIONS))
    parser.add_argument("args", nargs="*", type=int)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = parser.parse_args(argv)
    device = resolve_device(ns.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    SECTIONS[ns.section](*ns.args, device=device)


if __name__ == "__main__":
    main()
