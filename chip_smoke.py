"""Smoke run of halo2_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the four CUDA kernels from halo2_tpu_torch/csrc with nvcc (sm_90a),
holds each kernel against its plain torch version on the card at the
main path's shapes and times both, reproduces the golden proof bytes of
MulCircuit (k = 4), drives the main path once: IPA/Vesta params ->
keygen_vk -> keygen_pk -> create_proof -> verify_proof for BenchCircuit at
k = 14, with the kernels' launch counters set to 0 just before and read just
after. It then proves the same circuit twice more, warm: once plain, once
with the four kernels timed by CUDA events and every kernel on the card traced
by torch.profiler, which gives the device time of one proof. Last it
reproduces the proof bytes of BenchCircuit at k = 10. Every phase prints one
JSON line; any failure raises and exits non-zero. The last line is

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

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# BenchCircuit at k = 10, seed 42, ChaCha20Rng(b"\x2a" * 32): the sha256 of
# the proof the JAX package makes on the CPU (tests/test_torch_prove.py
# names the command).
BENCH_K10_PROOF_SHA256 = "08b4952d1b1cac2b4951ac6097ac2f6a260cddc729bb0d54cb788de8510af1db"

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


def require(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from halo2_tpu_torch.circuits import MulCircuit, bench_circuit_for_k
    from halo2_tpu_torch.curves import Vesta
    from halo2_tpu_torch.fields import Fp
    from halo2_tpu_torch.ops import _build, msm_bucket, ntt_cg
    from halo2_tpu_torch.ops.curve import CurveCtx
    from halo2_tpu_torch.ops.field import FieldCtx, from_mont, limbs_to_ints
    from halo2_tpu_torch.ops.msm import MSMBases, msm_host
    from halo2_tpu_torch.ops.ntt import NttPlan
    from halo2_tpu_torch.plonk.error import OpeningError
    from halo2_tpu_torch.plonk.keygen import keygen_pk, keygen_vk
    from halo2_tpu_torch.plonk.prover import create_proof
    from halo2_tpu_torch.plonk.verifier import verify_proof
    from halo2_tpu_torch.poly.ipa import ParamsIPA
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

    def rand_canon(shape):
        """Uniform field elements < q as canonical 16-bit limbs, from the seed."""
        limbs = rng.integers(0, 1 << 16, size=shape + (16,), dtype=np.int64)
        limbs[..., 15] &= 0x3FFF  # < 2^254 < q
        return torch.as_tensor(limbs.astype(np.int32), device=dev)

    errs = {}

    def same(name, a, b, ctx, what):
        """Record the largest limb difference of the canonical values; fail unless 0."""
        d = (from_mont(a.reshape(-1, 16), ctx) - from_mont(b.reshape(-1, 16), ctx)).abs().max()
        errs[name] = max(errs.get(name, 0), int(d))
        require(int(d) == 0, what)

    def canon_equal(a, b):
        return torch.equal(from_mont(a.reshape(-1, 16), sctx), from_mont(b.reshape(-1, 16), sctx))

    report = {}

    def zero_launches():
        for counts in (ntt_cg.LAUNCHES, msm_bucket.LAUNCHES):
            for name in counts:
                counts[name] = 0

    def read_launches():
        return {**ntt_cg.LAUNCHES, **msm_bucket.LAUNCHES}

    # ---- kernel 1: constant-geometry NTT level ----
    t0 = time.perf_counter()
    for log_n in (14, 16):
        n = 1 << log_n
        omega = pow(Fp.ROOT_OF_UNITY, 1 << (Fp.S - log_n), q)
        omega_inv = pow(omega, -1, q)
        x = sctx.to_mont(rand_canon((n,)))
        fwd = ntt_cg.CgNttPlan(Fp, log_n, omega)
        inv = ntt_cg.CgNttPlan(Fp, log_n, omega_inv)
        # every level of both plans: kernel == plain on the same inputs
        for plan in (fwd, inv):
            tabs = plan._tables(dev)
            for li, (lv, tab) in enumerate(zip(plan.levels, tabs)):
                xl = sctx.to_mont(rand_canon((n // lv["f"], lv["f"])))
                yk = ntt_cg.cg_ntt_level(xl, tab["stw"], tab["inter"], sctx)
                yp = ntt_cg.cg_ntt_level_plain(xl, tab["stw"], tab["inter"], sctx)
                same("cg_ntt_level", yk, yp, sctx, f"cg_ntt_level 2^{log_n} level {li}: kernel != plain")
        y = fwd(x)
        require(canon_equal(y, NttPlan(Fp, log_n, omega)(x)), f"NTT 2^{log_n} != radix-2 reference")
        back = sctx.mul(inv(y), sctx.const(pow(n, -1, q), dev))
        require(canon_equal(back, x), f"inverse NTT 2^{log_n} does not invert")
        ms_full = time_ms(lambda: fwd(x))
        emit({"phase": "ntt", "log_n": log_n, "exact": True, "full_transform_ms": ms_full,
              "levels": [(lv["f"], lv["g"]) for lv in fwd.levels]})
        if log_n == 16:
            lv, tab = fwd.levels[0], fwd._tables(dev)[0]
            f, g = lv["f"], lv["g"]
            xl = sctx.to_mont(rand_canon((n // f, f)))
            ms = time_ms(lambda: ntt_cg.cg_ntt_level(xl, tab["stw"], tab["inter"], sctx))
            plain_ms = time_ms(lambda: ntt_cg.cg_ntt_level_plain(xl, tab["stw"], tab["inter"], sctx), 2)
            nbytes = 4 * (xl.numel() * 2 + tab["stw"].numel() + tab["inter"].numel())
            # products by a twiddle other than 1: stage 0's are all 1, and so
            # is inter row 0 and slot 0 of every inter row
            one = sctx.const(1, dev)
            cols = n // f
            stw_prods = int((tab["stw"] != one).any(-1).sum())
            inter_prods = (tab["inter"] != one).any(-1).sum(-1)
            prods = cols * stw_prods + int(inter_prods[torch.arange(cols, device=dev) % g].sum())
            b_ms, b_by = bound(nbytes, mont_mul_instrs(q) * prods)
            report["cg_ntt_level"] = dict(
                route="cuda", source="halo2_tpu_torch/csrc/ntt_cg.cu",
                replaces="halo2_tpu/ops/ntt_pallas2.py:219",
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shape=f"cols={n // f} f={f} g={g} (first level of 2^16)",
            )
            emit({"phase": "time", "kernel": "cg_ntt_level", **report["cg_ntt_level"]})
    emit({"phase": "ntt_done", "seconds": time.perf_counter() - t0})

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
        same("msm_lane_reduce", rk, rp, pctx, f"msm_lane_reduce n={n}: kernel != plain")
        pts = msm_bucket.msm_bucket_many(canon, bases, mont=False)
        checked_host = False
        if c == 4:
            ints = limbs_to_ints(canon[0].cpu())
            require(pts[0] == msm_host(ints, bases_pts[:n], Vesta), f"MSM n={n} != msm_host")
            checked_host = True
        emit({"phase": "msm", "n": n, "M": M, "c": c, "nwin": nwin, "T": T, "exact": True,
              "host_checked": checked_host, "seconds": time.perf_counter() - t1})
        if c == 4:
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
            emit({"phase": "msm_work", "n": n, "M": M, "nonzero_digits": int(nz.sum()),
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
            for name, (kfn, pfn, nbytes, muls, replaces) in timings.items():
                b_ms, b_by = bound(nbytes, muls)
                report[name] = dict(
                    route="cuda", source="halo2_tpu_torch/csrc/msm_bucket.cu", replaces=replaces,
                    ms=time_ms(kfn), plain_ms=time_ms(pfn, 1), bound_ms=b_ms, bound_by=b_by,
                    library_ms=None, shape=f"M={M} n={n} c={c} T={T}",
                )
                emit({"phase": "time", "kernel": name, **report[name]})

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
    stages.update(params_s=t1 - t0, keygen_vk_s=t2 - t1, keygen_pk_s=t3 - t2, prove_s=t4 - t3,
                  verify_s=t5 - t4)
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    try:
        rejected = verify_proof(params, vk, [[]], Blake2bRead(Vesta, bytes(bad))) is not True
    except (OpeningError, TranscriptError):
        rejected = True
    require(rejected, "k=14 proof with a flipped byte was accepted")
    for name, cnt in launches.items():
        require(cnt > 0, f"kernel {name} was not launched on the main path")
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
    kernel_symbol = {"cg_ntt_level": "cg_level_kernel(", "msm_accum": "accum_kernel(",
                     "msm_fold": "fold_kernel(", "msm_lane_reduce": "lane_reduce_kernel("}
    traced_ms = {name: sum(e.time_range.elapsed_us() for e in dev_events if sym in e.name) / 1e3
                 for name, sym in kernel_symbol.items()}
    busy_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3 if dev_events else None
    emit({"phase": "device_time_k14", "profiled_prove_s": profiled_s,
          "device_events": len(dev_events), "device_busy_ms": busy_ms,
          "device_busy_share_of_warm_prove": None if busy_ms is None else busy_ms / 1e3 / warm_s,
          "kernels_event_ms": proof_ms, "kernels_traced_ms": traced_ms})

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

    kernels = []
    for name, rec in report.items():
        kernels.append({"name": name, "route": rec["route"], "source": rec["source"],
                        "replaces": rec["replaces"], "launches": launches[name],
                        "max_abs_err": errs[name], "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                        "shape": rec["shape"], "ms_per_warm_proof": proof_ms[name]})
    require(sorted(report) == sorted(launches), "every kernel has a report row")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
