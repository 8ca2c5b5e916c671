"""Times the bucket MSM's kernels 2-4 and the BenchCircuit proofs of one tree
of this repository, so that two trees (a parent commit unpacked beside the
checkout, and the checkout) can be read on one card in one run.

    python3 halo2_tpu_torch/tools/msm_ab.py [--tree DIR] [--proofs]

It imports `halo2_tpu_torch` from DIR (default: the checkout this file lies
in), so run it as a script, not with `-m`. It prints one JSON line per
shape and, with `--proofs`, per proof:

- the kernels alone at the k = 14 commit shape (M = 3, n = 2^14 + 1, c = 4)
  and at M = 2, n = 2^15, c = 8 (bases of the k = 14 params, scalars from a
  numpy seed): the median CUDA-event time of each kernel over 5 warm
  launches, the sha256 of the bucket tensor (the bytes kernel 2 writes, in the
  first port's (rows, B, 3, 16, T) order whatever the tree's layout) and
  of the window sums as affine points (the group elements kernels 3 and 4
  give, whatever their projective coordinates);
- BenchCircuit at k = 14 and k = 16 (seed 42, `ChaCha20Rng(b"\\x2a" * 32)`):
  the sha256 of the proof, prove seconds, and kernels 2-4's launches and
  CUDA-event milliseconds in the proof.

It needs a CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("msm_accum", "msm_fold", "msm_lane_reduce")


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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--proofs", action="store_true")
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("msm_ab: CUDA is not available", file=sys.stderr)
        return 1
    tree = os.path.abspath(ns.tree)
    sys.path.insert(0, tree)
    import halo2_tpu_torch
    from halo2_tpu_torch.circuits import bench_circuit_for_k
    from halo2_tpu_torch.curves import Vesta
    from halo2_tpu_torch.ops import msm_bucket
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
    for label, n, M, pts in (
        ("k14_commit", (1 << 14) + 1, 3, params14.g + [params14.w]),
        ("c8_M2", 1 << 15, 2, params14.g + params14.g_lagrange),
    ):
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
        ms = {
            "msm_accum": time_ms(lambda: msm_bucket.msm_accum(scal, db.px, db.py, c, nwin, T, cc)),
            "msm_fold": time_ms(lambda: msm_bucket.msm_fold(bk, cc)),
            "msm_lane_reduce": time_ms(lambda: msm_bucket.msm_lane_reduce(fk, cc)),
        }
        if bk.shape[-1] != T:  # (rows, T, B, 3, 16) -> the first port's (rows, B, 3, 16, T)
            bk = bk.permute(0, 2, 3, 4, 1)
        emit({"shape": label, "M": M, "n": n, "c": c, "nwin": nwin, "T": T, "ms": ms,
              "buckets_sha256": hashlib.sha256(bk.contiguous().cpu().numpy().tobytes()).hexdigest(),
              "window_sums_affine_sha256": hashlib.sha256(affine).hexdigest()})

    if not ns.proofs:
        return 0
    for k in (14, 16):
        params = params14 if k == 14 else ParamsIPA.cached(Vesta, k, device=dev)
        circ = bench_circuit_for_k(k)
        vk = keygen_vk(params, circ.without_witnesses())
        pk = keygen_pk(params, vk, circ.without_witnesses())
        log = []
        originals = {name: getattr(msm_bucket, name) for name in KERNELS}

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

        for name in KERNELS:
            setattr(msm_bucket, name, timed(name))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr = Blake2bWrite(Vesta)
            create_proof(params, pk, [circ], [[]], ChaCha20Rng(b"\x2a" * 32), tr)
            proof = tr.finalize()
            torch.cuda.synchronize()
            prove_s = time.perf_counter() - t0
        finally:
            for name in KERNELS:
                setattr(msm_bucket, name, originals[name])
        ms = {name: 0.0 for name in KERNELS}
        launches = {name: 0 for name in KERNELS}
        for name, start, end in log:
            ms[name] += start.elapsed_time(end)
            launches[name] += 1
        emit({"proof_k": k, "sha256": hashlib.sha256(proof).hexdigest(), "bytes": len(proof),
              "prove_s": prove_s, "launches": launches, "event_ms": ms})
    return 0


if __name__ == "__main__":
    sys.exit(main())
