"""Smoke run of halo2_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the eighteen CUDA kernels from halo2_tpu_torch/csrc with nvcc (sm_90a),
holds each kernel against its plain torch version on the card at the
main path's shapes and times both (kernels C-H, the JAX package's jitted
scans, evaluations, Kate division, IPA rounds, grand products and Horner
fold, as values mod p with
every output in [0, 2p) on each of the four moduli, each call of a kernel
under torch.cuda.set_sync_debug_mode("error"), so that a host sync inside
raises: kernel C's prefix products, inclusive, exclusive and exclusive
from an init, and batch inversion at 2^11, 2^14 + 3 and 2^17 rows and at a
tile's rows - 1, + 0 and + 1 and 33 tiles, with 0 and p (inverted to 0),
1, p - 1 and 2p - 1 first, and after replays of a CUDA graph, and its
inverse of a total (a binary GCD) against the host's pow on 256 values a
modulus; kernel D's batch
evaluation at M = 3 (a repeated point and the point 0), at M = 1 and at
the largest evaluation stack of the k = 14 proof, also after replays of a
CUDA graph, and its powers of one point and of a batch of two on the card
and of host points; kernel E's Kate division at b = 0, 1, p - 1 and a random
b at the sizes of kernel C, also after replays of a CUDA graph; kernel
F's emit, fold and fused round (a fold and the next round's emit in one
launch) in every round of an opening over 2^14 lanes, m = 2^14 down to 2,
the fused round also after replays of a CUDA graph; each timed on Fp at
2^14 beside its bound (C-E also at 2^17), D-F each
launched on every proof path but F on the KZG one, C on none since G took
the z columns (phases scan, batch_eval, kate_div, ipa_round), and the launches of one proof on each
path in phase launches_per_proof; kernel G's z columns (a lookup's, and six
permutation chunks of 1-6 columns chained by last_z) and kernel H's fold of
M = 2, 3 and 7 pieces at 2^11, 2^14 + 3 and 2^17 rows on the four moduli,
zero and p denominators among G's first rows, also after replays of a CUDA
graph and on two streams at once, G as values mod p and H bit for bit,
each timed on Fp at 2^14 and 2^17, three device kernels a z column and one
launch a proof on every path (phases grand_product, horner), and kernel
A's launches in a warm k = 14 proof by call site (warm_k14's
launches_by_site); kernel A, the
elementwise Montgomery product, sum and difference of ops/field.py on
the card, bit for bit on
each of the four moduli at 2^20 elements with the edge values 0, 1, p - 1,
2p - 1, and 2p and 2p + d on Pasta, and on every broadcast pattern the
prover gives it; kernel B, the quotient fold of one part, bit for bit
against the plain program and the eager fold on every part of the first
k = 14, poseidon11 and sinsemilla14 proofs and on part 0 of the sha256_k17
proof, each part's scalar table one launch of kernel B equal to the plain
one, part 0 of each timed beside its bound, with each program's bundles,
slots and launch geometry and kernel B's ptxas lines, whose stack frames
must be empty; both launched on every proof path) (the bucket MSM's kernels 2-4 at both
window widths: c = 4 at M = 3, n = 2^14 + 1 and c = 8 at M = 2, n = 2^15,
each MSM also against msm_host, kernel 4 bit for bit, also on parts that hold
the identity, a pair P, P and a pair P, -P; kernel 1 bit for bit at every
level of the 2^14 and 2^16 plans, both directions, on edge inputs 0, 1,
p - 1 and 2p - 1 beside values below 2p, and timed at every level of both;
kernel 7 also on identity, equal and opposite windows). Kernels 1-7 are held
the same way in their generic form, on BN254 (the KZG backend's curve):
kernel 1 over its scalar field FrBn at 2^14 and 2^16, kernels 2-4 on its G1
(3b = 9) at the KZG commit shape M = 3, n = 2^14, c = 4, kernels 5-7 at
n = 2^16 + 1, on bases (i + 1) G made by a host addition chain, each timed
beside its Pasta-form row. The script reproduces the golden proof bytes of
MulCircuit (k = 4), and drives these paths, each with the kernels' launch
counters set to 0 just before it and read just after:

* k = 14: IPA/Vesta params -> keygen_vk -> keygen_pk -> create_proof ->
  verify_proof for BenchCircuit, which runs kernels 1-4; the proof has the
  pinned bytes (BENCH_K14_PROOF_SHA256). It then proves the
  same circuit twice more, warm: once plain, once with the four kernels timed
  by CUDA events and every kernel on the card traced by torch.profiler, which
  gives the device time of one proof; then twice more on the same keys, under
  EVAL_H=full (the plain full extended-domain fold) and under MSM=sorted
  (every msm() call on the sorted MSM, kernels 5-7), both to the pinned
  bytes; and reproduces the proof bytes of BenchCircuit at k = 10.
* batch14: BatchVerifier over the pinned k = 14 proof and one made with
  another rng: it accepts both, its one combined final MSM runs kernels 2-4,
  and it returns False when one byte of the second proof is flipped.
* mock14: MockProver on BenchCircuit at k = 14, its vectorised check on the
  card (limb tensors, no kernel of csrc/): no failure; a copy of the witness
  with one c cell changed reports the gate's failure at that row, rendered
  as the row loop renders it.
* poseidon11: gating config 2 of BASELINE.md, the Poseidon hash gadget at
  k = 11 (HashCircuit([7, 11]), circuits.poseidon_k11): params -> keygen ->
  a first and a warm proof -> verify, to the JAX package's bytes
  (POSEIDON_K11_PROOF_SHA256); a flipped byte and a wrong digest fail to
  verify. Kernels 1-4 run (the batched commits and the IPA rounds go to the
  bucket MSM; single MSMs of 2^11 points stay on the host).
* sinsemilla14: gating config 4 of BASELINE.md, the Sinsemilla hash gadget
  at k = 14 (SinsemillaCircuit, 3 words, the 2^10-row generator table under
  the lookup argument, circuits.sinsemilla_k14): params -> keygen -> a
  first, a warm and a traced proof (kernels 1-4 by CUDA events, the card by
  torch.profiler) -> verify, to the bytes of the card's first proof
  (SINSEMILLA_K14_PROOF_SHA256); a flipped byte fails to verify. Kernels 1-4
  run. sinsemilla11: the same circuit and seeds at k = 11, to the bytes the
  port's plain path gives on the CPU (SINSEMILLA_K11_PROOF_SHA256).
* mesh14: the k = 14 proof again on the same keys under `parallel.use_mesh`
  over four shards (four cards where the machine has four, else four logical
  shards of the one card): the pinned bytes, verified; the four-step NTT, the
  sharded MSM and the row-sharded quotient fold (`evaluate_h_mesh`) each
  taken at least once (`parallel.context.CALLS`), kernels 1-4 launched.
* sha256_k17: the SHA-256 gadget (Table16, the 2^16-row spread table) over
  the 14 blocks of an 887-byte message at k = 17, extended 2^20
  (circuits.sha256_k17): params -> keygen -> one proof -> verify, to the bytes
  of the card's first proof (SHA256_K17_PROOF_SHA256) and, where
  tests/fixtures_torch_sha256.json holds it, the JAX package's VK transcript
  repr; a flipped byte fails to verify. Kernels 1-7 run (the σ commits, the
  vanishing argument's random commit and the verifier's MSM take the sorted
  MSM).
* sha256_mock: MockProver on one SHA-256 block (b"abc") at k = 17, the
  vectorised check on the card: no failure; the JAX test's planted cell (the
  first dense cell that is not 0 or 1, plus one) reported as its lookup's
  failure at its row, rendered as the row loop renders it.
* ecc_mock: MockProver on the ECC and Merkle gadgets, its vectorised check
  on the card: full-width variable-base and fixed-base multiplications at
  k = 12, a depth-2 Merkle path at k = 11; no failure, and a planted wrong
  cell (a swapped node and sibling for the Merkle path) reported at its row
  with the row loop's text.
* KZG at k = 14 (route `kzg14`): ParamsKZG (BN254) -> keygen_vk ->
  keygen_pk -> create_proof (SHPLONK, Blake2b) -> verify_proof (a pairing
  check on the host) for BenchCircuit over FrBn, which runs kernels 1-4 in
  their generic form; the proof has the pinned bytes
  (BENCH_KZG_K14_PROOF_SHA256), verifies and rejects a flipped byte; a warm
  proof is traced as at k = 14 above and repeats the bytes; one GWC proof
  with the Keccak256 transcript proves and verifies. BenchCircuit over
  FrBn at k = 10 then gives the JAX package's bytes
  (BENCH_KZG_K10_PROOF_SHA256).
* k = 16: the same entry points for BenchCircuit at k = 16, where keygen's
  sigma commits, the vanishing argument's random commit and the verifier's
  final MSM take the sorted-bucket MSM (kernels 5-7) and every other MSM the
  bucket MSM at c = 8 (kernels 2-4, timed by CUDA events through the proof
  beside kernels 5-7; kernel 1's launches counted too). The proof has the
  pinned bytes (BENCH_K16_PROOF_SHA256)
  and verifies, a flipped byte is rejected, and the proof made again with the sorted MSM
  switched off (MSM=pallas) has the same bytes; commit_lagrange(v) =
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

* mesh_ops: the mesh's operations at gating config 5's sizes on four
  logical shards of the card: FourStepNtt at 2^20 against the one-device
  kernel-1 plan (equal canonical values), and sharded_msm of 2^20 points (the
  k = 16 generators tiled 16 times) against the one-device msm(), both timed
  by CUDA events.

Bounds: the bytes a kernel must move at 3.35 TB/s, or its Montgomery
products, each counted in the instruction forms its kernel uses at the
rates this card runs them (product_mix, MUL_RATES), or for kernel 7 the
multiply instructions of its chain of dependent products issued one a
cycle, whichever is largest.

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
# BenchCircuit over BN254's scalar field (the KZG path: SHPLONK, Blake2b), the
# same seed and rng. At k = 10 the sha256 of the proof the JAX package makes on
# the CPU on `ParamsKZG.cached(10)` (tests/test_torch_kzg.py names the
# command); at k = 14 the sha256 of the first proof the port made on an H100
# (this script, before it was pinned).
BENCH_KZG_K10_PROOF_SHA256 = "c4f216e517414c290a95e4bcedcce5e50788bd68f868b06aff0eadb6ecc377fa"
BENCH_KZG_K14_PROOF_SHA256 = "caeb836fcc28301792ec18ed652290d83dc5599474940f2192df3f3caa98785a"
# Gating config 2 (HashCircuit([7, 11]) at k = 11, ChaCha20Rng(b"\x02" * 32)):
# the sha256 of the proof the JAX package makes on the CPU
# (tests/test_torch_gadgets.py names the command).
POSEIDON_K11_PROOF_SHA256 = "23e86128f8ff13e45491b2d503d84b2240e3946cc0c0239a9d6cd722b6a6ac25"
# Gating config 4, SinsemillaCircuit (3 words, bits from random.Random(21),
# ChaCha20Rng(b"\x04" * 32)): the sha256 of the card's first proofs at k = 11
# and k = 14; the port's plain path on the CPU gives the k = 11 bytes too. The
# JAX package's k = 11 proof (`python tests/test_torch_sinsemilla.py 11` on
# the CPU) is the cross-package check, not yet made.
SINSEMILLA_K11_PROOF_SHA256 = "b8ba0577e970f481f0b1c4cbb7affaab5eb6f2f4788ba6251075a7c80420152f"
SINSEMILLA_K14_PROOF_SHA256 = "b6f17028fe899840f594d8b4a08d8983bb5912124c9de98bc199569a86fcd052"
# The SHA-256 gadget at k = 17 (circuits.sha256_k17: 14 blocks of an
# 887-byte message from random.Random(17), ChaCha20Rng(b"\x05" * 32)): the
# sha256 of the card's first proof. The JAX package's proof at k = 17 is out
# of reach on the CPU; its VK's transcript repr is checked where
# tests/fixtures_torch_sha256.json holds it.
SHA256_K17_PROOF_SHA256 = "1d2de4163bd23c4eb44c0bf1a8c7e9273242375470d32387279eaa532fb94cc9"

# Bounds. Device memory moves 3.35e12 B/s (H100 SXM data sheet). The
# operations bound counts the 32-bit multiply instructions of each Montgomery
# product in the form its kernel computes it (product_mix), each instruction
# form at the rate this card runs it over a full grid (`python -m
# halo2_tpu_torch.tools.profile_kernels oplat`, its mul_peak probe, on an
# NVIDIA H100 80GB HBM3 at 700 W): mad.lo 1.604e13, mad.hi 7.405e12 and
# mad.wide.u32 5.207e12 instructions/s. Only multiplies are counted, so the
# operation bound is a lower bound on what the card must spend. Kernel 7, one
# warp's chain of dependent products, is bound by issue instead: its products
# in series x their multiply instructions, one a cycle, at the SM clock of
# 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
MUL_RATES = {"wide": 5.207e12, "lo": 1.604e13, "hi": 7.405e12}
SM_CLOCK_HZ = 1.98e9
# product rounds in series of one doubling (warp_double) and one addition
# (warp_add) of kernel 7
HORNER_ROUNDS = 3
# Montgomery products per complete addition (RCB15, a = 0): 11 general
# products for the mixed addition (alg. 8), 12 for the full one (alg. 7). Each
# also multiplies twice by 3b (15 on Pasta, 9 on BN254's G1), which shifts and
# additions can do, so the bounds leave those products out.
MIXED_ADD_PRODUCTS = 11
FULL_ADD_PRODUCTS = 12
# RCB15 algorithm 9 (a = 0): 9 products, one of them by 3b
DOUBLE_PRODUCTS = 8


def product_mix(p: int, form: str = "cc"):
    """(mul.wide, mad.lo, mad.hi) 32-bit multiply instructions of one
    Montgomery product mod p in csrc/field.cuh's `form`. "cc", fe_mul_cc
    (kernels 1, 4, 7-10, A and B): each of the 8 rows takes a * b_i by 8
    mul.wide.u32, then m * p: for a modulus of pasta_form (p = 1 + d' 2^32 +
    2^254, Fp and Fq) 3 low and 3 high products of m and d' off the chain,
    else m = t0 n0 and 8 mad.lo and 8 mad.hi over p. "generic", fe_mul
    (kernels 2, 3, 5 and 6): each row 8 mul.wide for a * b_i, m = t0 n0 and 8
    mul.wide for m * p."""
    words = [(p >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    pasta = words[0] == 1 and words[4:7] == [0, 0, 0] and words[7] == 0x40000000
    if form == "generic":
        return 128, 8, 0
    return (64, 24, 24) if pasta else (64, 72, 64)


def product_s(p: int, form: str = "cc") -> float:
    """Seconds of the card's multiply pipe one product takes (product_mix at
    MUL_RATES)."""
    wide, lo, hi = product_mix(p, form)
    return wide / MUL_RATES["wide"] + lo / MUL_RATES["lo"] + hi / MUL_RATES["hi"]


def emit(obj):
    print(json.dumps(obj), flush=True)


def chain_points(curve, n: int):
    """(i + 1) G for i < n, affine: a host addition chain, one inversion."""
    from halo2_tpu_torch.curves import JAC_IDENTITY, Point, batch_to_affine, jac_add_affine

    p = curve.p()
    gx, gy = curve.generator().xy
    acc, jac = JAC_IDENTITY, []
    for _ in range(n):
        acc = jac_add_affine(acc, gx, gy, p)
        jac.append(acc)
    return [Point(curve, xy) for xy in batch_to_affine(jac, p)]


def bound(bytes_moved: float, op_s: float):
    """(bound ms, what bounds it): the larger of the bytes at HBM_BYTES_PER_S
    and `op_s`, the seconds of the card's multiply pipe (product_s)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = op_s * 1e3
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


# the device kernels of each kernel of the port, by a part of their symbols
KERNEL_SYMBOLS = {"cg_ntt_level": ("cg_level_kernel",), "msm_accum": ("accum_kernel(",),
                  "msm_fold": ("fold_kernel(",), "msm_lane_reduce": ("lane_reduce_kernel<",),
                  "field_ew": ("ew_kernel<",), "fold_program": ("fold_kernel<",),
                  "scan": ("::scan_kernel<", "invert_prefix_kernel<", "invert_suffix_kernel<"),
                  "batch_eval": ("eval_kernel<", "powers_kernel<"),
                  "kate_div": ("kate_kernel<",),
                  "ipa_round": ("round_kernel<",),
                  "grand_product": ("grand_den_kernel<", "grand_fraction_kernel<", "grand_z_kernel<"),
                  "horner": ("pieces_horner_kernel<",)}


def traced_proof(prove, wrapped):
    """prove() once, each (module, name) of `wrapped` timed by CUDA events
    and every kernel on the card traced by torch.profiler: (its result,
    {profiled_prove_s, device_events, device_memsets, device_busy_ms,
    kernels_event_ms, kernels_traced_ms, kernels_traced_launches}); the last
    two give each kernel of KERNEL_SYMBOLS its device time and its device
    kernels. device_events counts every device operation, device_memsets
    the memsets among them (kernels C and E zero their flags by one a call:
    a device operation, not a kernel)."""
    event_log = []
    originals = {name: getattr(mod, name) for mod, name in wrapped}
    for mod, name in wrapped:
        setattr(mod, name, timed(name, originals[name], event_log))
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = prove()
            torch.cuda.synchronize()
            profiled_s = time.perf_counter() - t0
    finally:
        for mod, name in wrapped:
            setattr(mod, name, originals[name])
    event_ms = {name: 0.0 for name in originals}
    for name, start, end in event_log:
        event_ms[name] += start.elapsed_time(end)
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    traced_ms = {name: sum(e.time_range.elapsed_us() for e in dev_events
                           if any(sym in e.name for sym in syms)) / 1e3
                 for name, syms in KERNEL_SYMBOLS.items()}
    traced_launches = {name: sum(1 for e in dev_events if any(sym in e.name for sym in syms))
                       for name, syms in KERNEL_SYMBOLS.items()}
    busy_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3 if dev_events else None
    memsets = sum(1 for e in dev_events if "memset" in e.name.lower())
    return out, dict(profiled_prove_s=profiled_s, device_events=len(dev_events), device_memsets=memsets,
                     device_busy_ms=busy_ms,
                     kernels_event_ms=event_ms, kernels_traced_ms=traced_ms,
                     kernels_traced_launches=traced_launches)


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


def once_ms(fn):
    """(fn(), the CUDA-event time of that one call in ms): the plain versions
    of kernels 2-7 take seconds, so the call made for a check is also the
    one timed."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def captured(fn, reps: int):
    """fn() once on a side stream, then `reps` calls of it captured in one
    CUDA graph on that stream (kernels D and F keep a completion counter a
    stream, made by the first call): (the graph, the captured calls'
    outputs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):  # the stream fn warmed up on
        outs = [fn() for _ in range(reps)]
    return graph, outs


def replayed(fn, reps: int = 3):
    """The outputs of `reps` calls of fn captured in one CUDA graph, after
    the graph's second replay (the outputs zeroed before it): what every
    replay of a graph that holds the calls gives."""
    graph, outs = captured(fn, reps)
    graph.replay()
    for out in outs:
        out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    return outs


def device_ms(fn, reps: int = 10) -> float:
    """The card's time per call of fn(): `reps` calls captured in one CUDA
    graph, its replay timed by CUDA events. Unlike an event pair around one
    call it leaves out the host's launch time, which for a kernel of tens of
    microseconds is most of the event time; what remains between the
    kernels is the graph's launch gap of about a microsecond."""
    graph, _ = captured(fn, reps)
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


def proof_path(dev, read_launches, read_routes, tag, k, circ, instances, seed, pinned, wrong=None,
               wrapped=(), warm=True, vk_repr=None, fold_caps=None, fold_limit=None):
    """A gating config through the entry points: ParamsIPA.cached(Vesta, k)
    -> keygen_vk -> keygen_pk -> create_proof (Blake2b; a first proof, with
    `warm` a warm one, and with `wrapped` kernels a third, traced by
    traced_proof) -> verify_proof. The VK must have the transcript repr
    `vk_repr` where one is given; the proof must have the `pinned` sha256,
    verify, and fail to verify with a flipped byte or with the `wrong`
    instances. With a list `fold_caps`, the first proof's quotient folds
    (at most `fold_limit` parts) are captured into it (fold_capture)."""
    from halo2_tpu_torch.curves import Vesta
    from halo2_tpu_torch.plonk.error import OpeningError
    from halo2_tpu_torch.plonk.keygen import keygen_pk, keygen_vk
    from halo2_tpu_torch.plonk.prover import create_proof
    from halo2_tpu_torch.plonk.verifier import verify_proof
    from halo2_tpu_torch.poly.ipa import ParamsIPA
    from halo2_tpu_torch.transcript import Blake2bRead, Blake2bWrite, TranscriptError
    from halo2_tpu_torch.utils.chacha import ChaCha20Rng
    from halo2_tpu_torch.utils.measure import get_records, get_totals, reset_records

    marks, routes = {}, {}
    t0 = time.perf_counter()
    params = ParamsIPA.cached(Vesta, k, device=dev)
    t1 = time.perf_counter()
    vk = keygen_vk(params, circ.without_witnesses())
    pk = keygen_pk(params, vk, circ.without_witnesses())
    sync(dev)
    t2 = time.perf_counter()
    marks["keygen"], routes["keygen"] = read_launches(), read_routes()
    if vk_repr is not None:
        require(hex(vk.transcript_repr) == vk_repr, f"{tag}: the VK's transcript repr differs from the pin")
    proofs, prove_s, spans, totals = [], [], [], []
    for _ in range(2 if warm else 1):  # the first proof, then a warm one
        reset_records()
        t3 = time.perf_counter()
        tr = Blake2bWrite(Vesta)
        with fold_capture(fold_caps if not proofs else None, fold_limit):
            create_proof(params, pk, [circ], [instances], ChaCha20Rng(seed), tr)
        proofs.append(tr.finalize())
        sync(dev)
        prove_s.append(time.perf_counter() - t3)
        spans.append(get_records())
        totals.append(get_totals())
        marks[f"prove_{len(proofs)}"], routes[f"prove_{len(proofs)}"] = read_launches(), read_routes()
    proof = proofs[0]
    require(proofs[-1] == proof, f"{tag}: the warm proof's bytes differ from the first")
    traced = None
    if wrapped:
        def prove():
            tr = Blake2bWrite(Vesta)
            create_proof(params, pk, [circ], [instances], ChaCha20Rng(seed), tr)
            return tr.finalize()

        proof_again, traced = traced_proof(prove, wrapped)
        require(proof_again == proof, f"{tag}: the traced proof's bytes differ from the first")
        busy_ms = traced["device_busy_ms"]
        traced["device_busy_share_of_warm_prove"] = None if busy_ms is None else busy_ms / 1e3 / prove_s[-1]
        marks["prove_traced"], routes["prove_traced"] = read_launches(), read_routes()
    t4 = time.perf_counter()
    ok = verify_proof(params, vk, [instances], Blake2bRead(Vesta, proof))
    t5 = time.perf_counter()
    marks["verify"], routes["verify"] = read_launches(), read_routes()
    require(ok is True, f"{tag}: verify")
    sha = hashlib.sha256(proof).hexdigest()
    require(sha == pinned, f"{tag} proof sha256 {sha} != {pinned}")
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    checks = [(instances, bytes(bad), "a flipped byte")]
    if wrong is not None:
        checks.append((wrong, proof, "wrong instances"))
    for inst, data, what in checks:
        try:
            rejected = verify_proof(params, vk, [inst], Blake2bRead(Vesta, data)) is not True
        except (OpeningError, TranscriptError):
            rejected = True
        require(rejected, f"{tag}: a proof with {what} was accepted")
    by_stage, prev = {}, {}
    for stage, counts in marks.items():
        by_stage[stage] = {name: c - prev.get(name, 0) for name, c in counts.items()}
        prev = counts
    return dict(k=k, extended_k=vk.domain.extended_k, proof_bytes=len(proof), pinned_sha256=True,
                vk_repr_pinned=vk_repr is not None,
                verified=True, flipped_byte_rejected=True, wrong_instances_rejected=wrong is not None,
                stages=dict(params_read_s=t1 - t0, keygen_s=t2 - t1, prove_first_s=prove_s[0],
                            prove_warm_s=prove_s[1] if warm else None, verify_s=t5 - t4),
                prove_spans_first=spans[0], prove_spans_warm=spans[1] if warm else None,
                totals_first=totals[0], totals_warm=totals[1] if warm else None,
                launches=marks["verify"], launches_by_stage=by_stage, routes_by_stage=routes,
                traced_warm=traced)


@contextmanager
def fold_capture(caps, limit=None):
    """Inside the block, each call of a quotient fold (ops/fold.Fold: kernel
    B on the card) appends (fold, arrays, coset_x, scalars, output) to
    `caps`, the first `limit` calls (all with None); nothing with caps None."""
    from halo2_tpu_torch.ops import fold as fold_mod

    if caps is None:
        yield
        return
    original = fold_mod.Fold.__call__

    def call(self, arrays, coset_x_vals, scal):
        out = original(self, arrays, coset_x_vals, scal)
        if limit is None or len(caps) < limit:
            caps.append((self, dict(arrays), coset_x_vals, scal, out))
        return out

    fold_mod.Fold.__call__ = call
    try:
        yield
    finally:
        fold_mod.Fold.__call__ = original


@contextmanager
def eval_capture(shapes):
    """Inside the block, each evaluation by kernel D
    (ops/polyeval.eval_launch) appends its (M, n, Q) to `shapes`, Q its
    distinct points."""
    from halo2_tpu_torch.ops import polyeval

    original = polyeval.eval_launch

    def launch(coeffs, points, ctx):
        shapes.append((coeffs.shape[0], coeffs.shape[1], len({int(x) % ctx.p_int for x in points})))
        return original(coeffs, points, ctx)

    polyeval.eval_launch = launch
    try:
        yield
    finally:
        polyeval.eval_launch = original


# what the kernels line keeps of each part's fold row
FOLD_ROW_KEYS = ("part", "rows", "instructions", "operations", "bundles", "mean_width", "live_slots",
                 "columns",
                 "threads_per_block", "shared_bytes_per_block", "scalar_table_launches", "device_ms",
                 "bound_ms", "x_bound", "scalar_table_device_ms")


def fold_check(tag, caps, timed_parts=1):
    """Kernel B's output of each captured part against run_program_plain (the
    same program with the plain field ops) and the eager fold (the walk on
    FVecs, kernel A), bit for bit, and the part's scalar table, one launch of
    kernel B and no launch of kernel A on the card, against scalar_table's
    plain path on the CPU. Returns a row a part: the program's recorded
    instructions, kernel B's operations (the recording's less its leaves,
    which the operations read where they lie), bundles and their mean width,
    live slots, columns, threads and shared bytes a block, the scalar
    table's launches, the plain and eager times
    (one call each, CUDA events), and for the first `timed_parts` parts
    kernel B's ms, device ms, bound and x bound, and the scalar table's
    device ms. The launches the comparisons make are taken back out of the
    counts."""
    from halo2_tpu_torch.ops import field_ew
    from halo2_tpu_torch.ops import fold as fold_mod

    saved = (dict(field_ew.LAUNCHES), dict(fold_mod.LAUNCHES))
    rows = []
    for i, (f, arrays, cx, scal, out) in enumerate(caps):
        prog = f.program
        cols = [arrays[j] for j in prog.array_ids]
        launches = (fold_mod.LAUNCHES["fold_program"], sum(field_ew.LAUNCHES.values()))
        table = fold_mod.scalar_table(prog, scal, cx.device)
        table_launches = fold_mod.LAUNCHES["fold_program"] - launches[0]
        require(table_launches == 1 and sum(field_ew.LAUNCHES.values()) == launches[1],
                f"{tag} part {i}: the scalar table took {table_launches} launches of kernel B "
                f"and {sum(field_ew.LAUNCHES.values()) - launches[1]} of kernel A, not one and none")
        cpu_scal = {k: ([t.cpu() for t in v] if k == "ch" else v.cpu()) for k, v in scal.items()}
        require(torch.equal(table.cpu(), fold_mod.scalar_table(prog, cpu_scal, "cpu")),
                f"{tag} part {i}: kernel B's scalar table != scalar_table's plain path")
        plain, plain_ms = once_ms(lambda: fold_mod.run_program_plain(prog, cols, cx, table))
        eager, eager_ms = once_ms(lambda: f.eager(arrays, cx, scal))
        require(list(out) == list(plain) == list(eager), f"{tag} part {i}: the clusters differ")
        for c in out:
            require(torch.equal(out[c], plain[c]), f"{tag} part {i} cluster {c}: kernel B != run_program_plain")
            require(torch.equal(out[c], eager[c]), f"{tag} part {i} cluster {c}: kernel B != the eager fold")
        counts = prog.counts()
        n = cx.shape[0]
        threads, shared, blocks = fold_mod.launch_geometry(prog.slots, n)
        row = dict(part=i, rows=n, clusters=list(prog.clusters), instructions=len(prog.vinstrs),
                   operations=len(prog.instrs), bundles=len(prog.bundle_sizes),
                   mean_width=len(prog.instrs) / len(prog.bundle_sizes),
                   width=prog.width, counts=counts, live_slots=prog.slots, columns=len(prog.array_ids),
                   threads_per_block=threads, shared_bytes_per_block=shared, blocks=blocks,
                   scalars=len(prog.scalar_defs), scalar_table_launches=table_launches,
                   scalar_program_bundles=len(prog.scalar_program.bundle_sizes), exact=True,
                   plain_ms=plain_ms, eager_ms=eager_ms)
        if i < timed_parts:
            def run():
                return fold_mod.run_program(prog, cols, cx, table)

            # each column it reads read once, the coset points, each cluster
            # written once, the program and the scalar table; a product a MUL a row
            nbytes = (64 * n * (len(prog.columns_read()) + (counts["COSET_X"] > 0) + len(prog.clusters))
                      + fold_mod.RECORD_BYTES * len(prog.instrs) + 64 * len(prog.scalar_defs))
            b_ms, b_by = bound(nbytes, counts["MUL"] * n * product_s(f.field.MODULUS))
            dev_ms = device_ms(run, 5)
            row.update(ms=time_ms(run), device_ms=dev_ms, bound_ms=b_ms, bound_by=b_by,
                       x_bound=dev_ms / b_ms, products=counts["MUL"] * n,
                       scalar_table_device_ms=device_ms(
                           lambda: fold_mod.scalar_table(prog, scal, cx.device), 5))
        rows.append(row)
    field_ew.LAUNCHES.update(saved[0])
    fold_mod.LAUNCHES.update(saved[1])
    return rows


def field_ew_path(dev, seed: int, log_n: int = 20):
    """Kernel A against its plain version, bit for bit: each op on each
    modulus (Fp, Fq, FrBn, FqBn) at 2^log_n elements below 2p, the edge
    values 0, 1, p - 1 and 2p - 1 (on the Pasta moduli also 2p and 2p + d,
    d = p - 2^254, the rare outputs of a product) in the first rows, and on
    every broadcast pattern the prover hands it at that size; then each op
    on Fp at 2^log_n timed (ms, device ms, the plain version's ms, bound).
    The launches it makes are taken back out of the counts."""
    from halo2_tpu_torch.fields import Fp, Fq, FqBn, FrBn
    from halo2_tpu_torch.ops import field as fo
    from halo2_tpu_torch.ops import field_ew

    saved = dict(field_ew.LAUNCHES)
    rng = np.random.default_rng(seed)
    n = 1 << log_n
    plain = {"mont_mul": fo.mont_mul_plain, "add_mod": fo.add_mod_plain, "sub_mod": fo.sub_mod_plain}
    checks, timing = [], {}
    for F in (Fp, Fq, FrBn, FqBn):
        p = F.MODULUS
        ctx = fo.FieldCtx(F)
        edge = [0, 1, p - 1, 2 * p - 1]
        if p >> 254 == 1:  # Pasta: p = 2^254 + d
            edge += [2 * p, 2 * p + p - (1 << 254)]

        def operand(shift):
            limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.int64)
            limbs[:, 15] %= (2 * p) >> 240  # below 2p
            limbs[: len(edge)] = fo.ints_to_limbs(edge[shift:] + edge[:shift])
            return torch.as_tensor(limbs.astype(np.int32), device=dev)

        a, b = operand(0), operand(1)
        small_a = a[:60].reshape(2, 1, 3, 1, 5, 2, 16)
        small_b = b[:48].reshape(1, 4, 1, 6, 1, 2, 16)
        cases = {
            "same": (a, b),
            "slices": (a[3:], b[:-3]),
            "stacked": (a.reshape(4, n // 4, 16), b.reshape(4, n // 4, 16)),
            "unsqueeze": (a[: n // 16].unsqueeze(-2), b.reshape(n // 16, 16, 16)),
            "scalar_right": (a, b[1]),
            "scalar_left": (b[2], a),
            "expanded": (a[:n // 8].unsqueeze(0).expand(8, n // 8, 16), b[:1]),
            "strided_limbs": (a.t().contiguous().t(), b),
            "six_dims": (small_a, small_b),
        }
        for pattern, (x, y) in cases.items():
            for op in field_ew.OPS:
                got = getattr(fo, op)(x, y, ctx)
                require(torch.equal(got, plain[op](x, y, ctx)),
                        f"field_ew {op} {F.__name__} {pattern}: kernel != plain (limbs)")
                checks.append(f"{F.__name__}:{pattern}:{op}")
        if F is Fp:
            for op in field_ew.OPS:
                def kern(op=op):
                    return getattr(fo, op)(a, b, ctx)

                b_ms, b_by = bound(3 * 64 * n, n * product_s(p) if op == "mont_mul" else 0.0)
                timing[op] = dict(ms=time_ms(kern), device_ms=device_ms(kern),
                                  plain_ms=time_ms(lambda op=op: plain[op](a, b, ctx), 2),
                                  bound_ms=b_ms, bound_by=b_by, shape=f"n=2^{log_n} (Fp)")
    field_ew.LAUNCHES.update(saved)
    return dict(n=n, checks=len(checks), exact=True, patterns=sorted({c.split(":")[1] for c in checks}),
                moduli=["Fp", "Fq", "FrBn", "FqBn"], ops=timing)


MODULI = ("Fp", "Fq", "FrBn", "FqBn")


def lazy_rows(rng, p: int, n: int, edge=()):
    """(n, 16) int32 limbs on the CPU of values uniform below 2p (lazy
    Montgomery values, from rng), the `edge` values in the first rows."""
    from halo2_tpu_torch.ops.field import ints_to_limbs

    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.int64)
    limbs[:, 15] %= (2 * p) >> 240
    edge = list(edge)[:n]
    if edge:
        limbs[: len(edge)] = ints_to_limbs(edge)
    return torch.as_tensor(limbs.astype(np.int32))


@contextmanager
def no_sync(dev):
    """Inside the block a host sync with the card raises
    (torch.cuda.set_sync_debug_mode("error")); nothing on the CPU."""
    if torch.device(dev).type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def values_equal(got, want, ctx) -> bool:
    """Equal values mod p, and `got` in the lazy domain [0, 2p)."""
    from halo2_tpu_torch.ops.field import _to32, from_mont

    got, want = got.reshape(-1, 16), want.reshape(-1, 16)
    d = _to32(got)
    two = ctx.k("twop", got.device)
    differ = d != two
    top = torch.where(differ, torch.arange(8, device=d.device), -1).amax(-1)
    below = (d < two).gather(-1, top.clamp(min=0)[:, None])[:, 0] & (top >= 0)
    return bool(below.all()) and torch.equal(from_mont(got, ctx), from_mont(want, ctx))


@contextmanager
def counts_kept(*modules):
    """The launch counts of `modules` as they were before the block: the
    launches a comparison makes are taken back out."""
    saved = [dict(m.LAUNCHES) for m in modules]
    try:
        yield
    finally:
        for m, counts in zip(modules, saved):
            m.LAUNCHES.clear()
            m.LAUNCHES.update(counts)


def kernel_row(fn, plain, nbytes: int, products: int, p: int, shape: str, reps: int = 10,
               extra_s: float = 0.0):
    """ms and device ms of fn(), the plain version's ms, and the bound of
    `nbytes` and `products` Montgomery products mod p (and `extra_s`
    seconds more of the multiply pipe)."""
    b_ms, b_by = bound(nbytes, products * product_s(p) + extra_s)
    dev_ms = device_ms(fn, reps)
    return dict(ms=time_ms(fn), device_ms=dev_ms, plain_ms=time_ms(plain, 2), bound_ms=b_ms,
                bound_by=b_by, x_bound=dev_ms / b_ms, products=products, bytes=nbytes, shape=shape)


# 32-bit multiplies (mul.wide, mad.lo, mad.hi) of one batch of the inverse
# in csrc/batch_invert.cuh fe_inverse_gcd: update_fg's 4 products a limb over 9
# limbs, update_de's 6, and the two products by p^-1 mod 2^30 (its divsteps
# multiply nothing)
INV_BATCH_MIX = (90, 2, 0)


def inverse_s(p: int, batches: int) -> float:
    """Seconds of the card's multiply pipe of kernel C's inverse of a total
    that takes `batches` batches (scan.inverse_model), with its product by
    R^3."""
    wide, lo, hi = INV_BATCH_MIX
    per_batch = wide / MUL_RATES["wide"] + lo / MUL_RATES["lo"] + hi / MUL_RATES["hi"]
    return batches * per_batch + product_s(p)


def inverse_batches(den, ctx) -> int:
    """The batches kernel C's (and G's) inverse takes for the total of the
    nonzero rows of den (Montgomery limbs)."""
    from halo2_tpu_torch.ops import scan

    p, total = ctx.p_int, 1
    for v in ctx.decode_ints(den):
        total = total * v % p if v else total
    return scan.inverse_model(total * ctx.r_int % p, p)[1]


def replay_equal(fn, want, ctx) -> bool:
    """Every output of `replayed(fn)` equals `want` as values, in [0, 2p)."""
    return all(values_equal(out, want, ctx) for out in replayed(fn))


def tile_sizes():
    """A tile's rows - 1, + 0 and + 1, and more than 32 tiles (so that a
    look-back reads more than one window)."""
    from halo2_tpu_torch.ops.scan import TILE_ROWS

    return (TILE_ROWS - 1, TILE_ROWS, TILE_ROWS + 1, 33 * TILE_ROWS + 5)


def inverse_path(dev, rng, count: int = 256):
    """Kernel C's inverse against the host's pow on each modulus: `count`
    values a modulus, scan.inverse_edges first, the rest uniform in [1, 2p)
    (Montgomery limbs), each through a one-row batch_invert under no_sync;
    the values' canonical inverses must equal pow(a, -1, p)."""
    from halo2_tpu_torch import fields
    from halo2_tpu_torch.ops import scan
    from halo2_tpu_torch.ops.field import FieldCtx, ints_to_limbs, limbs_to_ints

    checked = {}
    for name in MODULI:
        F = getattr(fields, name)
        p, ctx = F.MODULUS, FieldCtx(F)
        vals = [v for v in scan.inverse_edges(p) if v % p]
        while len(vals) < count:
            v = int.from_bytes(rng.bytes(40), "little") % (2 * p)
            if v % p:
                vals.append(v)
        x = torch.as_tensor(ints_to_limbs(vals), device=dev)
        with no_sync(dev):
            got = torch.cat([scan.batch_invert(x[i:i + 1], ctx) for i in range(len(vals))])
        r_inv = pow(1 << 256, -1, p)
        want = [pow(v * r_inv % p, -1, p) for v in vals]
        require(ctx.decode_ints(got) == want, f"kernel C's inverse on {name}: not pow(a, -1, p)")
        require(max(limbs_to_ints(got)) < 2 * p, f"kernel C's inverse on {name}: an output not below 2p")
        checked[name] = len(vals)
    return checked


def scan_path(dev, seed: int, sizes=(1 << 11, (1 << 14) + 3, 1 << 17), timed=(1 << 14, 1 << 17)):
    """Kernel C against its plain version, as values mod p with the output
    in [0, 2p): the inclusive and exclusive prefix products (the latter with
    and without init) and batch_invert on each modulus at each of `sizes`
    and tile_sizes(), the values 0, p (both zeros of batch_invert, which
    must come out as 0), 1, p - 1 and 2p - 1 in the first rows, each call of
    the kernel under no_sync, at 2^14 + 3 and 33 tiles also after replays of
    a CUDA graph; the inverse on 256 values a modulus (inverse_path); then
    each timed on Fp at each of `timed`."""
    from halo2_tpu_torch import fields
    from halo2_tpu_torch.ops import field_ew, scan
    from halo2_tpu_torch.ops.field import FieldCtx

    rng = np.random.default_rng(seed)
    checks, replays = [], []
    replay_sizes = ((1 << 14) + 3, 33 * scan.TILE_ROWS + 5)
    with counts_kept(scan, field_ew):
        inverses = inverse_path(dev, rng)
        for name in MODULI:
            F = getattr(fields, name)
            p, ctx = F.MODULUS, FieldCtx(F)
            for n in (*sizes, *tile_sizes()):
                x = lazy_rows(rng, p, n, [0, p, 1, p - 1, 2 * p - 1]).to(dev)
                init = lazy_rows(rng, p, 1).to(dev)[0]
                cases = {
                    "prefix_product": (scan.prefix_product, scan.prefix_product_plain, ()),
                    "exclusive": (scan.exclusive_prefix_product, scan.exclusive_prefix_product_plain, ()),
                    "exclusive_init": (scan.exclusive_prefix_product,
                                       scan.exclusive_prefix_product_plain, (init,)),
                    "batch_invert": (scan.batch_invert, scan.batch_invert_plain, ()),
                }
                for case, (kern, plain, extra) in cases.items():
                    with no_sync(dev):
                        got = kern(x, ctx, *extra)
                    want = plain(x, ctx, *extra)
                    require(values_equal(got, want, ctx), f"scan {case} {name} n={n}: kernel != plain")
                    checks.append(f"{name}:{n}:{case}")
                    if case == "batch_invert":
                        require(not bool(got[:2].any()), f"scan batch_invert {name}: 0 and p not inverted to 0")
                    if n in replay_sizes:
                        require(replay_equal(lambda: kern(x, ctx, *extra), want, ctx),
                                f"scan {case} {name} n={n}: a CUDA graph's replay != plain")
                        replays.append(f"{name}:{n}:{case}")
        ctx, p = FieldCtx(fields.Fp), fields.Fp.MODULUS
        timing = {}
        for n in timed:
            x = lazy_rows(rng, p, n).to(dev)
            init = x[7]
            shape = f"n=2^{n.bit_length() - 1} (Fp)"
            suffix = "" if n == timed[0] else f"_2^{n.bit_length() - 1}"
            # the total's inverse takes as many batches as its value needs
            batches = inverse_batches(x, ctx)
            timing.update({
                f"prefix_product{suffix}": kernel_row(lambda: scan.prefix_product(x, ctx),
                                                      lambda: scan.prefix_product_plain(x, ctx), 128 * n, n - 1,
                                                      p, shape),
                f"exclusive_init{suffix}": kernel_row(lambda: scan.exclusive_prefix_product(x, ctx, init),
                                                      lambda: scan.exclusive_prefix_product_plain(x, ctx, init),
                                                      128 * n + 64, n, p, shape),
                # Montgomery's trick: 3 (n - 1) products, and the inverse's
                # batches (INV_BATCH_MIX each) and its product by R^3
                f"batch_invert{suffix}": kernel_row(lambda: scan.batch_invert(x, ctx),
                                                    lambda: scan.batch_invert_plain(x, ctx), 128 * n,
                                                    3 * (n - 1), p, shape + f", inverse {batches} batches",
                                                    extra_s=inverse_s(p, batches)),
            })
    return dict(checks=len(checks), replays=len(replays), inverse_values=inverses,
                sizes=[*sizes, *tile_sizes()], moduli=list(MODULI), exact_values=True, no_sync=True,
                timing=timing)


def batch_eval_path(dev, seed: int, eval_m: int, sizes=(1 << 11, (1 << 14) + 3, 1 << 17),
                    timed=(1 << 14, 1 << 17)):
    """Kernel D against its plain versions, as values mod p with outputs in
    [0, 2p), on each modulus at each of `sizes`, each call of the kernel
    under no_sync: batch_eval_mont of M = 3 polynomials at two points (one
    repeated, one of them 0), of one polynomial at one point and of
    `eval_m` polynomials at four points, coefficients below 2p with 0, p,
    p - 1 and 2p - 1 first, at 2^14 + 3 also after replays of a CUDA graph
    and on two streams at once; at the first size also calls of several
    launches (40 points, and 300 polynomials at one point); device_powers
    of one point and of a (2,) batch on the card, and point_powers of a
    host point. Then each timed on Fp at each of `timed`: the evaluation at
    M = eval_m, Q = 4 and at M = 1, Q = 1, the powers of a point on the card
    and of a host point (whole calls: a call copies nothing to the card)."""
    from halo2_tpu_torch import fields
    from halo2_tpu_torch.ops import field_ew, polyeval
    from halo2_tpu_torch.ops.field import FieldCtx

    rng = np.random.default_rng(seed)
    checks, replays = [], []
    with counts_kept(polyeval, field_ew):
        for name in MODULI:
            F = getattr(fields, name)
            p, ctx = F.MODULUS, FieldCtx(F)
            pts = [int(v) % p for v in rng.integers(1, 1 << 62, size=4)]
            for n in sizes:
                shapes = [(3, [pts[0], 0, pts[0]]), (1, [pts[2]]), (eval_m, [pts[i % 4] for i in range(eval_m)])]
                if n == sizes[0]:  # more points, or more polynomials, than one launch takes
                    shapes += [(40, [int(v) % p for v in rng.integers(0, 1 << 62, size=40)]), (300, [pts[1]] * 300)]
                for M, points in shapes:
                    c = lazy_rows(rng, p, M * n, [0, p, p - 1, 2 * p - 1]).reshape(M, n, 16).to(dev)
                    launches = len(polyeval.eval_launches(points, p, polyeval.table_bits(n)))
                    before = polyeval.LAUNCHES["batch_eval"]
                    with no_sync(dev):
                        got = polyeval.batch_eval_mont(F, c, points)
                    require(polyeval.LAUNCHES["batch_eval"] - before == launches,
                            f"batch_eval_mont {name} M={M} n={n}: not {launches} launches")
                    want = polyeval.batch_eval_mont_plain(F, c, points)
                    require(values_equal(got, want, ctx), f"batch_eval_mont {name} M={M} n={n}: kernel != plain")
                    checks.append(f"{name}:{n}:batch_eval:{M}:{launches}")
                    if n == sizes[1]:
                        require(replay_equal(lambda: polyeval.batch_eval_mont(F, c, points), want, ctx),
                                f"batch_eval_mont {name} M={M} n={n}: a CUDA graph's replay != plain")
                        replays.append(f"{name}:{n}:batch_eval:{M}")
                        require(all(values_equal(out, want, ctx) for out in two_streams(
                            lambda: polyeval.batch_eval_mont(F, c, points))),
                                f"batch_eval_mont {name} M={M} n={n}: two streams at once != plain")
                        checks.append(f"{name}:{n}:batch_eval:{M}:two_streams")
                x = lazy_rows(rng, p, 2, [pts[1]]).to(dev)
                for xs in (x[0], x):
                    with no_sync(dev):
                        got = polyeval.device_powers(xs, n, ctx)
                    require(values_equal(got, polyeval.device_powers_plain(xs, n, ctx), ctx),
                            f"device_powers {name} n={n} lead={tuple(xs.shape[:-1])}: kernel != plain")
                    checks.append(f"{name}:{n}:powers:{tuple(xs.shape[:-1])}")
                for xv in (pts[3], 0, 1, p - 1):
                    with no_sync(dev):
                        got = polyeval.point_powers(ctx, xv, n, dev)
                    want = polyeval.device_powers_plain(ctx.const(xv, dev), n, ctx)
                    require(values_equal(got, want, ctx), f"point_powers {name} n={n} x={xv}: kernel != plain")
                    checks.append(f"{name}:{n}:point_powers:{xv}")
                    if n == sizes[1] and xv == pts[3]:
                        require(replay_equal(lambda: polyeval.point_powers(ctx, xv, n, dev), want, ctx),
                                f"point_powers {name} n={n}: a CUDA graph's replay != plain")
                        replays.append(f"{name}:{n}:point_powers")
        F = fields.Fp
        p, ctx = F.MODULUS, FieldCtx(F)
        timing = {}
        for n in timed:
            shape = f"n=2^{n.bit_length() - 1} (Fp)"
            suffix = "" if n == timed[0] else f"_2^{n.bit_length() - 1}"
            L = polyeval.table_bits(n)
            pts = [int(v) % p for v in rng.integers(1, 1 << 62, size=4)]
            for key, M, points in (("batch_eval", eval_m, [pts[i % 4] for i in range(eval_m)]),
                                   ("batch_eval_m1", 1, pts[:1])):
                c = lazy_rows(rng, p, M * n).reshape(M, n, 16).to(dev)
                Q = len(set(points))
                # coefficients read once, the squares taken by value, the
                # evaluations written; one product a coefficient
                timing[key + suffix] = kernel_row(
                    lambda c=c, points=points: polyeval.batch_eval_mont(F, c, points),
                    lambda c=c, points=points: polyeval.batch_eval_mont_plain(F, c, points),
                    64 * (M * n + M) + 32 * Q * L, M * n, p, f"M={M} Q={Q} {shape}")
            x = lazy_rows(rng, p, 1).to(dev)[0]
            xv = ctx.decode_ints(x[None])[0]
            # the powers written (and the point, or its squares, read); one
            # product a power
            timing["powers" + suffix] = kernel_row(lambda x=x: polyeval.device_powers(x, n, ctx),
                                                   lambda x=x: polyeval.device_powers_plain(x, n, ctx),
                                                   64 * (n + 1), n - 1, p, shape + ", a point on the card")
            timing["point_powers" + suffix] = kernel_row(
                lambda xv=xv: polyeval.point_powers(ctx, xv, n, dev),
                lambda x=x: polyeval.device_powers_plain(x, n, ctx), 64 * n + 32 * L, n - 1, p,
                shape + ", a host point")
    return dict(checks=len(checks), replays=len(replays), sizes=list(sizes), moduli=list(MODULI), eval_m=eval_m,
                exact_values=True, no_sync=True, two_streams=True, timing=timing)


def two_streams(fn, calls: int = 4):
    """The outputs of `calls` calls of fn on each of two new streams, issued
    in turn without waiting, so that the two streams' kernels may run at
    once (kernels D and F keep a completion counter a stream)."""
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(calls):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(fn())
    for st in streams:
        torch.cuda.current_stream().wait_stream(st)
    torch.cuda.synchronize()
    return outs


def kate_path(dev, seed: int, sizes=(1 << 11, (1 << 14) + 3, 1 << 17), timed=(1 << 14, 1 << 17)):
    """Kernel E against its plain version, as values mod p with outputs in
    [0, 2p) and the top coefficient 0, on each modulus at each of `sizes`
    and tile_sizes(), coefficients below 2p with 0, p, p - 1 and 2p - 1
    first, at b = 0, 1, p - 1 and a random b, each call of the kernel under
    no_sync, at 2^14 + 3 and 33 tiles also after replays of a CUDA graph;
    then timed on Fp at each of `timed`."""
    from halo2_tpu_torch import fields
    from halo2_tpu_torch.ops import field_ew, polyeval
    from halo2_tpu_torch.ops.scan import TILE_ROWS

    from halo2_tpu_torch.ops.field import FieldCtx

    rng = np.random.default_rng(seed)
    checks, replays = [], []
    replay_sizes = ((1 << 14) + 3, 33 * TILE_ROWS + 5)
    with counts_kept(polyeval, field_ew):
        for name in MODULI:
            F = getattr(fields, name)
            p, ctx = F.MODULUS, FieldCtx(F)
            for n in (*sizes, *tile_sizes()):
                a = lazy_rows(rng, p, n, [0, p, p - 1, 2 * p - 1]).to(dev)
                for b in (0, 1, p - 1, int(rng.integers(2, 1 << 62))):
                    with no_sync(dev):
                        got = polyeval.kate_division_mont(F, a, b)
                    want = polyeval.kate_division_mont_plain(F, a, b)
                    require(values_equal(got, want, ctx), f"kate_division_mont {name} n={n} b={b}: kernel != plain")
                    require(not bool(got[-1].any()), f"kate_division_mont {name}: the top coefficient is not 0")
                    checks.append(f"{name}:{n}:kate:{b}")
                    if n in replay_sizes and b > 1:
                        require(replay_equal(lambda: polyeval.kate_division_mont(F, a, b), want, ctx),
                                f"kate_division_mont {name} n={n} b={b}: a CUDA graph's replay != plain")
                        replays.append(f"{name}:{n}:kate:{b}")
        F = fields.Fp
        p, ctx = F.MODULUS, FieldCtx(F)
        timing = {}
        for n in timed:
            a, b = lazy_rows(rng, p, n).to(dev), int(rng.integers(2, 1 << 62))
            suffix = "" if n == timed[0] else f"_2^{n.bit_length() - 1}"
            timing[f"kate_div{suffix}"] = kernel_row(lambda: polyeval.kate_division_mont(F, a, b),
                                                     lambda: polyeval.kate_division_mont_plain(F, a, b), 128 * n,
                                                     n - 1, p, f"n=2^{n.bit_length() - 1} (Fp)")
    return dict(checks=len(checks), replays=len(replays), sizes=[*sizes, *tile_sizes()], moduli=list(MODULI),
                exact_values=True, no_sync=True, timing=timing)


def ipa_round_path(dev, seed: int, log_n: int = 14):
    """Kernel F against its plain version, as values mod p with outputs in
    [0, 2p), on each modulus: every round of an opening over 2^log_n lanes,
    m = n down to 2, emit, fold and (m >= 4) the fused round (the fold at m,
    then the emit at m / 2) on the same inputs (the kernel's fold output
    feeds the next round), each call of the kernel under no_sync, the fused
    round at m = n and m = 4 also after replays of a CUDA graph and on two
    streams at once. Then each timed on Fp at m = n."""
    from halo2_tpu_torch import fields
    from halo2_tpu_torch.ops import field_ew, ipa_round
    from halo2_tpu_torch.ops.field import FieldCtx

    rng = np.random.default_rng(seed)
    n = 1 << log_n
    rounds, replays = 0, []
    with counts_kept(ipa_round, field_ew):
        for name in MODULI:
            F = getattr(fields, name)
            p, ctx = F.MODULUS, FieldCtx(F)
            pp, b, s = (lazy_rows(rng, p, n, [0, p, p - 1, 2 * p - 1]).to(dev) for _ in range(3))
            z, rands = (lazy_rows(rng, p, k, [2 * p - 1]).to(dev) for k in (1, 2))
            m = n
            while m >= 2:
                u = int(rng.integers(2, 1 << 62))
                um, uim = ctx.const(u, dev), ctx.const(pow(u, -1, p), dev)
                with no_sync(dev):
                    got = ipa_round.round_emit(pp, b, s, m, z[0], rands, ctx)
                require(values_equal(got, ipa_round.round_emit_plain(pp, b, s, m, z[0], rands, ctx), ctx),
                        f"ipa_round emit {name} m={m}: kernel != plain")
                with no_sync(dev):
                    folded = ipa_round.round_fold(pp, b, s, m, um, uim, ctx)
                want_fold = ipa_round.round_fold_plain(pp, b, s, m, um, uim, ctx)
                for t, want, what in zip(folded, want_fold, ("p'", "b", "s_mult")):
                    require(values_equal(t, want, ctx), f"ipa_round fold {name} m={m} {what}: kernel != plain")
                if m >= 4:
                    with no_sync(dev):
                        fused = ipa_round.round_fold_emit(pp, b, s, m, um, uim, z[0], rands, ctx)
                    want = (*want_fold, ipa_round.round_emit_plain(*want_fold, m // 2, z[0], rands, ctx))
                    for t, w, what in zip(fused, want, ("p'", "b", "s_mult", "scalars")):
                        require(values_equal(t, w, ctx), f"ipa_round fold+emit {name} m={m} {what}: kernel != plain")
                    if m in (n, 4):
                        require(replay_equal(lambda: ipa_round.round_fold_emit(pp, b, s, m, um, uim, z[0], rands,
                                                                               ctx)[3], want[3], ctx),
                                f"ipa_round fold+emit {name} m={m}: a CUDA graph's replay != plain")
                        replays.append(f"{name}:{m}")
                        require(all(values_equal(out, want[3], ctx) for out in two_streams(
                            lambda: ipa_round.round_fold_emit(pp, b, s, m, um, uim, z[0], rands, ctx)[3])),
                                f"ipa_round fold+emit {name} m={m}: two streams at once != plain")
                pp, b, s = folded
                rounds += 1
                m //= 2
        F = fields.Fp
        p, ctx = F.MODULUS, FieldCtx(F)
        pp, b, s = (lazy_rows(rng, p, n).to(dev) for _ in range(3))
        z, rands = lazy_rows(rng, p, 1).to(dev)[0], lazy_rows(rng, p, 2).to(dev)
        um, uim = ctx.const(3, dev), ctx.const(pow(3, -1, p), dev)
        shape = f"n=m=2^{log_n} (Fp)"
        timing = {
            # p', b and s_mult read, the folded three written, and two rows of
            # n + 2 of the emit at m / 2; products: the fold's, n + n / 2, the
            # emit's, a lane and two a lane of its first half (n / 4)
            "round": kernel_row(lambda: ipa_round.round_fold_emit(pp, b, s, n, um, uim, z, rands, ctx),
                                lambda: ipa_round.round_fold_emit_plain(pp, b, s, n, um, uim, z, rands, ctx),
                                64 * (3 * n + 3 * n + 2 * (n + 2) + 5), n + n // 2 + n + n // 2 + 2, p,
                                shape + ", the fold at m, the emit at m / 2"),
            # p', b, s_mult read, two rows of n + 2 written; a product a lane
            # and two a lane of the first half
            "emit": kernel_row(lambda: ipa_round.round_emit(pp, b, s, n, z, rands, ctx),
                               lambda: ipa_round.round_emit_plain(pp, b, s, n, z, rands, ctx),
                               64 * (3 * n + 2 * (n + 2) + 3), 2 * n + 2, p, shape),
            # p', b, s_mult read and written; two products a lane of the first
            # half, one a lane of the second
            "fold": kernel_row(lambda: ipa_round.round_fold(pp, b, s, n, um, uim, ctx),
                               lambda: ipa_round.round_fold_plain(pp, b, s, n, um, uim, ctx),
                               64 * (6 * n + 2), n + n // 2, p, shape),
        }
    return dict(rounds=rounds, replays=len(replays), log_n=log_n, moduli=list(MODULI), exact_values=True,
                no_sync=True, two_streams=True, timing=timing)


def term_to(target: int, added: int, p: int) -> int:
    """v in [0, 2p) with add_mod(v, added) = target, for a target in
    (0, 2p] and an addend in [0, 2p): the row value that makes a grand
    product's term land on 2p (add_mod gives 0) or on p."""
    v = target - added
    return v if v >= 0 else v + 2 * p


def grand_inputs(rng, F, dev, n: int, ncols: int = 0, edge_rows=(), blinding: int = 5):
    """Kernel G's inputs on the card, values below 2p with 0, p, p - 1 and
    2p - 1 among the first rows: a lookup's (ci, ct, pi, pt, beta, gamma,
    rand_rows) for ncols = 0, else a chunk's (cols, sigmas, omega_pw, beta,
    gamma, dpows, rand_rows) with omega^i of a random omega (kernel D's
    point_powers). At the two `edge_rows` the denominator lands on 0 and on
    p (a' + beta, or column 0's term, set to 2p and to p)."""
    from halo2_tpu_torch.ops import field_ew, polyeval
    from halo2_tpu_torch.ops.field import FieldCtx, ints_to_limbs, limbs_to_ints, mont_mul

    p, ctx = F.MODULUS, FieldCtx(F)
    beta, gamma, omega = (int(v) % p for v in rng.integers(1, 1 << 62, size=3))

    def col(i):
        return lazy_rows(rng, p, n, [0, p, p - 1, 2 * p - 1][i % 4:])

    def set_row(t, row, v):
        t[row] = torch.as_tensor(ints_to_limbs([v])[0], device=t.device)

    rand_rows = lazy_rows(rng, p, blinding).to(dev)
    if not ncols:
        ci, ct, pi, pt = (col(i) for i in range(4))
        b = beta * ctx.r_int % p
        for row, target in zip(edge_rows, (2 * p, p)):
            set_row(pi, row, term_to(target, b, p))
        return (*(c.to(dev) for c in (ci, ct, pi, pt)), beta, gamma, rand_rows)
    cols, sigmas = [col(j) for j in range(ncols)], [col(j + 1).to(dev) for j in range(ncols)]
    if edge_rows:
        with counts_kept(field_ew):  # beta sigma_0 as kernel A (and kernel G) forms it
            bs = limbs_to_ints(mont_mul(sigmas[0][list(edge_rows)], ctx.const(beta, dev), ctx))
        for row, target, added in zip(edge_rows, (2 * p, p), bs):
            set_row(cols[0], row, term_to(term_to(target, gamma * ctx.r_int % p, p), added, p))
    with counts_kept(polyeval):
        omega_pw = polyeval.point_powers(ctx, omega, n, dev)
    dpows = [beta * pow(F.DELTA, 7 + j, p) % p for j in range(ncols)]
    return [c.to(dev) for c in cols], sigmas, omega_pw, beta, gamma, dpows, rand_rows


def grand_product_path(dev, seed: int, sizes=(1 << 11, (1 << 14) + 3, 1 << 17), timed=(1 << 14, 1 << 17),
                       blinding: int = 5):
    """Kernel G against its plain versions, as values mod p with outputs in
    [0, 2p), on each modulus at each of `sizes`, each call of the kernel
    under no_sync: a lookup's z column with a zero and a p denominator in
    rows 1 and 2, and six permutation chunks of 1-6 columns chained by
    last_z (each chunk's init the kernel's last_z of the one before), the
    last with a zero and a p denominator in rows 1 and 2; at 2^14 + 3 the
    lookup and a chunk of 2 columns also after replays of a CUDA graph and
    on two streams at once. Then each timed on Fp at each of `timed`: the
    lookup, a chunk of 2 columns (BenchCircuit's) and, at the first, of 6
    (Sinsemilla's)."""
    from halo2_tpu_torch import fields
    from halo2_tpu_torch.ops import field_ew, grand_product as gp, polyeval, scan
    from halo2_tpu_torch.ops.field import FieldCtx, add_mod, mont_mul

    rng = np.random.default_rng(seed)
    checks, replays = [], []
    with counts_kept(gp, scan, field_ew, polyeval):
        for name in MODULI:
            F = getattr(fields, name)
            p, ctx = F.MODULUS, FieldCtx(F)
            for n in sizes:
                lk = grand_inputs(rng, F, dev, n, edge_rows=(1, 2), blinding=blinding)
                before = gp.LAUNCHES["grand_product"]
                with no_sync(dev):
                    got = gp.lookup_z(F, blinding, *lk)
                require(gp.LAUNCHES["grand_product"] - before == gp.KERNELS_PER_CALL,
                        f"lookup_z {name} n={n}: not {gp.KERNELS_PER_CALL} device kernels")
                want = gp.lookup_z_plain(F, blinding, *lk)
                require(values_equal(got, want, ctx), f"lookup_z {name} n={n}: kernel != plain")
                require(ctx.decode_ints(got[2:4]) == [0, 0], f"lookup_z {name} n={n}: z after a zero is not 0")
                checks.append(f"{name}:{n}:lookup")
                if n == sizes[1]:
                    require(replay_equal(lambda: gp.lookup_z(F, blinding, *lk), want, ctx),
                            f"lookup_z {name} n={n}: a CUDA graph's replay != plain")
                    require(all(values_equal(out, want, ctx) for out in two_streams(
                        lambda: gp.lookup_z(F, blinding, *lk))), f"lookup_z {name} n={n}: two streams != plain")
                    replays.append(f"{name}:{n}:lookup")
                init = plain_init = None
                for ncols in range(1, 7):
                    case = grand_inputs(rng, F, dev, n, ncols, (1, 2) if ncols == 6 else (), blinding)
                    with no_sync(dev):
                        z, last_z = gp.perm_z(F, blinding, *case[:6], init, case[6])
                    wz, wlast = gp.perm_z_plain(F, blinding, *case[:6], plain_init, case[6])
                    require(values_equal(z, wz, ctx) and values_equal(last_z, wlast, ctx),
                            f"perm_z {name} n={n} ncols={ncols}: kernel != plain")
                    checks.append(f"{name}:{n}:perm:{ncols}")
                    if n == sizes[1] and ncols == 2:
                        require(replay_equal(lambda: gp.perm_z(F, blinding, *case[:6], init, case[6])[0], wz, ctx),
                                f"perm_z {name} n={n}: a CUDA graph's replay != plain")
                        require(all(values_equal(out, wz, ctx) for out in two_streams(
                            lambda: gp.perm_z(F, blinding, *case[:6], init, case[6])[0])),
                                f"perm_z {name} n={n}: two streams != plain")
                        replays.append(f"{name}:{n}:perm:2")
                    init, plain_init = last_z, wlast
                require(ctx.decode_ints(z[2:4]) == [0, 0], f"perm_z {name} n={n}: z after a zero is not 0")
        F = fields.Fp
        p, ctx = F.MODULUS, FieldCtx(F)
        timing = {}
        for n in timed:
            shape = f"n=2^{n.bit_length() - 1} (Fp)"
            suffix = "" if n == timed[0] else f"_2^{n.bit_length() - 1}"
            lk = grand_inputs(rng, F, dev, n, blinding=blinding)
            beta_c, gamma_c = ctx.const(lk[4], dev), ctx.const(lk[5], dev)
            batches = inverse_batches(mont_mul(add_mod(lk[2], beta_c, ctx), add_mod(lk[3], gamma_c, ctx), ctx), ctx)
            # four columns read and z written; a row's denominator, numerator,
            # its share of Montgomery's trick (3), its fraction and its prefix
            timing["lookup_z" + suffix] = kernel_row(
                lambda lk=lk: gp.lookup_z(F, blinding, *lk), lambda lk=lk: gp.lookup_z_plain(F, blinding, *lk),
                64 * (5 * n + blinding), 7 * n, p, shape + f", inverse {batches} batches",
                extra_s=inverse_s(p, batches))
            for c in (2, 6) if n == timed[0] else (2,):
                case = grand_inputs(rng, F, dev, n, c, blinding=blinding)
                init = lazy_rows(rng, p, 1).to(dev)[0]
                den = None
                for j in range(c):
                    t = add_mod(add_mod(case[0][j], mont_mul(case[1][j], ctx.const(case[3], dev), ctx), ctx),
                                ctx.const(case[4], dev), ctx)
                    den = t if den is None else mont_mul(den, t, ctx)
                batches = inverse_batches(den, ctx)
                # c columns, c sigma columns and omega^i read, z written; a
                # row's 2c - 1 products of each product, 3 of Montgomery's
                # trick, its fraction and its prefix
                timing[f"perm_z_{c}" + suffix] = kernel_row(
                    lambda case=case, init=init: gp.perm_z(F, blinding, *case[:6], init, case[6])[0],
                    lambda case=case, init=init: gp.perm_z_plain(F, blinding, *case[:6], init, case[6])[0],
                    64 * ((2 * c + 2) * n + blinding + 2), (4 * c + 3) * n, p,
                    shape + f", {c} columns, inverse {batches} batches", extra_s=inverse_s(p, batches))
    return dict(checks=len(checks), replays=len(replays), sizes=list(sizes), moduli=list(MODULI),
                blinding=blinding, exact_values=True, no_sync=True, two_streams=True, timing=timing)


def horner_path(dev, seed: int, sizes=(1 << 11, (1 << 14) + 3, 1 << 17), timed=(1 << 14, 1 << 17)):
    """Kernel H against its plain version bit for bit, on each modulus at
    each of `sizes`, M = 2, 3 and 7 pieces below 2p with 0, p, p - 1 and
    2p - 1 first, x random, 0, 1 and p - 1, each call of the kernel under
    no_sync; at 2^14 + 3 also after replays of a CUDA graph and on two
    streams at once. Then timed on Fp at each of `timed` at M = 3
    (BenchCircuit's quotient) and 7 (Sinsemilla's)."""
    from halo2_tpu_torch import fields
    from halo2_tpu_torch.ops import field_ew, polyeval
    from halo2_tpu_torch.ops.field import FieldCtx

    rng = np.random.default_rng(seed)
    checks, replays = [], []
    with counts_kept(polyeval, field_ew):
        for name in MODULI:
            F = getattr(fields, name)
            p, ctx = F.MODULUS, FieldCtx(F)
            for n in sizes:
                for M in (2, 3, 7):
                    pieces = list(lazy_rows(rng, p, M * n, [0, p, p - 1, 2 * p - 1]).reshape(M, n, 16).to(dev))
                    for x in (int(rng.integers(2, 1 << 62)), 0, 1, p - 1):
                        before = polyeval.LAUNCHES["horner"]
                        with no_sync(dev):
                            got = polyeval.horner_fold_mont(F, pieces, x)
                        require(polyeval.LAUNCHES["horner"] - before == 1, f"horner {name} n={n} M={M}: not one launch")
                        want = polyeval.horner_fold_mont_plain(F, pieces, x)
                        require(torch.equal(got, want), f"horner {name} n={n} M={M} x={x}: kernel != plain")
                        checks.append(f"{name}:{n}:{M}:{x}")
                    if n == sizes[1]:
                        require(all(torch.equal(out, want) for out in replayed(
                            lambda: polyeval.horner_fold_mont(F, pieces, x))),
                                f"horner {name} n={n} M={M}: a CUDA graph's replay != plain")
                        require(all(torch.equal(out, want) for out in two_streams(
                            lambda: polyeval.horner_fold_mont(F, pieces, x))),
                                f"horner {name} n={n} M={M}: two streams != plain")
                        replays.append(f"{name}:{n}:{M}")
        F = fields.Fp
        p, ctx = F.MODULUS, FieldCtx(F)
        timing = {}
        for n in timed:
            for M in (3, 7):
                shape = f"n=2^{n.bit_length() - 1} (Fp), M={M}"
                key = ("horner" if M == 3 else f"horner_m{M}") + ("" if n == timed[0] else f"_2^{n.bit_length() - 1}")
                pieces = list(lazy_rows(rng, p, M * n).reshape(M, n, 16).to(dev))
                x = int(rng.integers(2, 1 << 62))
                # the pieces read and the fold written; M - 1 products a row
                timing[key] = kernel_row(lambda pieces=pieces, x=x: polyeval.horner_fold_mont(F, pieces, x),
                                         lambda pieces=pieces, x=x: polyeval.horner_fold_mont_plain(F, pieces, x),
                                         64 * (M + 1) * n, (M - 1) * n, p, shape)
    return dict(checks=len(checks), replays=len(replays), sizes=list(sizes), moduli=list(MODULI),
                bit_for_bit=True, no_sync=True, two_streams=True, timing=timing)


@contextmanager
def kernel_a_sites(sites):
    """Inside the block, each launch of kernel A adds one to sites[its
    caller]: the nearest frame that is not kernel A's wrapper
    (ops/field_ew.py) or one of ops/field.py's elementwise ops, named
    "path in the package:qualified name"."""
    from halo2_tpu_torch.ops import field_ew

    launch = field_ew.launch
    wrappers = {"mont_mul", "add_mod", "sub_mod", "neg_mod", "double_mod", "mont_sqr"}

    def site():
        f = sys._getframe(2)
        while f is not None:
            path, code = f.f_code.co_filename.replace(os.sep, "/"), f.f_code
            if not (path.endswith("/ops/field_ew.py")
                    or (path.endswith("/ops/field.py") and code.co_name in wrappers)):
                break
            f = f.f_back
        if f is None:
            return "?"
        path = f.f_code.co_filename.replace(os.sep, "/")
        path = path.split("/halo2_tpu_torch/", 1)[-1] if "/halo2_tpu_torch/" in path else os.path.basename(path)
        return f"{path}:{getattr(f.f_code, 'co_qualname', f.f_code.co_name)}"

    def counted(op, a, b, ctx):
        before = field_ew.LAUNCHES[op]
        out = launch(op, a, b, ctx)
        if field_ew.LAUNCHES[op] != before:
            key = site()
            sites[key] = sites.get(key, 0) + 1
        return out

    field_ew.launch = counted
    try:
        yield sites
    finally:
        field_ew.launch = launch


def planted_failure(prover, tag: str, plant, constraints: int, kind: str = "constraint"):
    """`plant(prover, advice)` changes cells of `advice`, a copy of the
    prover's witness, and returns the row it planted at. The copy's
    vectorised check must report `constraints` failures of `kind`, all at
    that row (in its region, at its offset), and render every failure as
    the row loop does, character for character."""
    import copy

    from halo2_tpu_torch.dev.mock_prover import FailureLocation

    bad = copy.copy(prover)
    bad.advice = [list(col) for col in prover.advice]
    row = plant(prover, bad.advice)
    t0 = time.perf_counter()
    vec = [(f.kind, str(f)) for f in bad.verify(vectorized=True)]
    sync(prover.device)
    t1 = time.perf_counter()
    rows = [(f.kind, str(f)) for f in bad.verify(vectorized=False)]
    t2 = time.perf_counter()
    where = f"[{FailureLocation.find(prover.regions, row)}]"
    gate = [text for k, text in vec if k == kind]
    require(len(gate) == constraints and all(where in text for text in gate),
            f"{tag}: the planted failure at row {row} was not reported {where} {constraints} times: {gate}")
    require(vec == rows, f"{tag}: the vectorised check renders {vec} where the row loop renders {rows}")
    return dict(planted_row=row, planted_failures=[k for k, _ in vec], **{f"{kind}_failure": gate[0]},
                same_text_as_row_loop=True, planted_vectorized_s=t1 - t0, planted_row_loop_s=t2 - t1)


def bump(col: int, row: int):
    """A plant that adds one to the advice cell (col, row)."""
    def plant(prover, advice):
        kind, v = advice[col][row]
        advice[col][row] = (kind, (v + 1) % prover.p)
        return row
    return plant


def swap_first_cond_swap(prover, advice):
    """A plant that swaps the two outputs of the Merkle path's first
    cond-swap: the node and its sibling trade places."""
    from halo2_tpu_torch.circuits import MerkleCircuit
    from halo2_tpu_torch.plonk import ConstraintSystem

    cfg = MerkleCircuit.configure(ConstraintSystem()).cond_swap
    a, b = cfg.a_swapped.index, cfg.b_swapped.index
    row = next(r.rows[0] for r in prover.regions if r.name == "swap")
    advice[a][row], advice[b][row] = advice[b][row], advice[a][row]
    return row


def mock_run(dev, tag: str, k: int, circ, plant, constraints: int, kind: str = "constraint"):
    """MockProver on `circ` at 2^k rows, its vectorised check on `dev`: no
    failure; then `plant` on a copy of the witness (planted_failure)."""
    from halo2_tpu_torch.dev.mock_prover import MockProver

    t0 = time.perf_counter()
    prover = MockProver.run(k, circ, [], device=dev)
    t1 = time.perf_counter()
    failures = prover.verify(vectorized=True)
    sync(dev)
    t2 = time.perf_counter()
    require(failures == [], f"{tag}: failed: {[str(f) for f in failures[:3]]}")
    return dict(k=k, failures=0, **planted_failure(prover, tag, plant, constraints, kind),
                stages=dict(run_s=t1 - t0, verify_s=t2 - t1))


def mock_path(dev, k: int, row: int):
    """MockProver on BenchCircuit at 2^k rows, its vectorised check on `dev`,
    with the c cell of `row` changed in the planted copy."""
    from halo2_tpu_torch.circuits import bench_circuit_for_k

    circ = bench_circuit_for_k(k)
    c_col = 2  # BenchCircuit's advice columns a, b, c
    return dict(rows=circ.rows, **mock_run(dev, f"mock{k}", k, circ, bump(c_col, row), 1))


def bump_first_wide_dense(prover, advice):
    """The JAX package's SHA-256 plant (tests/test_sha256_gadget.py:101-105):
    the first assigned cell of advice column 0 (the dense column) that is not
    0 or 1, plus one."""
    for row, v in enumerate(advice[0]):
        if isinstance(v, tuple) and v[0] == "assigned" and v[1] not in (0, 1):
            advice[0][row] = ("assigned", (v[1] + 1) % prover.p)
            return row
    raise AssertionError("sha256_mock: no dense cell to plant at")


def sha256_mock_path(dev):
    """MockProver on one SHA-256 block (b"abc") at k = 17, the vectorised
    check on `dev`: no failure; the planted dense cell fails its spread
    lookup at its row (and the copies that read it)."""
    from halo2_tpu_torch.circuits import ShaCircuit

    return mock_run(dev, "sha256_mock", 17, ShaCircuit(b"abc"), bump_first_wide_dense, 1, "lookup")


def ecc_mock_path(dev):
    """MockProver on the ECC and Merkle gadgets, the vectorised check on
    `dev`: a full-width variable-base multiplication at k = 12 (a wrong cell
    of its double-and-add rows planted), a full-width fixed-base
    multiplication at k = 12 (a wrong cell of its incomplete additions) and
    a Merkle path of depth 2 at k = 11 (the first layer's node and sibling
    swapped after the cond-swap), each failing that many constraints of its
    gate (2, 1 and the cond-swap's 2)."""
    import random

    from halo2_tpu_torch import circuits
    from halo2_tpu_torch.fields import Fq

    base, s = circuits.full_mul_inputs()
    scalar = random.Random(7).randrange(1, Fq.MODULUS)
    leaf, pos, path, root = circuits.merkle_inputs()
    return {
        "full_mul12": mock_run(dev, "full_mul12", 12, circuits.FullMulCircuit(base, base, s), bump(6, 700), 2),
        "fixed_mul12": mock_run(dev, "fixed_mul12", 12, circuits.FixedMulCircuit(scalar), bump(4, 42), 1),
        "merkle11": mock_run(dev, "merkle11", 11, circuits.MerkleCircuit(leaf, pos, path, root),
                             swap_first_cond_swap, 2),
    }


def mesh_proof_path(dev, read_launches, read_routes, params, vk, pk, circ, pinned):
    """BenchCircuit's proof on the k = 14 keys under a mesh of four shards
    (four cards where there are four, else four logical shards of `dev`):
    the pinned single-device bytes, verified; every mesh route (the four-step
    NTT, the sharded MSM, the row-sharded quotient fold) taken at least once."""
    from halo2_tpu_torch.curves import Vesta
    from halo2_tpu_torch.parallel import make_mesh, use_mesh
    from halo2_tpu_torch.parallel.context import CALLS
    from halo2_tpu_torch.plonk.prover import create_proof
    from halo2_tpu_torch.plonk.verifier import verify_proof
    from halo2_tpu_torch.transcript import Blake2bRead, Blake2bWrite
    from halo2_tpu_torch.utils.chacha import ChaCha20Rng
    from halo2_tpu_torch.utils.measure import get_records, reset_records

    count = torch.cuda.device_count() if torch.device(dev).type == "cuda" else 0
    devices = [torch.device("cuda", i) for i in range(4)] if count >= 4 else [torch.device(dev)] * 4
    CALLS.clear()
    reset_records()
    t0 = time.perf_counter()
    with use_mesh(make_mesh(devices=devices)):
        tr = Blake2bWrite(Vesta)
        create_proof(params, pk, [circ], [[]], ChaCha20Rng(b"\x2a" * 32), tr)
        proof = tr.finalize()
    sync(dev)
    prove_s = time.perf_counter() - t0
    spans = get_records()
    calls = dict(CALLS)
    ok = verify_proof(params, vk, [[]], Blake2bRead(Vesta, proof))
    require(ok is True, "mesh14: verify")
    sha = hashlib.sha256(proof).hexdigest()
    require(sha == pinned, f"mesh14 proof sha256 {sha} != {pinned}")
    for route in ("four_step_ntt", "sharded_msm", "evaluate_h_mesh"):
        require(calls.get(route, 0) > 0, f"mesh14: no call took {route}")
    return dict(device_count=count, mesh=[str(d) for d in devices], pinned_sha256=True, verified=True,
                mesh_calls=calls, prove_s=prove_s, prove_spans=spans, launches=read_launches(),
                routes=read_routes())


def mesh_ops_path(dev, g_points, seed: int, log_n: int = 20):
    """The mesh's operations at gating config 5's sizes on four logical
    shards of `dev`: FourStepNtt at 2^log_n (2^20) against the one-device
    kernel-1 plan, and sharded_msm of 2^log_n points (`g_points` tiled)
    against the one-device msm(), each timed by CUDA events."""
    import random

    from halo2_tpu_torch.curves import Vesta
    from halo2_tpu_torch.fields import Fp
    from halo2_tpu_torch.ops.field import FieldCtx, from_mont, mont_mul, mont_mul_plain
    from halo2_tpu_torch.ops.msm import MSMBases, msm
    from halo2_tpu_torch.ops.ntt_cg import CgNttPlan
    from halo2_tpu_torch.parallel import FourStepNtt, make_mesh, sharded_msm

    mesh = make_mesh(devices=[torch.device(dev)] * 4)
    fctx = FieldCtx(Fp)
    n = 1 << log_n
    q = Fp.MODULUS
    omega = pow(Fp.ROOT_OF_UNITY, 1 << (Fp.S - log_n), q)
    limbs = np.random.default_rng(seed).integers(0, 1 << 16, size=(n, 16), dtype=np.int64)
    limbs[:, 15] &= 0x3FFF  # below p
    x = fctx.to_mont(torch.as_tensor(limbs.astype(np.int32), device=dev))
    t0 = time.perf_counter()
    single, four = CgNttPlan(Fp, log_n, omega), FourStepNtt(Fp, log_n, omega, mesh)
    plan_s = time.perf_counter() - t0
    ys, yf = single(x), four(x)
    require(torch.equal(from_mont(ys, fctx), from_mont(yf, fctx)),
            "mesh_ops: FourStepNtt at 2^20 != the one-device plan")
    ntt = dict(log_n=log_n, shards=4, split=(four.n1, four.n2), exact=True,
               same_limbs=bool(torch.equal(ys, yf)), plan_setup_s=plan_s,
               single_ms=time_ms(lambda: single(x)), four_step_ms=time_ms(lambda: four(x)),
               # the four-step twiddle pass alone: one product over 2^log_n, kernel A
               # and its plain version
               twiddle_mont_mul_ms=time_ms(lambda: mont_mul(x, x, fctx)),
               plain_mont_mul_ms=time_ms(lambda: mont_mul_plain(x, x, fctx)))
    rng = random.Random(seed)
    pts = list(g_points) * (n // len(g_points))
    scalars = [rng.randrange(Vesta.SCALAR.MODULUS) for _ in range(n)]
    t0 = time.perf_counter()
    bases = MSMBases(Vesta, pts, dev)
    bases_s = time.perf_counter() - t0
    want, single_first = once_ms(lambda: msm(scalars, bases, site="mesh_ops"))
    got, sharded_first = once_ms(lambda: sharded_msm(scalars, bases, mesh))
    require(got == want, "mesh_ops: sharded_msm of 2^20 points != the one-device msm()")
    _, single_ms = once_ms(lambda: msm(scalars, bases, site="mesh_ops"))
    _, sharded_ms = once_ms(lambda: sharded_msm(scalars, bases, mesh))
    return dict(ntt=ntt, msm=dict(n=n, shards=4, exact=True, bases_s=bases_s,
                                  single_first_ms=single_first, sharded_first_ms=sharded_first,
                                  single_ms=single_ms, sharded_ms=sharded_ms))


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from halo2_tpu_torch.circuits import (MulCircuit, bench_circuit_for_k, poseidon_k11, sha256_k17,
                                          sha256_k17_message, sinsemilla_k11, sinsemilla_k14)
    from halo2_tpu_torch.curves import Bn254G1, Pallas, Vesta
    from halo2_tpu_torch.fields import Fp, FrBn
    from halo2_tpu_torch.ops import (_build, field_ew, grand_product, ipa_round, msm_bucket, msm_sorted, mxu_mont,
                                     ntt_cg, ntt_mr, polyeval, scan, tile_bench)
    from halo2_tpu_torch.ops import fold as fold_ops
    from halo2_tpu_torch.ops import msm as msm_mod
    from halo2_tpu_torch.ops.curve import CurveCtx, PointVec
    from halo2_tpu_torch.ops.field import FieldCtx, from_mont, ints_to_limbs, limbs_to_ints
    from halo2_tpu_torch.ops.msm import MSMBases, msm_host
    from halo2_tpu_torch.ops.ntt import NttPlan
    from halo2_tpu_torch.plonk.batch import BatchVerifier
    from halo2_tpu_torch.plonk.error import OpeningError
    from halo2_tpu_torch.plonk.keygen import keygen_pk, keygen_vk
    from halo2_tpu_torch.plonk.prover import create_proof
    from halo2_tpu_torch.plonk.verifier import verify_proof
    from halo2_tpu_torch.poly.commitment import Blind
    from halo2_tpu_torch.poly.ipa import ParamsIPA
    from halo2_tpu_torch.poly.kzg import ParamsKZG
    from halo2_tpu_torch.tools import profile_kernels
    from halo2_tpu_torch.transcript import (Blake2bRead, Blake2bWrite, Keccak256Read, Keccak256Write,
                                            TranscriptError)
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

    bn_rng = np.random.default_rng(20261018)  # BN254's inputs, apart from `rng`

    def rand_below(shape, mod):
        """Values uniform below `mod` (to 2^-66) as canonical 16-bit limbs,
        from bn_rng: the sorted MSM's lane capacities assume scalars uniform
        below the group order, whose top limb sets the top window's range."""
        vals = [int.from_bytes(bn_rng.bytes(40), "little") % mod for _ in range(int(np.prod(shape)))]
        return torch.as_tensor(ints_to_limbs(vals).reshape(*shape, 16), device=dev)

    errs = {}

    def same(name, a, b, ctx, what):
        """Record the largest limb difference of the canonical values; fail unless 0."""
        d = (from_mont(a.reshape(-1, 16), ctx) - from_mont(b.reshape(-1, 16), ctx)).abs().max()
        errs[name] = max(errs.get(name, 0), int(d))
        require(int(d) == 0, what)

    def canon_equal(a, b, ctx=sctx):
        return torch.equal(from_mont(a.reshape(-1, 16), ctx), from_mont(b.reshape(-1, 16), ctx))

    def level_bound(cols, f, tab, g, ctx=sctx):
        """Bound of one NTT level over `cols` columns of f elements of ctx's
        field (Fp by default): each element read and written once, the
        twiddle tables read once, and one product per twiddle other than 1
        (stage 0's are all 1, and so are inter row 0 and the first entry of
        every inter row)."""
        inter = tab["inter"]
        nbytes = 4 * (cols * f * 16 * 2 + tab["stw"].numel() + (0 if inter is None else inter.numel()))
        one = ctx.const(1, dev)
        prods = cols * int((tab["stw"] != one).any(-1).sum())
        if inter is not None:
            prods += int((inter != one).any(-1).sum(-1)[torch.arange(cols, device=dev) % g].sum())
        return (*bound(nbytes, product_s(ctx.p_int) * prods), prods)

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
                tile_bench.LAUNCHES, field_ew.LAUNCHES, fold_ops.LAUNCHES, scan.LAUNCHES,
                polyeval.LAUNCHES, ipa_round.LAUNCHES, grand_product.LAUNCHES)

    def zero_launches():
        for counts in counters:
            for name in counts:
                counts[name] = 0
        msm_mod.ROUTES.clear()

    def read_launches():
        """Every kernel's count; "field_ew" is kernel A's three ops together."""
        out = {name: c for counts in counters for name, c in counts.items()}
        out["field_ew"] = sum(out[op] for op in field_ew.OPS)
        return out

    def read_routes():
        return {f"{site}:{route}": cnt for (site, route), cnt in sorted(msm_mod.ROUTES.items())}

    def diff(after, before):
        return {name: after[name] - before.get(name, 0) for name in after}

    k14_kernels = [*ntt_cg.LAUNCHES, *msm_bucket.LAUNCHES]
    ew_kernels = ["field_ew", "fold_program"]  # kernels A and B, on every proof path
    # kernels C-H: D, E, G and H on every proof path, F on every IPA path; C
    # on none since G took the z columns' scans (its phase scan holds it)
    jit_kernels = [*scan.LAUNCHES, *polyeval.LAUNCHES, *ipa_round.LAUNCHES, *grand_product.LAUNCHES]
    path_jit_kernels = [name for name in jit_kernels if name not in scan.LAUNCHES]
    kzg_jit_kernels = [name for name in path_jit_kernels if name not in ipa_round.LAUNCHES]
    csrc_kernels = [name for counts in counters[:5] for name in counts]  # kernels 1-10

    # ---- kernel A: elementwise product, sum and difference, every modulus
    # and broadcast pattern at 2^20 elements, bit for bit ----
    t0 = time.perf_counter()
    ew = field_ew_path(dev, 20261020)
    ptxas_ew = _build.ptxas_usage("field_ew")
    require(all(u.get("spill_bytes") == 0 for u in ptxas_ew.values()), f"field_ew.cu spills: {ptxas_ew}")
    errs["field_ew"] = 0
    report["field_ew"] = dict(
        route="cuda", source="halo2_tpu_torch/csrc/field_ew.cu", replaces="halo2_tpu/ops/field_jax.py:75",
        library_ms=None, **ew["ops"]["mont_mul"], ops=ew["ops"],
        registers={name: u["registers"] for name, u in ptxas_ew.items()})
    emit({"phase": "field_ew", **ew, "ptxas": ptxas_ew, "seconds": time.perf_counter() - t0})

    k16_kernels = list(msm_sorted.LAUNCHES)
    tool_kernels = list(tile_bench.LAUNCHES)

    # ---- kernel 1: constant-geometry NTT level, every level of 2^14 and 2^16,
    # on Fp (the Pasta form) and on BN254's FrBn (the generic form) ----
    t0 = time.perf_counter()
    cg_levels = []
    for field, log_n in ((Fp, 14), (Fp, 16), (FrBn, 14), (FrBn, 16)):
        fctx = FieldCtx(field)
        p = field.MODULUS
        n = 1 << log_n
        omega = pow(field.ROOT_OF_UNITY, 1 << (field.S - log_n), p)
        omega_inv = pow(omega, -1, p)
        x = fctx.to_mont(rand_canon((n,), 0x3FFF if field is Fp else 0x1FFF))  # below p
        fwd = ntt_cg.CgNttPlan(field, log_n, omega)
        inv = ntt_cg.CgNttPlan(field, log_n, omega_inv)
        tag = f"{field.__name__} 2^{log_n}"
        # every level of both plans: kernel == plain, bit for bit, on edge inputs
        for plan in (fwd, inv):
            for li, (lv, tab) in enumerate(zip(plan.levels, plan._tables(dev))):
                f, g = lv["f"], lv["g"]
                xl = edge_mont(n, p).reshape(n // (f * g), f, g, 16)
                yk = ntt_cg.cg_ntt_level(xl, tab["stw"], tab["inter"], fctx, tab["perm"])
                yp = ntt_cg.cg_ntt_level_plain(xl, tab["stw"], tab["inter"], fctx, tab["perm"])
                require(torch.equal(yk, yp), f"cg_ntt_level {tag} level {li}: kernel != plain (limbs)")
                same("cg_ntt_level", yk, yp, fctx, f"cg_ntt_level {tag} level {li}: kernel != plain")
        y = fwd(x)
        require(canon_equal(y, NttPlan(field, log_n, omega)(x), fctx), f"NTT {tag} != radix-2 reference")
        back = fctx.mul(inv(y), fctx.const(pow(n, -1, p), dev))
        require(canon_equal(back, x, fctx), f"inverse NTT {tag} does not invert")
        xe = edge_mont(n, p)
        require(canon_equal(fwd(xe), NttPlan(field, log_n, omega)(xe), fctx), f"NTT {tag} on edge inputs")
        ms_full = time_ms(lambda: fwd(x))
        # each level of the forward plan, timed at its own shape
        for li, (lv, tab) in enumerate(zip(fwd.levels, fwd._tables(dev))):
            f, g = lv["f"], lv["g"]
            xl = x.reshape(n // (f * g), f, g, 16)
            b_ms, b_by, prods = level_bound(n // f, f, tab, g, fctx)

            def level():
                return ntt_cg.cg_ntt_level(xl, tab["stw"], tab["inter"], fctx, tab["perm"])

            row = dict(field=field.__name__, log_n=log_n, level=li, f=f, g=g, products=prods,
                       bound_ms=b_ms, bound_by=b_by, ms=time_ms(level), device_ms=device_ms(level))
            if (log_n, li) == (16, 0):
                row["plain_ms"] = time_ms(
                    lambda: ntt_cg.cg_ntt_level_plain(xl, tab["stw"], tab["inter"], fctx, tab["perm"]), 2)
            cg_levels.append(row)
            emit({"phase": "time", "kernel": "cg_ntt_level", **row})
        emit({"phase": "ntt", "field": field.__name__, "log_n": log_n, "exact": True,
              "full_transform_ms": ms_full, "transform_device_ms": device_ms(lambda: fwd(x)),
              "levels": [(lv["f"], lv["g"]) for lv in fwd.levels]})

    def first_level(field):  # the first level of 2^16: the kernel's row in each form
        return next(r for r in cg_levels if (r["field"], r["log_n"], r["level"]) == (field, 16, 0))

    first, first_bn = first_level("Fp"), first_level("FrBn")
    report["cg_ntt_level"] = dict(
        route="cuda", source="halo2_tpu_torch/csrc/ntt_cg.cu",
        replaces="halo2_tpu/ops/ntt_pallas2.py:219",
        ms=first["ms"], device_ms=first["device_ms"], plain_ms=first["plain_ms"],
        bound_ms=first["bound_ms"], bound_by=first["bound_by"], library_ms=None,
        shape=f"B=1 f={first['f']} g={first['g']} (first level of 2^16, Fp)",
        bn254={k: first_bn[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
        levels=[{k: r[k] for k in ("field", "log_n", "level", "f", "g", "ms", "device_ms", "bound_ms",
                                   "bound_by")}
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
    mul = product_s(fctx.p_int)
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
          "int32_mul_per_s": {"bounds_take": MUL_RATES,
                              **{form: lat[f"{form}_per_s"] for form in tile_bench.PEAK_FORMS}},
          "exact": True})

    # ---- kernels 2-4: bucket MSM ----
    t0 = time.perf_counter()
    params14 = ParamsIPA.cached(Vesta, 14, device=dev)
    emit({"phase": "params_k14", "seconds": time.perf_counter() - t0})
    cc = CurveCtx(Vesta)
    pctx = cc.fctx

    # BN254's G1 bases for the generic form of kernels 2-7: (i + 1) G in
    # affine form, made by a host addition chain (no params file needed)
    t1 = time.perf_counter()
    bn_chain = chain_points(Bn254G1, (1 << 16) + 1)
    emit({"phase": "bn254_bases", "n": len(bn_chain), "seconds": time.perf_counter() - t1})

    # Vesta at the IPA k = 14 commit shape (c = 4) and at c = 8, then BN254's
    # G1 at the KZG k = 14 commit shape (no blind row: n = 2^14)
    for bcurve, n, M, bases_pts in (
        (Vesta, (1 << 14) + 1, 3, params14.g + [params14.w]),
        (Vesta, 1 << 15, 2, params14.g + params14.g_lagrange),
        (Bn254G1, 1 << 14, 3, bn_chain[: 1 << 14]),
    ):
        bcc = CurveCtx(bcurve)
        bctx = bcc.fctx
        bq = bcurve.SCALAR.MODULUS
        t1 = time.perf_counter()
        bases = MSMBases(bcurve, bases_pts, dev)
        c, nwin, T, n_pad = msm_bucket.msm_geometry(bcurve, n, dev)
        canon = rand_canon((M, n)) if bcurve is Vesta else rand_below((M, n), bq)
        canon[0, :3] = 0  # zero scalars
        canon[0, 3] = torch.as_tensor(  # q - 1
            np.frombuffer((bq - 1).to_bytes(32, "little"), dtype="<u2").astype(np.int32), device=dev)
        scal_t = torch.nn.functional.pad(canon.transpose(1, 2), (0, n_pad - n)).contiguous()
        db = bases.device_tables(n_pad, dev)
        bk = msm_bucket.msm_accum(scal_t, db.px, db.py, c, nwin, T, bcc)
        bp, bp_ms = once_ms(lambda: msm_bucket.msm_accum_plain(scal_t, db.px, db.py, c, nwin, T, bcc))
        same("msm_accum", bk, bp, bctx, f"msm_accum {bcurve.__name__} n={n}: kernel != plain")
        fk = msm_bucket.msm_fold(bk, bcc)
        fp, fp_ms = once_ms(lambda: msm_bucket.msm_fold_plain(bk, bcc))
        same("msm_fold", fk, fp, bctx, f"msm_fold {bcurve.__name__} n={n}: kernel != plain")
        rk = msm_bucket.msm_lane_reduce(fk, bcc)
        rp, rp_ms = once_ms(lambda: msm_bucket.msm_lane_reduce_plain(fk, bcc))
        require(torch.equal(rk, rp), f"msm_lane_reduce {bcurve.__name__} n={n}: kernel != plain (limbs)")
        same("msm_lane_reduce", rk, rp, bctx, f"msm_lane_reduce {bcurve.__name__} n={n}: kernel != plain")
        # kernel 4 on edge parts: the identity in lanes 1 and T/2 + 3, lanes 0
        # and T/2 equal (P + P, the doubling case of the complete addition),
        # lane T/2 + 2 the negative of lane 2 (P + (-P)), and a row whose
        # lanes are all the identity
        ep = fk.clone()
        idv = bcc.identity_vec((1,), dev)
        ident = torch.stack([idv.x[0], idv.y[0], idv.z[0]])  # (3, 16)
        h = T // 2
        ep[:, :, :, 1] = ident
        ep[:, :, :, h + 3] = ident
        ep[:, :, :, h] = ep[:, :, :, 0]
        ep[:, 1, :, h + 2] = bctx.neg(ep[:, 1, :, 2])
        ep[-1] = ident[:, :, None]
        ek = msm_bucket.msm_lane_reduce(ep, bcc)
        ekp = msm_bucket.msm_lane_reduce_plain(ep, bcc)
        require(torch.equal(ek, ekp), f"msm_lane_reduce {bcurve.__name__} n={n} edge parts: kernel != plain (limbs)")
        same("msm_lane_reduce", ek, ekp, bctx, f"msm_lane_reduce {bcurve.__name__} n={n} edge parts: kernel != plain")
        require(bcc.decode_points(PointVec(ek[-1:, 0], ek[-1:, 1], ek[-1:, 2]))[0].is_identity(),
                "msm_lane_reduce: a row of identities did not sum to the identity")
        pts = msm_bucket.msm_bucket_many(canon, bases, mont=False)
        t2 = time.perf_counter()
        ints = limbs_to_ints(canon[0].cpu())
        require(pts[0] == msm_host(ints, bases_pts[:n], bcurve), f"MSM {bcurve.__name__} n={n} != msm_host")
        emit({"phase": "msm", "curve": bcurve.__name__, "n": n, "M": M, "c": c, "nwin": nwin, "T": T,
              "exact": True, "host_checked": True, "msm_host_s": time.perf_counter() - t2,
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
        mul, mul_cc = product_s(bctx.p_int, "generic"), product_s(bctx.p_int)  # kernels 2, 3; 4
        emit({"phase": "msm_work", "curve": bcurve.__name__, "n": n, "M": M, "c": c,
              "nonzero_digits": int(nz.sum()), "accum_adds": accum_adds, "fold_adds": fold_adds,
              "bucket_occupancy": float(occ.float().mean()),
              "product_mix": {"generic": product_mix(bctx.p_int, "generic"),
                              "cc": product_mix(bctx.p_int)}})
        timings = {
            "msm_accum": (
                lambda: msm_bucket.msm_accum(scal_t, db.px, db.py, c, nwin, T, bcc),
                bp_ms,
                4 * (scal_t.numel() + db.px.numel() + db.py.numel() + bk.numel()),
                mul * MIXED_ADD_PRODUCTS * accum_adds,
                "halo2_tpu/ops/msm_pallas.py:232",
            ),
            "msm_fold": (
                lambda: msm_bucket.msm_fold(bk, bcc),
                fp_ms,
                4 * (bk.numel() + fk.numel()),
                mul * FULL_ADD_PRODUCTS * fold_adds,
                "halo2_tpu/ops/msm_pallas.py:302",
            ),
            "msm_lane_reduce": (
                lambda: msm_bucket.msm_lane_reduce(fk, bcc),
                rp_ms,
                4 * (fk.numel() + rk.numel()),
                mul_cc * FULL_ADD_PRODUCTS * (T - 1) * rows,
                "halo2_tpu/ops/msm_pallas.py:357",
            ),
        }
        # the k = 14 commit shape (c = 4) is each kernel's row; c = 8 rides along
        for name, (kfn, plain_ms, nbytes, muls, replaces) in timings.items():
            b_ms, b_by = bound(nbytes, muls)
            row = dict(ms=time_ms(kfn), device_ms=device_ms(kfn, 5), plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, shape=f"M={M} n={n} c={c} T={T}")
            if bcurve is Bn254G1:
                report[name]["bn254"] = row
            elif c == 4:
                report[name] = dict(route="cuda", source="halo2_tpu_torch/csrc/msm_bucket.cu",
                                    replaces=replaces, library_ms=None, **row)
            else:
                report[name]["at_c8"] = row
            emit({"phase": "time", "kernel": name, "curve": bcurve.__name__, "c": c, **row})

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
    caps14, eval_shapes = [], []
    with fold_capture(caps14), eval_capture(eval_shapes):
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
    for name in k14_kernels + ew_kernels + path_jit_kernels:
        require(launches[name] > 0, f"kernel {name} was not launched on the k=14 path")
    require(launches["mr_col_ntt"] == 0, "kernel 8 ran on the default (NTT unset) k=14 path")
    emit({"phase": "main_path", "circuit": "BenchCircuit", "k": k, "rows": circ.rows,
          "proof_bytes": len(proof), "verified": True, "flipped_byte_rejected": True,
          "stages": stages, "prove_spans": prove_stages, "launches": launches})

    # ---- kernel B: every part of the k = 14 proof's quotient against the
    # plain program and the eager fold, bit for bit; part 0 timed ----
    t0 = time.perf_counter()
    fold14 = fold_check("k14", caps14)
    del caps14
    # kernel B's -Xptxas -v lines: both instantiations (Pasta form or not)
    # with an empty stack frame and no spills
    ptxas_fold = _build.ptxas_usage("fold")
    ptxas_lines = [line.strip() for line in _build.log_path("fold").read_text().splitlines()
                   if "fold_kernel" in line or "registers" in line or "stack frame" in line]
    require(len(ptxas_fold) == 2 and all(u.get("stack_bytes") == 0 and u.get("spill_bytes") == 0
                                         for u in ptxas_fold.values()),
            f"fold.cu: a kernel B instantiation has a stack frame or spills: {ptxas_fold}")
    emit({"phase": "fold", "path": "k14", "parts": fold14, "ptxas": ptxas_fold,
          "ptxas_lines": ptxas_lines, "bundle_width": fold_ops.BUNDLE_WIDTH,
          "seconds": time.perf_counter() - t0})
    part0 = fold14[0]
    errs["fold_program"] = 0
    report["fold_program"] = dict(
        route="cuda", source="halo2_tpu_torch/csrc/fold.cu", replaces="halo2_tpu/plonk/evaluation.py:412",
        library_ms=None, **{key: part0[key] for key in (
            "ms", "device_ms", "plain_ms", "eager_ms", "bound_ms", "bound_by", "x_bound", "instructions",
            "operations", "bundles", "mean_width", "live_slots", "threads_per_block", "shared_bytes_per_block",
            "scalar_table_launches", "scalar_table_device_ms")},
        shape=f"k=14 part 0: {part0['rows']} rows, clusters {part0['clusters']}",
        ptxas=ptxas_fold.get("fold_kernel<1>"))
    fold_paths = {"k14": fold14}

    # ---- kernels C-F, a phase each: the scans, the evaluations and powers,
    # Kate division and the IPA rounds against their plain versions on every
    # modulus, edge inputs included, with no host sync inside; kernel D at
    # the largest evaluation stack of the k = 14 proof ----
    t0 = time.perf_counter()
    eval_m = max(m for m, n_rows, _ in eval_shapes if n_rows == 1 << k)
    scan_res = scan_path(dev, 20261021)
    emit({"phase": "scan", **scan_res, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    eval_res = batch_eval_path(dev, 20261022, eval_m)
    emit({"phase": "batch_eval", **eval_res, "eval_shapes_k14": sorted(set(eval_shapes)),
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    kate_res = kate_path(dev, 20261025)
    emit({"phase": "kate_div", **kate_res, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    ipa_res = ipa_round_path(dev, 20261023)
    emit({"phase": "ipa_round", **ipa_res, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    grand_res = grand_product_path(dev, 20261026, blinding=vk.cs.blinding_factors())
    emit({"phase": "grand_product", **grand_res, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    horner_res = horner_path(dev, 20261027)
    emit({"phase": "horner", **horner_res, "seconds": time.perf_counter() - t0})
    ptxas_jit = {name: _build.ptxas_usage(name) for name in ("scan", "polyeval", "ipa_round", "grand_product",
                                                             "horner")}
    require(all(u.get("spill_bytes") == 0 and u.get("stack_bytes") == 0
                for usage in ptxas_jit.values() for u in usage.values()),
            f"kernels C-H: a kernel spills or has a stack frame: {ptxas_jit}")
    for name, source, replaces, row, more in (
            ("scan", "scan.cu", "halo2_tpu/ops/scan.py:27", scan_res["timing"]["prefix_product"],
             {key: row for key, row in scan_res["timing"].items() if key != "prefix_product"}),
            ("batch_eval", "polyeval.cu", "halo2_tpu/ops/polyeval.py:71", eval_res["timing"]["batch_eval"],
             {key: row for key, row in eval_res["timing"].items() if key != "batch_eval"}),
            ("kate_div", "polyeval.cu", "halo2_tpu/ops/polyeval.py:137", kate_res["timing"]["kate_div"],
             {key: row for key, row in kate_res["timing"].items() if key != "kate_div"}),
            ("ipa_round", "ipa_round.cu", "halo2_tpu/poly/ipa/__init__.py:356", ipa_res["timing"]["round"],
             {key: row for key, row in ipa_res["timing"].items() if key != "round"}),
            ("grand_product", "grand_product.cu", "halo2_tpu/plonk/lookup_prover.py:147",
             grand_res["timing"]["lookup_z"],
             {key: row for key, row in grand_res["timing"].items() if key != "lookup_z"}),
            ("horner", "horner.cu", "halo2_tpu/ops/polyeval.py:122", horner_res["timing"]["horner"],
             {key: row for key, row in horner_res["timing"].items() if key != "horner"})):
        errs[name] = 0  # values mod p equal the plain version's
        report[name] = dict(route="cuda", source=f"halo2_tpu_torch/csrc/{source}", replaces=replaces,
                            library_ms=None, **row, timing=more,
                            registers={key: u["registers"]
                                       for key, u in ptxas_jit[source[:-3]].items()})

    # ---- the same proof again, warm; its launches are those of one proof,
    # kernel A's also by call site ----
    zero_launches()
    reset_records()
    a_sites = {}
    t0 = time.perf_counter()
    tr = Blake2bWrite(Vesta)
    with kernel_a_sites(a_sites):
        create_proof(params, pk, [circ], [[]], ChaCha20Rng(b"\x2a" * 32), tr)
    require(tr.finalize() == proof, "warm k=14 proof bytes differ from the first")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_launches = read_launches()
    require(sum(a_sites.values()) == warm_launches["field_ew"], "kernel A's launches by site do not add up")
    z_columns = len(vk.cs.lookups) + -(-len(vk.cs.permutation.columns) // (vk.cs_degree - 2))
    require(warm_launches["grand_product"] == grand_product.KERNELS_PER_CALL * z_columns
            and warm_launches["horner"] == 1,
            f"warm k=14 proof: kernel G {warm_launches['grand_product']} device kernels for {z_columns} z "
            f"columns, kernel H {warm_launches['horner']} launches")
    require(not [site for site in a_sites if site.startswith("ops/grand_product.py")
                 or "horner_fold_mont" in site], f"warm k=14 proof: a plain z column or fold on the card: {a_sites}")
    emit({"phase": "warm_k14", "prove_s": warm_s, "prove_spans": get_records(),
          "launches": warm_launches, "launches_by_site": dict(sorted(a_sites.items(), key=lambda kv: -kv[1]))})

    # ---- device time of one warm proof: the four kernels by CUDA events,
    # every kernel on the card by torch.profiler ----
    wrapped_k14 = [(ntt_cg, "cg_ntt_level"), (msm_bucket, "msm_accum"), (msm_bucket, "msm_fold"),
                   (msm_bucket, "msm_lane_reduce")]

    def prove14():
        tr = Blake2bWrite(Vesta)
        create_proof(params, pk, [circ], [[]], ChaCha20Rng(b"\x2a" * 32), tr)
        return tr.finalize()

    proof_again, traced14 = traced_proof(prove14, wrapped_k14)
    require(proof_again == proof, "profiled k=14 proof bytes differ from the first")
    proof_ms = traced14["kernels_event_ms"]
    busy_ms = traced14["device_busy_ms"]
    emit({"phase": "device_time_k14", **traced14,
          "device_busy_share_of_warm_prove": None if busy_ms is None else busy_ms / 1e3 / warm_s})

    # ---- two more warm k = 14 proofs on the same keys: the plain full
    # extended-domain fold (EVAL_H=full), then every msm() call on the sorted
    # MSM (MSM=sorted, kernels 5-7); both must keep the pinned bytes ----
    switch_runs = {}
    for name, env in (("eval_h_full", {"EVAL_H": "full"}), ("msm_sorted", {"MSM": "sorted"})):
        zero_launches()
        reset_records()
        with environ(**env):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tr = Blake2bWrite(Vesta)
            create_proof(params, pk, [circ], [[]], ChaCha20Rng(b"\x2a" * 32), tr)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        sha = hashlib.sha256(tr.finalize()).hexdigest()
        require(sha == BENCH_K14_PROOF_SHA256, f"k=14 {env} proof sha256 {sha} != {BENCH_K14_PROOF_SHA256}")
        switch_runs[name] = dict(env=env, prove_s=run_s, pinned_sha256=True,
                                 peak_memory_bytes=torch.cuda.max_memory_allocated(),
                                 prove_spans=get_records(), launches=read_launches(),
                                 routes=read_routes())
        emit({"phase": f"k14_{name}", "circuit": "BenchCircuit", "k": k, "card": smi,
              **switch_runs[name]})
    launches_sorted14 = switch_runs["msm_sorted"]["launches"]
    for name in k16_kernels:
        require(launches_sorted14[name] > 0, f"kernel {name} was not launched by the k=14 MSM=sorted proof")
    require(switch_runs["eval_h_full"]["launches"]["cg_ntt_level"] > 0,
            "kernel 1 was not launched by the k=14 EVAL_H=full proof")

    # ---- batch14: BatchVerifier over the pinned proof and one made with
    # another rng; its one combined final MSM runs kernels 2-4 ----
    tr = Blake2bWrite(Vesta)
    create_proof(params, pk, [circ], [[]], ChaCha20Rng(b"\x2b" * 32), tr)
    proof_b = tr.finalize()
    require(proof_b != proof, "k=14 proofs under two rng seeds are equal")
    zero_launches()
    t0 = time.perf_counter()
    batch = BatchVerifier()
    batch.add_proof([[]], proof)
    batch.add_proof([[]], proof_b)
    accepted = batch.finalize(params, vk, ChaCha20Rng(b"\x55" * 32))
    batch_s = time.perf_counter() - t0
    batch_launches = read_launches()
    require(accepted is True, "batch14: BatchVerifier rejected two valid k=14 proofs")
    for name in msm_bucket.LAUNCHES:
        require(batch_launches[name] > 0, f"batch14: kernel {name} was not launched by the final MSM")
    flipped = bytearray(proof_b)
    flipped[len(flipped) // 2] ^= 1
    bad_batch = BatchVerifier()
    bad_batch.add_proof([[]], proof)
    bad_batch.add_proof([[]], bytes(flipped))
    require(bad_batch.finalize(params, vk, ChaCha20Rng(b"\x56" * 32)) is False,
            "batch14: BatchVerifier accepted a proof with a flipped byte")
    emit({"phase": "batch14", "card": smi, "proofs": 2, "accepted": True, "flipped_byte_rejected": True,
          "finalize_s": batch_s, "launches": batch_launches})

    # ---- mesh14: the same proof under a mesh of four shards, the same bytes ----
    zero_launches()
    mesh14 = mesh_proof_path(dev, read_launches, read_routes, params, vk, pk, circ, BENCH_K14_PROOF_SHA256)
    launches_mesh14 = mesh14["launches"]
    for name in k14_kernels:
        require(launches_mesh14[name] > 0, f"kernel {name} was not launched on the mesh14 path")
    emit({"phase": "mesh14", "circuit": "BenchCircuit", "k": k, "card": smi, **mesh14})

    # ---- mock14: MockProver on BenchCircuit at k = 14, its vectorised
    # check on the card (no kernel of csrc/ runs: limb arithmetic in torch) ----
    zero_launches()
    mock = mock_path(dev, k, 1000)
    require(not any(read_launches()[name] for name in csrc_kernels), "mock14 launched one of kernels 1-10")
    emit({"phase": "mock14", "card": smi, **mock, "launches": read_launches()})

    # ---- poseidon11: gating config 2 (the Poseidon gadget at k = 11) ----
    k11, circ11, instances11, seed11 = poseidon_k11()
    zero_launches()
    caps = []
    poseidon = proof_path(dev, read_launches, read_routes, "poseidon11", k11, circ11, instances11, seed11,
                          POSEIDON_K11_PROOF_SHA256, wrong=[[(instances11[0][0] + 1) % Fp.MODULUS]],
                          fold_caps=caps)
    launches_poseidon = poseidon["launches"]
    for name in k14_kernels:
        require(launches_poseidon[name] > 0, f"kernel {name} was not launched on the poseidon11 path")
    emit({"phase": "poseidon11", "circuit": "HashCircuit([7, 11])", "card": smi, **poseidon})
    t0 = time.perf_counter()
    rows = fold_check("poseidon11", caps)
    del caps
    fold_paths["poseidon11"] = rows
    emit({"phase": "fold", "path": "poseidon11", "parts": rows, "seconds": time.perf_counter() - t0})

    # ---- sinsemilla14: gating config 4 (the Sinsemilla hash at k = 14),
    # with a third, traced proof; sinsemilla11: the same circuit at k = 11,
    # to the bytes of the port's plain path on the CPU ----
    zero_launches()
    caps = []
    sinsemilla = proof_path(dev, read_launches, read_routes, "sinsemilla14", *sinsemilla_k14(),
                            SINSEMILLA_K14_PROOF_SHA256, wrapped=wrapped_k14, fold_caps=caps)
    launches_sinsemilla = sinsemilla["launches"]
    for name in k14_kernels:
        require(launches_sinsemilla[name] > 0, f"kernel {name} was not launched on the sinsemilla14 path")
    emit({"phase": "sinsemilla14", "circuit": "SinsemillaCircuit (3 words)", "card": smi, **sinsemilla})
    t0 = time.perf_counter()
    rows = fold_check("sinsemilla14", caps)
    del caps
    fold_paths["sinsemilla14"] = rows
    emit({"phase": "fold", "path": "sinsemilla14", "parts": rows, "seconds": time.perf_counter() - t0})
    zero_launches()
    sinsemilla11 = proof_path(dev, read_launches, read_routes, "sinsemilla11", *sinsemilla_k11(),
                              SINSEMILLA_K11_PROOF_SHA256)
    emit({"phase": "sinsemilla11", "circuit": "SinsemillaCircuit (3 words)", "card": smi, **sinsemilla11})

    # ---- sha256_k17: the SHA-256 gadget, 14 blocks at k = 17 (one proof,
    # no warm or traced repeat); kernels 1-7 must run ----
    sha_fixture = os.path.join(ROOT, "tests", "fixtures_torch_sha256.json")
    sha_vk = json.load(open(sha_fixture)).get("vk_k17_transcript_repr") if os.path.exists(sha_fixture) else None
    zero_launches()
    caps = []
    sha = proof_path(dev, read_launches, read_routes, "sha256_k17", *sha256_k17(), SHA256_K17_PROOF_SHA256,
                     warm=False, vk_repr=sha_vk, fold_caps=caps, fold_limit=1)
    launches_sha = sha["launches"]
    sha_proof_launches = sha["launches_by_stage"]["prove_1"]
    for name in k14_kernels + k16_kernels:
        require(launches_sha[name] > 0, f"kernel {name} was not launched on the sha256_k17 path")
    emit({"phase": "sha256_k17", "circuit": "ShaCircuit (14 blocks)", "card": smi,
          "message_bytes": len(sha256_k17_message()), "message_sha256": hashlib.sha256(sha256_k17_message()).hexdigest(),
          "rng_seed": "05" * 32, "sorted_overflows": sum(
              c for key, c in sha["routes_by_stage"]["verify"].items() if key.endswith(":overflow")),
          **sha})
    t0 = time.perf_counter()
    rows = fold_check("sha256_k17", caps)  # part 0 only, every cluster, at 2^17 rows
    del caps
    fold_paths["sha256_k17"] = rows
    emit({"phase": "fold", "path": "sha256_k17", "parts": rows, "seconds": time.perf_counter() - t0})

    # ---- sha256_mock: MockProver on one SHA-256 block at k = 17, its
    # vectorised check on the card (no kernel of csrc/) ----
    zero_launches()
    sha_mock = sha256_mock_path(dev)
    require(not any(read_launches()[name] for name in csrc_kernels),
            "sha256_mock launched one of kernels 1-10")
    emit({"phase": "sha256_mock", "card": smi, **sha_mock, "launches": read_launches()})

    # ---- ecc_mock: MockProver on the ECC and Merkle gadgets, its
    # vectorised check on the card (no kernel of csrc/) ----
    zero_launches()
    ecc_mock = ecc_mock_path(dev)
    require(not any(read_launches()[name] for name in csrc_kernels), "ecc_mock launched one of kernels 1-10")
    emit({"phase": "ecc_mock", "card": smi, **ecc_mock, "launches": read_launches()})

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

    # ---- the KZG path: BenchCircuit over BN254's scalar field at k = 14 ----
    k = 14
    zero_launches()
    t0 = time.perf_counter()
    params_kzg = ParamsKZG.cached(k, device=dev)
    t1 = time.perf_counter()
    circ = bench_circuit_for_k(k, field=FrBn)
    vk = keygen_vk(params_kzg, circ.without_witnesses())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pk = keygen_pk(params_kzg, vk, circ.without_witnesses())
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    reset_records()
    tr = Blake2bWrite(Bn254G1)
    create_proof(params_kzg, pk, [circ], [[]], ChaCha20Rng(b"\x2a" * 32), tr)  # SHPLONK
    proof_kzg = tr.finalize()
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    kzg_spans = get_records()
    reset_records()
    ok = verify_proof(params_kzg, vk, [[]], Blake2bRead(Bn254G1, proof_kzg))
    t5 = time.perf_counter()
    kzg_verify_spans = get_records()
    launches_kzg = read_launches()
    require(ok is True, "KZG k=14 verify")
    sha_kzg = hashlib.sha256(proof_kzg).hexdigest()
    require(sha_kzg == BENCH_KZG_K14_PROOF_SHA256,
            f"KZG k=14 proof sha256 {sha_kzg} != {BENCH_KZG_K14_PROOF_SHA256}")
    bad = bytearray(proof_kzg)
    bad[len(bad) // 2] ^= 1
    try:
        rejected = verify_proof(params_kzg, vk, [[]], Blake2bRead(Bn254G1, bytes(bad))) is not True
    except (OpeningError, TranscriptError):
        rejected = True
    require(rejected, "KZG k=14 proof with a flipped byte was accepted")
    for name in k14_kernels:
        require(launches_kzg[name] > 0, f"kernel {name} was not launched on the KZG k=14 path")
    require(launches_kzg["mr_col_ntt"] == 0, "kernel 8 ran on the default (NTT unset) KZG k=14 path")
    kzg_stages = dict(params_read_s=t1 - t0, keygen_vk_s=t2 - t1, keygen_pk_s=t3 - t2,
                      keygen_s=t3 - t1, prove_s=t4 - t3, verify_s=t5 - t4)
    emit({"phase": "main_path_kzg14", "circuit": "BenchCircuit(FrBn)", "k": k, "multiopen": "shplonk",
          "rows": circ.rows, "proof_bytes": len(proof_kzg), "pinned_sha256": True, "verified": True,
          "flipped_byte_rejected": True, "stages": kzg_stages, "prove_spans": kzg_spans,
          "verify_spans": kzg_verify_spans, "launches": launches_kzg})

    # device time of one warm KZG proof (the same bytes; its launches are one
    # proof's): kernels 1-4 by CUDA events, every kernel on the card by
    # torch.profiler
    zero_launches()
    reset_records()

    def prove_kzg14():
        tr = Blake2bWrite(Bn254G1)
        create_proof(params_kzg, pk, [circ], [[]], ChaCha20Rng(b"\x2a" * 32), tr)
        return tr.finalize()

    proof_again, traced_kzg = traced_proof(prove_kzg14, wrapped_k14)
    require(proof_again == proof_kzg, "profiled KZG k=14 proof bytes differ from the first")
    kzg_proof_ms = traced_kzg["kernels_event_ms"]
    busy_ms = traced_kzg["device_busy_ms"]
    warm_kzg_launches = read_launches()
    emit({"phase": "device_time_kzg14", **traced_kzg, "prove_spans": get_records(),
          "launches": warm_kzg_launches,
          "device_busy_share_of_profiled_prove":
              None if busy_ms is None else busy_ms / 1e3 / traced_kzg["profiled_prove_s"]})

    # one GWC proof with the Keccak256 transcript: proves and verifies
    reset_records()
    t0 = time.perf_counter()
    tr = Keccak256Write(Bn254G1)
    create_proof(params_kzg, pk, [circ], [[]], ChaCha20Rng(b"\x2a" * 32), tr, multiopen="gwc")
    proof_gwc = tr.finalize()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gwc_spans = get_records()
    ok = verify_proof(params_kzg, vk, [[]], Keccak256Read(Bn254G1, proof_gwc), multiopen="gwc")
    t2 = time.perf_counter()
    require(ok is True, "KZG k=14 GWC/Keccak256 verify")
    emit({"phase": "kzg14_gwc_keccak", "verified": True, "proof_bytes": len(proof_gwc),
          "proof_sha256": hashlib.sha256(proof_gwc).hexdigest(), "prove_s": t1 - t0,
          "verify_s": t2 - t1, "prove_spans": gwc_spans})

    # ---- the KZG path at k = 10: the JAX package's proof bytes ----
    t0 = time.perf_counter()
    params_kzg10 = ParamsKZG.cached(10, device=dev)
    circ = bench_circuit_for_k(10, field=FrBn)
    vk = keygen_vk(params_kzg10, circ.without_witnesses())
    pk = keygen_pk(params_kzg10, vk, circ.without_witnesses())
    tr = Blake2bWrite(Bn254G1)
    create_proof(params_kzg10, pk, [circ], [[]], ChaCha20Rng(b"\x2a" * 32), tr)
    proof10 = tr.finalize()
    sha = hashlib.sha256(proof10).hexdigest()
    require(sha == BENCH_KZG_K10_PROOF_SHA256, f"KZG k=10 proof sha256 {sha} != {BENCH_KZG_K10_PROOF_SHA256}")
    require(verify_proof(params_kzg10, vk, [[]], Blake2bRead(Bn254G1, proof10)) is True, "KZG k=10 verify")
    emit({"phase": "golden_kzg10", "exact": True, "seconds": time.perf_counter() - t0})

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

    # the same proof with the sorted MSM switched off (MSM=pallas: every
    # msm() call on the bucket MSM): the same bytes (a warm proof; the sorted
    # one above was the first, so their times do not compare)
    zero_launches()
    reset_records()
    with environ(MSM="pallas"):
        t0 = time.perf_counter()
        tr = Blake2bWrite(Vesta)
        create_proof(params16, pk, [circ], [[]], ChaCha20Rng(b"\x2a" * 32), tr)
        unsorted_proof = tr.finalize()
        torch.cuda.synchronize()
        unsorted_s = time.perf_counter() - t0
    require(unsorted_proof == proof16, "k=16 proof bytes differ with the sorted MSM switched off")
    require(all(msm_sorted.LAUNCHES[name] == 0 for name in k16_kernels),
            "the sorted MSM ran while switched off")
    msm_span = f"msm n={(1 << k) + 1}"
    emit({"phase": "k16_unsorted_same_bytes", "exact": True,
          "prove_s": {"sorted_first": t6 - t5, "unsorted_warm": unsorted_s},
          "msm_span_s": {"sorted_first": prove_spans16.get(msm_span),
                         "unsorted_warm": get_records().get(msm_span)},
          "launches": {"unsorted_warm": read_launches()}})

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

    # ---- kernels 5-7: sorted MSM at n = 2^16 + 1 on the k = 16 bases (Vesta)
    # and on BN254's G1 (the generic form, bases from the host chain) ----
    def sorted_kernels(curve, bases, canon):
        """Kernels 5-7 on `curve` against their plain versions (kernel 7 bit
        for bit, also on edge windows), the sorted MSM against msm_host and
        the bucket MSM; each kernel timed, its bound counted from the digits.
        Returns the report rows and what the caller's further checks use."""
        scc = CurveCtx(curve)
        sctx_b = scc.fctx
        r = curve.SCALAR.MODULUS
        tag = curve.__name__
        n = canon.shape[0]
        t0 = time.perf_counter()
        px, py = bases.device_rows(dev)
        classes = msm_sorted._cap_classes(n, msm_sorted.LANES, msm_sorted.KB, r)
        entries, gstart, overflow = msm_sorted.prestage(canon, 16, classes)
        require(not bool(overflow), f"random scalars overflowed the sorted MSM ({tag})")
        bk = msm_sorted.msm_sorted_accum(entries, gstart, px, py, scc)
        bp, bp_ms = once_ms(lambda: msm_sorted.msm_sorted_accum_plain(entries, gstart, px, py, scc))
        same("msm_sorted_accum", bk, bp, sctx_b, f"msm_sorted_accum {tag}: kernel != plain")
        wk = msm_sorted.msm_sorted_fold(bk, entries, gstart, px, py, scc)
        wp, wp_ms = once_ms(lambda: msm_sorted.msm_sorted_fold_plain(bk, entries, gstart, px, py, scc))
        same("msm_sorted_fold", wk, wp, sctx_b, f"msm_sorted_fold {tag}: kernel != plain")
        hk = msm_sorted.msm_sorted_horner(wk, scc)
        hp, hp_ms = once_ms(lambda: msm_sorted.msm_sorted_horner_plain(wk, scc))
        require(torch.equal(hk, hp), f"msm_sorted_horner {tag}: kernel != plain (limbs)")
        same("msm_sorted_horner", hk, hp, sctx_b, f"msm_sorted_horner {tag}: kernel != plain")
        # kernel 7 on edge windows: identity windows (the top one, a run, the
        # bottom; one with Z = p), all identity, equal windows (2^16 W_15 meets
        # W_14 = 2^16 W_15: P + P inside the addition) and opposite ones (it meets
        # -(2^16 W_15)); projective, each point scaled by its own lambda
        gen = curve.generator()
        base_pts = [gen.mul(int(rng.integers(1, 1 << 62))) for _ in range(16)]
        ident = curve.identity()
        cases = {"identity_windows": [ident if w in (15, 14, 9, 8, 7, 0) else pt
                                      for w, pt in enumerate(base_pts)],
                 "all_identity": [ident] * 16,
                 "equal_windows": base_pts[:14] + [base_pts[15].mul(1 << 16), base_pts[15]],
                 "opposite_windows": base_pts[:14] + [-base_pts[15].mul(1 << 16), base_pts[15]]}
        edge_wins = []
        for case, pts in cases.items():
            pv = scc.encode_points(pts, dev)
            lam = sctx_b.consts([int(rng.integers(2, 1 << 62)) for _ in range(16)], dev)
            ew = torch.stack([sctx_b.mul(t, lam) for t in pv], dim=1).contiguous()
            if case == "identity_windows":
                ew[9, 2] = torch.as_tensor(ints_to_limbs([curve.p()])[0], device=dev)
            want = ident
            for pt in reversed(pts):
                want = want.mul(1 << 16) + pt
            ek = msm_sorted.msm_sorted_horner(ew, scc)
            require(scc.decode_points(PointVec(ek[None, 0], ek[None, 1], ek[None, 2]))[0] == want,
                    f"msm_sorted_horner {tag} {case}: != sum_w 2^(16 w) W_w on the host")
            edge_wins.append((case, ew, ek))
        # the plain version takes the four cases as one batch of independent chains
        ep = msm_sorted.msm_sorted_horner_plain(torch.stack([ew for _, ew, _ in edge_wins], 1), scc)
        for i, (case, _, ek) in enumerate(edge_wins):
            require(torch.equal(ek, ep[i]), f"msm_sorted_horner {tag} {case}: kernel != plain (limbs)")
            same("msm_sorted_horner", ek, ep[i], sctx_b, f"msm_sorted_horner {tag} {case}: kernel != plain")
        got = msm_sorted.msm_sorted(canon, bases)
        t1 = time.perf_counter()
        want = msm_host(limbs_to_ints(canon.cpu()), bases.host_points[:n], curve)
        host_s = time.perf_counter() - t1
        require(got == want, f"sorted MSM {tag} n={n} != msm_host")
        require(got == msm_bucket.msm_bucket_many(canon[None], bases, mont=False)[0],
                f"sorted MSM {tag} n={n} != bucket MSM")
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
        mul = product_s(sctx_b.p_int, "generic")  # kernels 5 and 6 take fe_mul
        # kernel 7: (doublings + additions) x HORNER_ROUNDS products in
        # series on one warp, which issues at most one instruction a cycle, so
        # each takes at least its multiply instructions' cycles. The chain
        # latency of oplat (x <- x * b on one thread) is reported beside it:
        # kernel 7's rounds overlap a product with its late operand's arrival,
        # and on BN254 it ran under 765 such latencies, so that is no bound.
        series = (horner_dbls + horner_adds) * HORNER_ROUNDS
        cycles = lat["fe_mul_cc_pasta" if product_mix(sctx_b.p_int)[1] == 24 else "fe_mul_cc"]
        work = {
            "msm_sorted_accum": mul * MIXED_ADD_PRODUCTS * accum_mixed,
            "msm_sorted_fold": mul * (MIXED_ADD_PRODUCTS * side_mixed + FULL_ADD_PRODUCTS * fold_adds),
            "msm_sorted_horner": max(
                product_s(sctx_b.p_int) * (FULL_ADD_PRODUCTS * horner_adds + DOUBLE_PRODUCTS * horner_dbls),
                series * sum(product_mix(sctx_b.p_int)) / SM_CLOCK_HZ),
        }
        emit({"phase": "msm_sorted", "curve": tag, "n": n, "exact": True, "host_checked": True,
              "msm_host_s": host_s, "nonzero_digits": int(gcnt.sum()),
              "side_points": int(gcnt[:, msm_sorted.LANES].sum()),
              "max_lane": int(gcnt[:, : msm_sorted.LANES].max()), "caps": classes,
              "occupied_buckets": int(occ.sum()), "accum_mixed_adds": accum_mixed,
              "fold_side_mixed_adds": side_mixed, "fold_adds": fold_adds,
              "horner_adds": horner_adds, "horner_doublings": horner_dbls,
              "horner_products_in_series": series, "horner_issue_ms": series * sum(product_mix(sctx_b.p_int))
              / SM_CLOCK_HZ * 1e3, "horner_latency_ms": series * cycles / SM_CLOCK_HZ * 1e3,
              "seconds": time.perf_counter() - t0})
        inputs = 4 * (entries.numel() + gstart.numel() + 2 * n * 16)
        timings = {
            "msm_sorted_accum": (
                lambda: msm_sorted.msm_sorted_accum(entries, gstart, px, py, scc),
                bp_ms,
                inputs + 4 * bk.numel(), "halo2_tpu/ops/msm_sorted.py:275"),
            "msm_sorted_fold": (
                lambda: msm_sorted.msm_sorted_fold(bk, entries, gstart, px, py, scc),
                wp_ms,
                4 * (bk.numel() + wk.numel() + gstart.numel()
                     + 32 * int(gcnt[:, msm_sorted.LANES].sum())),
                "halo2_tpu/ops/msm_sorted.py:433"),
            "msm_sorted_horner": (
                lambda: msm_sorted.msm_sorted_horner(wk, scc),
                hp_ms,
                4 * (wk.numel() + hk.numel()), "halo2_tpu/ops/msm_sorted.py:497"),
        }
        rows = {}
        for name, (kfn, plain_ms, nbytes, replaces) in timings.items():
            b_ms, b_by = bound(nbytes, work[name])
            rows[name] = dict(
                route="cuda", source="halo2_tpu_torch/csrc/msm_sorted.cu", replaces=replaces,
                ms=time_ms(kfn), device_ms=device_ms(kfn, 5), plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shape=f"n={n} nw=16 W={msm_sorted.LANES} KB={msm_sorted.KB} ({tag})",
            )
            emit({"phase": "time", "kernel": name, "curve": tag, **rows[name]})
        return rows, classes, px, py

    n = n16 + 1
    bases = params16._bases_g  # g ++ [w]
    canon = rand_canon((n,))
    edge = [0, 1, q - 1, 1 << 15, ((1 << 15) << 48) % q, (1 << 16) - 1]
    canon[: len(edge)] = torch.as_tensor(ints_to_limbs(edge), device=dev)
    sorted_rows, classes, px, py = sorted_kernels(Vesta, bases, canon)
    report.update(sorted_rows)
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

    # the two routes of msm() for one MSM of 2^16 + 1 points, on the same
    # scalars and bases, each ending in its host readback
    route_ms = {
        "sorted": time_ms(lambda: msm_sorted.msm_sorted(canon, bases)),
        "sorted_prestage": time_ms(lambda: msm_sorted.prestage(canon, 16, classes)),
        "bucket": time_ms(lambda: msm_bucket.msm_bucket_many(canon[None], bases, mont=False)),
    }
    emit({"phase": "msm_routes", "n": n, "ms": route_ms,
          "bucket_geometry": msm_bucket.msm_geometry(Vesta, n, dev)[:3]})

    # the same kernels in their generic form: BN254's G1 (3b = 9, FqBn), the
    # host chain's 2^16 + 1 bases, scalars below r with edge scalars first
    r_bn = FrBn.MODULUS
    canon = rand_below((n,), r_bn)
    edge = [0, 1, r_bn - 1, 1 << 15, ((1 << 15) << 48) % r_bn, (1 << 16) - 1]
    canon[: len(edge)] = torch.as_tensor(ints_to_limbs(edge), device=dev)
    bn_rows, _, _, _ = sorted_kernels(Bn254G1, MSMBases(Bn254G1, bn_chain, dev), canon)
    for name, row in bn_rows.items():
        report[name]["bn254"] = {k: row[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                     "bound_by", "shape")}

    # ---- mesh_ops: the mesh's operations at gating config 5's sizes (a 2^20
    # NTT, an MSM of 2^20 points) on four logical shards of the card ----
    t0 = time.perf_counter()
    mesh_ops = mesh_ops_path(dev, params16.g, 20261019)
    emit({"phase": "mesh_ops", "card": smi, **mesh_ops, "seconds": time.perf_counter() - t0})

    # each kernel's main path: its launches there and its CUDA-event time in one proof
    paths = {name: ("k14", launches, proof_ms) for name in k14_kernels}
    paths.update({name: ("k16", launches16, sorted_proof_ms) for name in k16_kernels})
    paths["mr_col_ntt"] = ("k14 NTT=pallas", launches_mr, {"mr_col_ntt": mr_proof_ms})
    paths.update({name: ("profile_kernels tilemul", tile_launches, {}) for name in tool_kernels})
    paths.update({name: ("k14", launches, traced14["kernels_traced_ms"]) for name in ew_kernels + jit_kernels})
    for path, counts in (("k14", launches), ("k16", launches16), ("kzg14", launches_kzg),
                         ("poseidon11", launches_poseidon), ("sinsemilla14", launches_sinsemilla),
                         ("sha256_k17", launches_sha), ("mesh14", launches_mesh14)):
        for name in ew_kernels + (kzg_jit_kernels if path == "kzg14" else path_jit_kernels):
            require(counts[name] > 0, f"kernel {name} was not launched on the {path} path")
    # the launches of one proof on each path: a warm one where the path
    # makes one, else the first (sha256_k17, k16; mesh14: a proof on warm
    # keys and its verify)
    proof_launches = {"k14": warm_launches, "kzg14": warm_kzg_launches,
                      "poseidon11": poseidon["launches_by_stage"]["prove_2"],
                      "sinsemilla14": sinsemilla["launches_by_stage"]["prove_2"],
                      "sinsemilla11": sinsemilla11["launches_by_stage"]["prove_2"],
                      "sha256_k17": sha_proof_launches, "k16": stage_launches["prove"],
                      "mesh14": launches_mesh14}
    # kernel F: k + 1 device kernels an opening (an emit, k - 1 fused rounds,
    # the last fold), one opening a proof on every IPA path
    for path, k_path in (("k14", 14), ("k16", 16), ("poseidon11", 11), ("sinsemilla14", 14),
                         ("sinsemilla11", 11), ("sha256_k17", 17), ("mesh14", 14), ("kzg14", -1)):
        require(proof_launches[path]["ipa_round"] == k_path + 1,
                f"kernel F launched {proof_launches[path]['ipa_round']} times in a {path} proof, not {k_path + 1}")
    # kernel G: three device kernels a z column; kernel H: one launch a proof
    for path, counts in proof_launches.items():
        require(counts["horner"] == 1, f"kernel H launched {counts['horner']} times in a {path} proof, not once")
        require(counts["grand_product"] > 0 and counts["grand_product"] % grand_product.KERNELS_PER_CALL == 0,
                f"kernel G made {counts['grand_product']} device kernels in a {path} proof, not 3 a z column")
    emit({"phase": "launches_per_proof", "card": smi,
          "paths": {path: {name: counts[name] for name in (*field_ew.OPS, "field_ew", *ew_kernels[1:],
                                                           *jit_kernels)}
                    for path, counts in proof_launches.items()},
          "traced_k14": {"device_events": traced14["device_events"], "device_memsets": traced14["device_memsets"],
                         "device_busy_ms": traced14["device_busy_ms"],
                         "kernels_traced_launches": traced14["kernels_traced_launches"],
                         "kernels_traced_ms": traced14["kernels_traced_ms"]}})
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
                           if "levels" in rec else {}),
                        **({"bn254": rec["bn254"], "launches_kzg14": launches_kzg[name],
                            "ms_per_warm_kzg14_proof": kzg_proof_ms.get(name)}
                           if "bn254" in rec else {}),
                        "launches_poseidon11": launches_poseidon[name],
                        "launches_sinsemilla14": launches_sinsemilla[name],
                        "launches_k14_msm_sorted": launches_sorted14[name],
                        "launches_sha256_k17": launches_sha[name],
                        "launches_mesh14": launches_mesh14[name],
                        "launches_k16": launches16[name], "launches_kzg14": launches_kzg[name],
                        **({"launches_by_op": {path: {op: c[op] for op in field_ew.OPS} for path, c in (
                            ("k14", launches), ("k16", launches16), ("kzg14", launches_kzg),
                            ("poseidon11", launches_poseidon), ("sinsemilla14", launches_sinsemilla),
                            ("sha256_k17", launches_sha), ("mesh14", launches_mesh14))},
                            "ops": rec["ops"], "registers": rec["registers"]} if name == "field_ew" else {}),
                        **({key: rec[key] for key in (
                            "eager_ms", "ptxas", "x_bound", "operations", "bundles", "mean_width", "live_slots",
                            "threads_per_block", "shared_bytes_per_block", "scalar_table_launches",
                            "scalar_table_device_ms")} | {"programs": {
                                path: [{key: r.get(key) for key in FOLD_ROW_KEYS} for r in rows]
                                for path, rows in fold_paths.items()}}
                           if name == "fold_program" else {}),
                        **({key: rec[key] for key in ("x_bound", "timing", "products", "bytes")}
                           if name in jit_kernels else {})})
    require(sorted(report) == sorted(paths), "every kernel has a report row")
    require(len(report) == 18, "ten kernels and kernels A-H")
    require(all("bn254" in report[name] for name in k14_kernels + k16_kernels),
            "kernels 1-7 each have a BN254 row")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
