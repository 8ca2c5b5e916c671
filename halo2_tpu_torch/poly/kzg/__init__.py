"""KZG polynomial commitment scheme over BN254 with GWC and SHPLONK multiopen.

Counterpart of `halo2_tpu/poly/kzg/__init__.py` (reference
`halo2_proofs/src/poly/kzg/`):
  * `ParamsKZG` {g, g_lagrange, g2, s_g2} with the insecure test `setup`
    (commitment.rs:23-133); commitments ignore blinds.
  * `MSMKZG` (scalars x bases accumulator) and `DualMSM` (left/right pair
    checked via e(left, s_g2) * e(right, -g2) == 1) (msm.rs:13-170).
  * GWC multiopen: one kate quotient per distinct point, v/u challenges
    (multiopen/gwc/{prover,verifier}.rs).
  * SHPLONK multiopen: rotation-set quotients with y/v/u challenges and the
    h1/h2 two-commitment protocol (multiopen/shplonk/{prover,verifier}.rs,
    construct_intermediate_sets at shplonk.rs:56).
  * Single/Accumulator strategies finalize via the pairing check
    (strategy.rs:50-162), on the host (`pairing.py`).

QUERY_INSTANCE = False for both variants: instance values are hashed into
the transcript as scalars, never committed (gwc/prover.rs:36,
shplonk/prover.rs:112).

The params own a device, as `ParamsIPA` does: `ParamsKZG.cached(k)` puts
them on CUDA and raises if CUDA is not available, unless the caller passes
`device="cpu"`. Batched commits always take the bucket MSM (kernels 2-4);
single ones are routed by `ops/msm.py`.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Sequence, Tuple, Type

import torch

from ...curves import Bn254G1, Curve, Point
from ...ops.msm import MSMBases, msm
from ...ops.msm_bucket import msm_bucket_many
from ...ops.polyeval import batch_eval_mont, kate_division_mont
from ...pairing import PointG2, pairing_check
from ...poly import FVec, eval_polynomial_host, lagrange_interpolate_host
from ...utils.measure import span
from ..commitment import Blind, ProverQuery, VerifierQuery
from ..ipa import _g_to_lagrange, params_cache_path, publish_file, resolve_device

QUERY_INSTANCE = False
# the seed of `ParamsKZG.cached`'s setup, as the JAX package's
CACHED_SETUP_SEED = 0x5E7


class ParamsKZG:
    """BN254 structured reference string (kzg/commitment.rs:23-133)."""

    def __init__(self, curve: Type[Curve], k: int, g: List[Point],
                 g_lagrange: List[Point], g2: PointG2, s_g2: PointG2, device=None):
        self.curve = curve
        self.k = k
        self.n = 1 << k
        self.g = g
        self.g_lagrange = g_lagrange
        self.g2 = g2
        self.s_g2 = s_g2
        self.device = resolve_device(device)
        self._bases_g = MSMBases(curve, g, self.device)
        self._bases_lagrange = MSMBases(curve, g_lagrange, self.device)

    @classmethod
    def setup(cls, k: int, rng, device=None, curve: Type[Curve] = Bn254G1) -> "ParamsKZG":
        """Insecure trusted setup for tests (commitment.rs `setup`)."""
        assert k < 28
        device = resolve_device(device)
        q = curve.SCALAR.MODULUS
        s = curve.SCALAR.random(rng).v
        g1 = curve.generator()
        g = []
        cur = 1
        for _ in range(1 << k):
            g.append(g1.mul(cur))
            cur = cur * s % q
        g_lagrange = _g_to_lagrange(curve, g, k)
        g2 = PointG2.generator()
        return cls(curve, k, g, g_lagrange, g2, g2.mul(s), device)

    _cache: Dict[Tuple[int, str], "ParamsKZG"] = {}

    @classmethod
    def cached(cls, k: int, device=None) -> "ParamsKZG":
        """Memory- and disk-cached params on `device` (default CUDA): the
        file `kzg-Bn254G1-k<k>.raw` under the `ParamsIPA.cached` rules
        ($H2_PARAMS_CACHE or <repo>/.params_cache; 0 disables the disk
        layer), else `setup(k, random.Random(0x5E7))`, the JAX package's
        cached params, written there."""
        device = resolve_device(device)
        key = (k, str(device))
        if key in cls._cache:
            return cls._cache[key]
        path = params_cache_path(f"kzg-{Bn254G1.__name__}-k{k}.raw")
        if path is not None and os.path.exists(path):
            with open(path, "rb") as f:
                params = cls.read(f.read(), device=device)
            if params.k != k:
                raise ValueError(f"{path} holds params for k = {params.k}, not {k}")
        else:
            params = cls.setup(k, random.Random(CACHED_SETUP_SEED), device)
            if path is not None:
                try:
                    publish_file(path, params.write())
                except OSError:
                    pass
        cls._cache[key] = params
        return params

    # -- commitments: blinds ignored (KZG is not hiding in halo2) --
    def commit_lagrange(self, values: Sequence[int], blind: Blind = None) -> Point:
        return msm(list(values), self._bases_lagrange, site="commit_lagrange")

    def commit(self, coeffs: Sequence[int], blind: Blind = None) -> Point:
        return msm(list(coeffs), self._bases_g, site="commit")

    def commit_many(self, stacks, blinds: Sequence[Blind], lagrange: bool,
                    mont: bool = True) -> List[Point]:
        """Batched commits from device columns: `stacks` is an (M, n, 16)
        limb tensor (Montgomery when mont=True, canonical otherwise) or a
        list of FVec/(n, 16) tensors; one bucket MSM computes all M. KZG
        commitments are unblinded (`kzg/commitment.rs` commit_lagrange
        ignores blinds), so no blind row is appended."""
        if not isinstance(stacks, torch.Tensor):
            stacks = torch.stack([getattr(s, "vals", s) for s in stacks])
        bases = self._bases_lagrange if lagrange else self._bases_g
        return msm_bucket_many(stacks, bases, mont=mont)

    def empty_msm(self) -> "MSMKZG":
        return MSMKZG(self.curve, self.device)

    def accumulator(self) -> "DualMSM":
        """Verification accumulator (the strategy's DualMSM, strategy.rs:58-84)."""
        return DualMSM(self)

    # -- serialization (commitment.rs write/read, RawBytes layout) --
    def write(self) -> bytes:
        out = [self.k.to_bytes(4, "little")]
        for pt in self.g + self.g_lagrange:
            out.append(pt.to_bytes_uncompressed())
        out.append(self.g2.to_bytes_uncompressed())
        out.append(self.s_g2.to_bytes_uncompressed())
        return b"".join(out)

    @classmethod
    def read(cls, data: bytes, curve: Type[Curve] = Bn254G1, device=None) -> "ParamsKZG":
        k = int.from_bytes(data[:4], "little")
        n = 1 << k
        off = 4 + 64 * 2 * n
        pts = [curve.from_bytes_uncompressed(data[4 + 64 * i : 4 + 64 * (i + 1)])
               for i in range(2 * n)]
        g2 = PointG2.from_bytes_uncompressed(data[off : off + 128])
        s_g2 = PointG2.from_bytes_uncompressed(data[off + 128 : off + 256])
        return cls(curve, k, pts[:n], pts[n:], g2, s_g2, device)


class MSMKZG:
    """Deferred scalar*point accumulator (kzg/msm.rs:13-80), evaluated on
    `device`."""

    def __init__(self, curve: Type[Curve], device):
        self.curve = curve
        self.device = device
        self.q = curve.SCALAR.MODULUS
        self.scalars: List[int] = []
        self.bases: List[Point] = []

    def clone(self) -> "MSMKZG":
        m = MSMKZG(self.curve, self.device)
        m.scalars = list(self.scalars)
        m.bases = list(self.bases)
        return m

    def append_term(self, scalar: int, point: Point):
        self.scalars.append(scalar % self.q)
        self.bases.append(point)

    def add_msm(self, other: "MSMKZG"):
        self.scalars.extend(other.scalars)
        self.bases.extend(other.bases)

    def scale(self, factor: int):
        self.scalars = [s * factor % self.q for s in self.scalars]

    def eval(self) -> Point:
        return msm(self.scalars, self.bases, self.curve, device=self.device, site="MSMKZG.eval")


class DualMSM:
    """Two-channel accumulator checked by pairing (kzg/msm.rs:122-170);
    `scale` and `add_msm` fold the guards of several proofs verified with
    strategy="batch" into one check."""

    def __init__(self, params: ParamsKZG):
        self.params = params
        self.left = params.empty_msm()
        self.right = params.empty_msm()

    def scale(self, e: int):
        self.left.scale(e)
        self.right.scale(e)

    def add_msm(self, other: "DualMSM"):
        self.left.add_msm(other.left)
        self.right.add_msm(other.right)

    def check(self) -> bool:
        left = self.left.eval()
        right = self.right.eval()
        with span("kzg: pairing check"):
            return pairing_check([(left, self.params.s_g2), (right, self.params.g2.neg())])


class GuardKZG:
    def __init__(self, msm_accumulator: DualMSM):
        self.msm_accumulator = msm_accumulator

    # parity with GuardIPA.use_challenges() call-sites
    def use_challenges(self) -> DualMSM:
        return self.msm_accumulator


def _poly_vecs(F, dev):
    """(key_of, cache): key_of(query) caches the query's polynomial as an
    FVec under the identity of its polynomial object and returns that key."""
    cache: Dict[int, FVec] = {}

    def key_of(query) -> int:
        pid = id(query.poly)
        if pid not in cache:
            cache[pid] = (FVec.from_ints(F, query.poly, dev) if isinstance(query.poly, list)
                          else query.poly.vec)
        return pid

    return key_of, cache


# ---------------------------------------------------------------------------
# GWC multiopen (multiopen/gwc/{prover,verifier}.rs)
# ---------------------------------------------------------------------------


def _gwc_sets(queries, get_point):
    """Group queries per distinct point, first-seen order (gwc.rs:36-61)."""
    point_query_map: List[Tuple[int, List]] = []
    for query in queries:
        pt = get_point(query)
        for entry in point_query_map:
            if entry[0] == pt:
                entry[1].append(query)
                break
        else:
            point_query_map.append((pt, [query]))
    return point_query_map


def gwc_prove(params: ParamsKZG, rng, transcript, queries: List[ProverQuery]):
    """GWC per-point quotients (reference kzg/multiopen/gwc/prover.rs): the
    v-fold and the Kate division run on the params' device."""
    F = params.curve.SCALAR
    v = int(transcript.squeeze_challenge())
    v_s = F(v)
    key_of, poly_cache = _poly_vecs(F, params.device)

    for z, qs in _gwc_sets(queries, lambda qq: qq.point):
        # sum_j v^j P_j as a reversed Horner fold on device
        batch: Optional[FVec] = None
        for query in reversed(qs):
            pv = poly_cache[key_of(query)]
            batch = pv.copy() if batch is None else batch * v_s + pv
        # no eval subtraction needed before kate division: division by (X-z)
        # ignores the remainder, matching reference's poly_batch - eval_batch
        with span("gwc: kate division"):
            witness = FVec(F, kate_division_mont(F, batch.vals, z))
        with span("gwc: witness commit"):
            w = params.commit(witness.to_ints())
        transcript.write_point(w)


def gwc_verify(params: ParamsKZG, transcript, queries: List[VerifierQuery],
               msm_accumulator: DualMSM) -> GuardKZG:
    q = params.curve.SCALAR.MODULUS
    v = int(transcript.squeeze_challenge())

    sets = _gwc_sets(queries, lambda qq: qq.point)
    w = [transcript.read_point() for _ in sets]
    u = int(transcript.squeeze_challenge())

    commitment_multi = params.empty_msm()
    eval_multi = 0
    witness = params.empty_msm()
    witness_with_aux = params.empty_msm()

    power_of_u = 1
    for (z, qs), wi in zip(sets, w):
        commitment_batch = params.empty_msm()
        eval_batch = 0
        power_of_v = 1
        for query in qs:
            if query.kind == "commitment":
                commitment_batch.append_term(power_of_v, query.commitment)
            else:
                m = query.commitment.clone()
                m.scale(power_of_v)
                commitment_batch.add_msm(m)
            eval_batch = (eval_batch + power_of_v * query.eval) % q
            power_of_v = power_of_v * v % q
        commitment_batch.scale(power_of_u)
        commitment_multi.add_msm(commitment_batch)
        eval_multi = (eval_multi + power_of_u * eval_batch) % q
        witness_with_aux.append_term(power_of_u * z % q, wi)
        witness.append_term(power_of_u, wi)
        power_of_u = power_of_u * u % q

    msm_accumulator.left.add_msm(witness)
    msm_accumulator.right.add_msm(witness_with_aux)
    msm_accumulator.right.add_msm(commitment_multi)
    msm_accumulator.right.append_term(eval_multi, -params.g[0])
    return GuardKZG(msm_accumulator)


# ---------------------------------------------------------------------------
# SHPLONK multiopen (multiopen/shplonk/{prover,verifier}.rs)
# ---------------------------------------------------------------------------


def construct_intermediate_sets_shplonk(queries, get_commitment_key, get_point, get_eval):
    """(rotation_sets, super_point_set) per shplonk.rs:56-146.

    rotation_sets: list of (points_sorted, [(commitment_key, evals), ...]),
    grouped by the *set* of points each commitment is queried at, in
    first-seen commitment order; points sorted ascending (BTreeSet order).
    """
    queries = list(queries)
    super_point_set = set()
    commitment_rotation: List[Tuple[object, set]] = []
    for query in queries:
        pt = get_point(query)
        super_point_set.add(pt)
        key = get_commitment_key(query)
        for entry in commitment_rotation:
            if entry[0] == key:
                entry[1].add(pt)
                break
        else:
            commitment_rotation.append((key, {pt}))

    rotation_set_map: List[Tuple[frozenset, List[object]]] = []
    for key, rotset in commitment_rotation:
        fs = frozenset(rotset)
        for entry in rotation_set_map:
            if entry[0] == fs:
                entry[1].append(key)
                break
        else:
            rotation_set_map.append((fs, [key]))

    eval_lookup = {}
    for query in queries:
        eval_lookup[(get_commitment_key(query), get_point(query))] = get_eval(query)

    rotation_sets = []
    for fs, keys in rotation_set_map:
        points = sorted(fs)
        commitments = [(key, [eval_lookup[(key, pt)] for pt in points]) for key in keys]
        rotation_sets.append((points, commitments))
    return rotation_sets, sorted(super_point_set)


def _eval_vanishing(roots: Sequence[int], x: int, q: int) -> int:
    acc = 1
    for r in roots:
        acc = acc * ((x - r) % q) % q
    return acc


def shplonk_prove(params: ParamsKZG, rng, transcript, queries: List[ProverQuery]):
    """SHPLONK rotation-set quotients (reference multiopen/shplonk/prover.rs).

    Polynomials stay (n, 16) Montgomery limb tensors on the params' device:
    the y/v folds are scalar folds, the per-commitment evals at the rotation
    points one batched evaluation, and the Z_i quotients Kate divisions
    (ops/polyeval.py). Only the low-degree interpolants r_ij (degree <
    #points) and the Z(u) products are host bigints."""
    q = params.curve.SCALAR.MODULUS
    F = params.curve.SCALAR
    dev = params.device
    y = int(transcript.squeeze_challenge())
    y_s = F(y)
    key_of, poly_cache = _poly_vecs(F, dev)

    rotation_sets, super_point_set = construct_intermediate_sets_shplonk(
        queries,
        get_commitment_key=key_of,
        get_point=lambda qq: qq.point,
        get_eval=lambda qq: None,
    )

    # all (commitment, point) evals in one batched evaluation
    with span("shplonk: evals"):
        eval_stack, eval_points = [], []
        for points, commitments in rotation_sets:
            for key, _ in commitments:
                for pt in points:
                    eval_stack.append(poly_cache[key].vals)
                    eval_points.append(pt)
        ctx = next(iter(poly_cache.values())).ctx
        flat_evals = ctx.decode_ints(batch_eval_mont(F, torch.stack(eval_stack), eval_points))

    # low-degree equivalents r_i_j(X) per commitment (degree < #points)
    extended = []
    pos = 0
    for points, commitments in rotation_sets:
        exts = []
        for key, _ in commitments:
            evals = flat_evals[pos : pos + len(points)]
            pos += len(points)
            exts.append((key, lagrange_interpolate_host(points, evals, F)))
        extended.append((points, exts))

    v = int(transcript.squeeze_challenge())
    v_s = F(v)

    with span("shplonk: h quotients"):
        # per set: fold_p = sum_j y^j P_ij on device (reused for h and L)
        fold_ps: List[FVec] = []
        for points, exts in extended:
            fp: Optional[FVec] = None
            for key, _low in reversed(exts):
                pv = poly_cache[key]
                fp = pv.copy() if fp is None else fp * y_s + pv
            fold_ps.append(fp)

        # h(X) = sum_i v^i * (sum_j y^j (P_ij - R_ij)) / Z_i
        h_vec: Optional[FVec] = None
        for (points, exts), fold_p in zip(reversed(extended), reversed(fold_ps)):
            # subtract the y-fold of the low-degree interpolants (host, tiny)
            s_low = [0] * len(points)
            power_of_y = 1
            for _key, low in exts:
                for i, c in enumerate(low):
                    s_low[i] = (s_low[i] - power_of_y * c) % q
                power_of_y = power_of_y * y % q
            reduced = (fold_p + FVec.from_ints(F, s_low, dev).pad_to(params.n)).vals
            for pt in points:
                reduced = kate_division_mont(F, reduced, pt)
            rvec = FVec(F, reduced)
            h_vec = rvec if h_vec is None else h_vec * v_s + rvec

    with span("shplonk: h commit"):
        h = params.commit(h_vec.to_ints())
    transcript.write_point(h)
    u = int(transcript.squeeze_challenge())

    with span("shplonk: linearisation"):
        # L(X) = sum_i v^i z_diff_i * (sum_j y^j (P_ij - r_ij(u))) - Z_T(u) h(X)
        l_vec: Optional[FVec] = None
        z_diffs = []
        power_of_v = 1
        for (points, exts), fold_p in zip(extended, fold_ps):
            diffs = [pt for pt in super_point_set if pt not in points]
            z_i = _eval_vanishing(diffs, u, q)
            z_diffs.append(z_i)
            # constant correction: - sum_j y^j r_ij(u) folded into coeff 0
            const = 0
            power_of_y = 1
            for _key, low in exts:
                const = (const - power_of_y * eval_polynomial_host(low, u, q)) % q
                power_of_y = power_of_y * y % q
            inner = fold_p + FVec.from_ints(F, [const], dev).pad_to(params.n)
            term = inner * F(power_of_v * z_i % q)
            l_vec = term if l_vec is None else l_vec + term
            power_of_v = power_of_v * v % q

        zt_eval = _eval_vanishing(super_point_set, u, q)
        l_vec = l_vec + h_vec * F((q - zt_eval) % q)

        sanity = ctx.decode_ints(batch_eval_mont(F, l_vec.vals[None], [u]))[0]
        assert sanity == 0, "SHPLONK linearisation sanity"

        h2_vec = FVec(F, kate_division_mont(F, l_vec.vals, u))
        h2_vec = h2_vec * F(pow(z_diffs[0], -1, q))
    with span("shplonk: h2 commit"):
        h2 = params.commit(h2_vec.to_ints())
    transcript.write_point(h2)


def shplonk_verify(params: ParamsKZG, transcript, queries: List[VerifierQuery],
                   msm_accumulator: DualMSM) -> GuardKZG:
    q = params.curve.SCALAR.MODULUS
    F = params.curve.SCALAR

    # identity-keyed like the reference's CommitmentReference ptr-eq
    # (kzg/msm.rs): equal-valued commitments from distinct columns must not
    # collapse, or the y-fold multiplicities diverge from the prover's.
    def key_of(qq):
        return ("c" if qq.kind == "commitment" else "m", id(qq.commitment))

    obj_by_id = {id(qq.commitment): qq.commitment for qq in queries}

    rotation_sets, super_point_set = construct_intermediate_sets_shplonk(
        queries,
        get_commitment_key=key_of,
        get_point=lambda qq: qq.point,
        get_eval=lambda qq: qq.eval,
    )

    y = int(transcript.squeeze_challenge())
    v = int(transcript.squeeze_challenge())
    h1 = transcript.read_point()
    u = int(transcript.squeeze_challenge())
    h2 = transcript.read_point()

    z_0_diff_inverse = 0
    z_0 = 0
    outer_msm = params.empty_msm()
    r_outer_acc = 0
    power_of_v = 1
    for i, (points, commitments) in enumerate(rotation_sets):
        diffs = [pt for pt in super_point_set if pt not in points]
        z_diff_i = _eval_vanishing(diffs, u, q)
        if i == 0:
            z_0 = _eval_vanishing(points, u, q)
            z_0_diff_inverse = pow(z_diff_i, -1, q)
            z_diff_i = 1
        else:
            z_diff_i = z_diff_i * z_0_diff_inverse % q

        inner_msm = params.empty_msm()
        r_inner_acc = 0
        power_of_y = 1
        for key, evals in commitments:
            r_x = lagrange_interpolate_host(points, evals, F)
            r_inner_acc = (r_inner_acc + power_of_y * eval_polynomial_host(r_x, u, q)) % q
            kind, ref = key
            if kind == "c":
                inner_msm.append_term(power_of_y, obj_by_id[ref])
            else:
                m = obj_by_id[ref].clone()
                m.scale(power_of_y)
                inner_msm.add_msm(m)
            power_of_y = power_of_y * y % q
        inner_msm.scale(power_of_v * z_diff_i % q)
        outer_msm.add_msm(inner_msm)
        r_outer_acc = (r_outer_acc + power_of_v * r_inner_acc % q * z_diff_i) % q
        power_of_v = power_of_v * v % q

    outer_msm.append_term((-r_outer_acc) % q, params.g[0])
    outer_msm.append_term((-z_0) % q, h1)
    outer_msm.append_term(u, h2)

    msm_accumulator.left.append_term(1, h2)
    msm_accumulator.right.add_msm(outer_msm)
    return GuardKZG(msm_accumulator)


# scheme descriptors used by plonk.{prover,verifier} dispatch
MULTIOPEN = {
    "gwc": (gwc_prove, gwc_verify),
    "shplonk": (shplonk_prove, shplonk_verify),
}
