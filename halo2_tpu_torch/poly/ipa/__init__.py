"""Inner-product-argument (Halo) polynomial commitment scheme over Pasta.

Counterpart of `halo2_tpu/poly/ipa/__init__.py` (reference
`halo2_proofs/src/poly/ipa/`): `ParamsIPA` {g, g_lagrange, w, u} read from
the same `.params_cache/ipa-<curve>-k<k>.raw` files, batched commitments
through the bucket MSM (single ones of 2^16 points and more through the
sorted-bucket MSM, as `ops/msm.py` routes them), the k-round opening
argument, the x1..x4 multiopen protocol, `MSMIPA` and `GuardIPA`.

The params own a device: `ParamsIPA.cached(curve, k)` puts them on CUDA
and raises if CUDA is not available, unless the caller passes
`device="cpu"`. Keygen, prover and verifier take the device from the params.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from ...curves import Curve, Point
from ...hash_to_curve import hash_to_curve
from ...ops.field import NLIMBS, FieldCtx, add_mod, int_to_limbs, ints_to_limbs, mont_mul
from ...ops.msm import MSMBases, msm
from ...ops.msm_bucket import msm_bucket_many
from ...ops.polyeval import batch_eval_mont, device_powers, kate_division_mont, tree_sum
from ...poly import FVec, eval_polynomial_host, lagrange_interpolate_host
from ...utils.measure import span
from ..commitment import Blind, ProverQuery, VerifierQuery, construct_intermediate_sets

QUERY_INSTANCE = True


def resolve_device(device=None) -> torch.device:
    """The params' device: CUDA unless the caller names another; a CUDA
    device that is not available raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def params_cache_path(name: str) -> Optional[str]:
    """Where the params file `name` is cached: under $H2_PARAMS_CACHE, or
    <repo>/.params_cache when it is unset; None when it is 0."""
    cache_dir = os.environ.get("H2_PARAMS_CACHE", "")
    if cache_dir == "0":
        return None
    if not cache_dir:
        cache_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))),
            ".params_cache",
        )
    return os.path.join(cache_dir, name)


def publish_file(path: str, data: bytes) -> None:
    """Write `data` to `path` through a temporary name of this process's
    own: two processes that write the same params never write into one
    file, and each publishes a whole one."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


class ParamsIPA:
    def __init__(self, curve: Type[Curve], k: int, g: List[Point], g_lagrange: List[Point],
                 w: Point, u: Point, device):
        self.curve = curve
        self.k = k
        self.n = 1 << k
        self.g = g
        self.g_lagrange = g_lagrange
        self.w = w
        self.u = u
        self.device = resolve_device(device)
        self._bases_g = MSMBases(curve, g + [w], self.device)
        self._bases_lagrange = MSMBases(curve, g_lagrange + [w], self.device)
        self._bases_guw = MSMBases(curve, g + [u, w], self.device)

    # -- construction (commitment.rs new()) --
    @classmethod
    def new(cls, curve: Type[Curve], k: int, device=None) -> "ParamsIPA":
        assert k < 32
        hasher = hash_to_curve(curve, "Halo2-Parameters")
        g = [hasher(b"\x00" + int(i).to_bytes(4, "little")) for i in range(1 << k)]
        return cls(curve, k, g, _g_to_lagrange(curve, g, k), hasher(b"\x01"), hasher(b"\x02"),
                   device)

    _cache: Dict[Tuple[str, int, str], "ParamsIPA"] = {}

    @classmethod
    def cached(cls, curve: Type[Curve], k: int, device=None) -> "ParamsIPA":
        """Memory- and disk-cached params on `device` (default CUDA).
        Disk location: $H2_PARAMS_CACHE or <repo>/.params_cache, the files
        the JAX package writes; H2_PARAMS_CACHE=0 disables the disk layer."""
        device = resolve_device(device)
        key = (curve.__name__, k, str(device))
        if key in cls._cache:
            return cls._cache[key]
        path = params_cache_path(f"ipa-{curve.__name__}-k{k}.raw")
        if path is not None and os.path.exists(path):
            params = cls._read_raw(curve, path, device)
        else:
            params = cls.new(curve, k, device)
            if path is not None:
                try:
                    params._write_raw(path)
                except OSError:
                    pass
        cls._cache[key] = params
        return params

    def _write_raw(self, path: str) -> None:
        publish_file(path, self.k.to_bytes(4, "little") + b"".join(
            pt.to_bytes_uncompressed() for pt in self.g + self.g_lagrange + [self.w, self.u]))

    @classmethod
    def _read_raw(cls, curve: Type[Curve], path: str, device) -> "ParamsIPA":
        with open(path, "rb") as f:
            data = f.read()
        k = int.from_bytes(data[:4], "little")
        n = 1 << k
        pts = [
            curve.from_bytes_uncompressed(data[4 + 64 * i : 4 + 64 * (i + 1)])
            for i in range(2 * n + 2)
        ]
        return cls(curve, k, pts[:n], pts[n : 2 * n], pts[2 * n], pts[2 * n + 1], device)

    # -- commitments --
    def commit_lagrange(self, values: Sequence[int], blind: Blind) -> Point:
        scalars = list(values) + [blind.value % self.curve.SCALAR.MODULUS]
        return msm(scalars, self._bases_lagrange, self.curve, site="commit_lagrange")

    def commit(self, coeffs: Sequence[int], blind: Blind) -> Point:
        scalars = list(coeffs) + [blind.value % self.curve.SCALAR.MODULUS]
        return msm(scalars, self._bases_g, self.curve, site="commit")

    def commit_many(self, stacks, blinds: Sequence[Blind], lagrange: bool,
                    mont: bool = True) -> List[Point]:
        """Batched commits from device columns: `stacks` is an (M, n, 16)
        limb tensor (Montgomery when mont=True, canonical otherwise) or a
        list of FVec/(n, 16) tensors; one bucket MSM computes all M."""
        if not isinstance(stacks, torch.Tensor):
            stacks = torch.stack([getattr(s, "vals", s) for s in stacks])
        q = self.curve.SCALAR.MODULUS
        bmul = FieldCtx(self.curve.SCALAR).r_int if mont else 1
        blind_rows = torch.as_tensor(
            np.stack([int_to_limbs((b.value % q) * bmul % q) for b in blinds]),
            device=stacks.device,
        )[:, None, :]
        scal = torch.cat([stacks, blind_rows], dim=1)  # (M, n+1, 16)
        bases = self._bases_lagrange if lagrange else self._bases_g
        return msm_bucket_many(scal, bases, mont=mont)

    def empty_msm(self) -> "MSMIPA":
        return MSMIPA(self)

    # -- serialization (commitment.rs write/read) --
    def write(self) -> bytes:
        out = [self.k.to_bytes(4, "little")]
        for pt in self.g + self.g_lagrange + [self.w, self.u]:
            out.append(pt.to_bytes())
        return b"".join(out)

    @classmethod
    def read(cls, curve: Type[Curve], data: bytes, device=None) -> "ParamsIPA":
        k = int.from_bytes(data[:4], "little")
        n = 1 << k
        pts = [curve.from_bytes(data[4 + 32 * i : 4 + 32 * (i + 1)]) for i in range(2 * n + 2)]
        return cls(curve, k, pts[:n], pts[n : 2 * n], pts[2 * n], pts[2 * n + 1], device)


def _g_to_lagrange(curve: Type[Curve], g: List[Point], k: int) -> List[Point]:
    """Inverse NTT over the group: monomial-basis generators -> Lagrange basis
    (reference arithmetic.rs g_to_lagrange), over host Jacobian points."""
    from ...curves import batch_to_affine, jac_add, jac_mul

    F = curve.SCALAR
    q = F.MODULUS
    p = curve.p()
    n = 1 << k
    omega_inv = pow(pow(F.ROOT_OF_UNITY, 1 << (F.S - k), q), -1, q)
    n_inv = pow(n, -1, q)
    a = [pt.jacobian() for pt in g]
    rev = 0
    for i in range(1, n):
        bit = n >> 1
        while rev & bit:
            rev ^= bit
            bit >>= 1
        rev |= bit
        if i < rev:
            a[i], a[rev] = a[rev], a[i]
    m = 1
    while m < n:
        w_m = pow(omega_inv, n // (2 * m), q)
        for s in range(0, n, 2 * m):
            w = 1
            for j in range(m):
                t = jac_mul(a[s + j + m], w, p)
                u_ = a[s + j]
                a[s + j] = jac_add(u_, t, p)
                a[s + j + m] = jac_add(u_, (t[0], (-t[1]) % p, t[2]), p)
                w = w * w_m % q
        m *= 2
    a = [jac_mul(pt, n_inv, p) for pt in a]
    return [Point(curve, xy) if xy else Point(curve, None) for xy in batch_to_affine(a, p)]


class MSMIPA:
    """Deferred MSM accumulator (reference ipa/msm.rs)."""

    def __init__(self, params: ParamsIPA):
        self.params = params
        self.q = params.curve.SCALAR.MODULUS
        self.terms: List[Tuple[int, Point]] = []
        self.g_scalars: Optional[List[int]] = None
        self.w_scalar: Optional[int] = None
        self.u_scalar: Optional[int] = None

    def clone(self) -> "MSMIPA":
        m = MSMIPA(self.params)
        m.terms = list(self.terms)
        m.g_scalars = list(self.g_scalars) if self.g_scalars else None
        m.w_scalar = self.w_scalar
        m.u_scalar = self.u_scalar
        return m

    def append_term(self, scalar: int, point: Point):
        self.terms.append((scalar % self.q, point))

    def add_constant_term(self, scalar: int):
        self.add_to_g_scalars([scalar] + [0] * (self.params.n - 1))

    def add_to_g_scalars(self, scalars: Sequence[int]):
        if self.g_scalars is None:
            self.g_scalars = [0] * self.params.n
        for i, s in enumerate(scalars):
            self.g_scalars[i] = (self.g_scalars[i] + s) % self.q

    def add_to_w_scalar(self, scalar: int):
        self.w_scalar = ((self.w_scalar or 0) + scalar) % self.q

    def add_to_u_scalar(self, scalar: int):
        self.u_scalar = ((self.u_scalar or 0) + scalar) % self.q

    def add_msm(self, other: "MSMIPA"):
        self.terms.extend(other.terms)
        if other.g_scalars:
            self.add_to_g_scalars(other.g_scalars)
        if other.w_scalar is not None:
            self.add_to_w_scalar(other.w_scalar)
        if other.u_scalar is not None:
            self.add_to_u_scalar(other.u_scalar)

    def scale(self, factor: int):
        self.terms = [(s * factor % self.q, pt) for s, pt in self.terms]
        if self.g_scalars:
            self.g_scalars = [s * factor % self.q for s in self.g_scalars]
        if self.w_scalar is not None:
            self.w_scalar = self.w_scalar * factor % self.q
        if self.u_scalar is not None:
            self.u_scalar = self.u_scalar * factor % self.q

    def eval(self) -> Point:
        scalars = [s for s, _ in self.terms]
        points = [pt for _, pt in self.terms]
        if self.w_scalar is not None:
            scalars.append(self.w_scalar)
            points.append(self.params.w)
        if self.u_scalar is not None:
            scalars.append(self.u_scalar)
            points.append(self.params.u)
        if self.g_scalars is not None:
            scalars.extend(self.g_scalars)
            points.extend(self.params.g)
        return msm(scalars, points, self.params.curve, device=self.params.device,
                   site="MSMIPA.eval")

    def check(self) -> bool:
        return self.eval().is_identity()


# ---------------------------------------------------------------------------
# Commitment opening argument (ipa/commitment/{prover,verifier}.rs)
# ---------------------------------------------------------------------------


def _round_emit(pprime, b, s_mult, m: int, z_mont, rands, ctx: FieldCtx) -> torch.Tensor:
    """-> (2, n+2, 16) Montgomery scalars over bases g ++ [u, w]:
    row 0 = L_j (w_l coefficients, z*<p'_hi, b_lo> on u, l_rand on w),
    row 1 = R_j. Lanes >= m of p' and b are zero."""
    n = pprime.shape[0]
    half = m // 2
    lane = torch.arange(n, device=pprime.device)
    j = lane & (m - 1)
    hi = (j & half) != 0
    zero = torch.zeros_like(s_mult)

    def gat(v, idx):
        return v[idx.clamp(0, n - 1)]

    wl = torch.where(hi[:, None], zero, mont_mul(s_mult, gat(pprime, half + j), ctx))
    wr = torch.where(hi[:, None], mont_mul(s_mult, gat(pprime, torch.where(hi, j - half, 0)), ctx),
                     zero)
    first = (lane < half)[:, None]
    vl = torch.where(first, mont_mul(gat(pprime, lane + half), b, ctx), zero)
    vr = torch.where(first, mont_mul(pprime, gat(b, lane + half), ctx), zero)
    tail_l = torch.stack([mont_mul(z_mont, tree_sum(vl, ctx, 0), ctx), rands[0]])
    tail_r = torch.stack([mont_mul(z_mont, tree_sum(vr, ctx, 0), ctx), rands[1]])
    return torch.stack([torch.cat([wl, tail_l]), torch.cat([wr, tail_r])])


def _round_fold(pprime, b, s_mult, m: int, u_mont, uinv_mont, ctx: FieldCtx):
    """p' <- p'_lo + u^-1 p'_hi ; b <- b_lo + u b_hi ; s_mult <- u * s_mult on
    lanes with the half-bit set."""
    n = pprime.shape[0]
    half = m // 2
    lane = torch.arange(n, device=pprime.device)
    idx = (lane + half).clamp(0, n - 1)
    first = (lane < half)[:, None]
    hi_sel = ((lane & half) != 0)[:, None]
    zero = torch.zeros_like(pprime)
    ppn = add_mod(pprime, mont_mul(pprime[idx], uinv_mont, ctx), ctx)
    bn = add_mod(b, mont_mul(b[idx], u_mont, ctx), ctx)
    return (
        torch.where(first, ppn, zero),
        torch.where(first, bn, zero),
        torch.where(hi_sel, mont_mul(s_mult, u_mont, ctx), s_mult),
    )


def ipa_commit_open(params: ParamsIPA, rng, transcript, p_poly, p_blind: Blind, x_3: int):
    """The k-round inner product opening (commitment/prover.rs:29-153).

    g is never folded: after r rounds g'[i] = (product of the u_t picked by
    i's high bits) * g[i], so each round's L/R is one batched 2-MSM over the
    fixed bases [g..., u, w] whose last two coefficients carry the
    z*<.,.> and blinding terms. The rng draw order and transcript writes are
    the reference's. `p_poly` may be a host int list or an FVec."""
    q = params.curve.SCALAR.MODULUS
    F = params.curve.SCALAR
    n = params.n
    dev = params.device
    ctx = FieldCtx(F)

    with span("ipa: s-poly draw"):
        s_poly = [F.random(rng).v for _ in range(n)]
        s_poly_blind = F.random(rng).v

    with span("ipa: s-poly commit"):
        spm = ctx.consts(s_poly, dev)
        s_at_x3 = ctx.decode_ints(batch_eval_mont(F, spm[None], [x_3]))[0]
        spm[0] = ctx.const((s_poly[0] - s_at_x3) % q, dev)
        s_commitment = params.commit_many(spm[None], [Blind(s_poly_blind)], lagrange=False)[0]
    transcript.write_point(s_commitment)

    xi = int(transcript.squeeze_challenge())
    z = int(transcript.squeeze_challenge())

    if isinstance(p_poly, FVec):
        ppm = p_poly.vals
    else:
        assert len(p_poly) == n
        ppm = ctx.consts([v % q for v in p_poly], dev)
    with span("ipa: p' setup"):
        pprime = add_mod(mont_mul(spm, ctx.const(xi, dev), ctx), ppm, ctx)
        v0, p0 = ctx.decode_ints(torch.cat([batch_eval_mont(F, pprime[None], [x_3]), pprime[:1]]))
        pprime = pprime.clone()
        pprime[0] = ctx.const((p0 - v0) % q, dev)
    f = (s_poly_blind * xi + p_blind.value) % q

    b = device_powers(ctx.const(x_3, dev), n, ctx)  # (n, 16) Montgomery
    s_mult = ctx.one(dev).expand(n, NLIMBS).clone()  # product of folded u_t
    z_mont = ctx.const(z, dev)

    m = n
    l_rand = F.random(rng).v
    r_rand = F.random(rng).v
    for _round in range(params.k):
        with span("ipa: round"):
            rands = ctx.consts([l_rand, r_rand], dev)
            scal = _round_emit(pprime, b, s_mult, m, z_mont, rands, ctx)
            l_j, r_j = msm_bucket_many(scal, params._bases_guw)
        transcript.write_point(l_j)
        transcript.write_point(r_j)

        u_j = int(transcript.squeeze_challenge())
        u_j_inv = pow(u_j, -1, q)
        pprime, b, s_mult = _round_fold(
            pprime, b, s_mult, m, ctx.const(u_j, dev), ctx.const(u_j_inv, dev), ctx
        )
        f = (f + l_rand * u_j_inv + r_rand * u_j) % q
        m //= 2
        if m >= 2:  # draw ORDER matches the reference
            l_rand = F.random(rng).v
            r_rand = F.random(rng).v

    c0 = ctx.decode_ints(pprime[:1])[0]
    transcript.write_scalar(params.curve.SCALAR(c0))
    transcript.write_scalar(params.curve.SCALAR(f))


class GuardIPA:
    def __init__(self, msm_acc: MSMIPA, neg_c: int, u: List[int]):
        self.msm = msm_acc
        self.neg_c = neg_c
        self.u = u

    def use_challenges(self) -> MSMIPA:
        self.msm.add_to_g_scalars(compute_s(self.u, self.neg_c, self.msm.q))
        return self.msm


def ipa_commit_verify(params: ParamsIPA, msm_acc: MSMIPA, transcript, x: int, v: int) -> GuardIPA:
    """commitment/verifier.rs verify_proof."""
    q = params.curve.SCALAR.MODULUS
    msm_acc.add_constant_term(-v)
    s_commitment = transcript.read_point()
    xi = int(transcript.squeeze_challenge())
    msm_acc.append_term(xi, s_commitment)
    z = int(transcript.squeeze_challenge())

    u = []
    for _ in range(params.k):
        l = transcript.read_point()
        r = transcript.read_point()
        u_j = int(transcript.squeeze_challenge())
        msm_acc.append_term(pow(u_j, -1, q), l)
        msm_acc.append_term(u_j, r)
        u.append(u_j)

    c = int(transcript.read_scalar())
    f = int(transcript.read_scalar())
    b = compute_b(x, u, q)

    msm_acc.add_to_u_scalar((-c) * b % q * z % q)
    msm_acc.add_to_w_scalar(-f)
    return GuardIPA(msm_acc, (-c) % q, u)


def compute_b(x: int, u: List[int], q: int) -> int:
    tmp = 1
    cur = x
    for u_j in reversed(u):
        tmp = tmp * (1 + u_j * cur) % q
        cur = cur * cur % q
    return tmp


def compute_s(u: List[int], init: int, q: int) -> List[int]:
    """Coefficients of g(X) = prod (1 + u_{k-1-i} X^{2^i}) scaled by init."""
    v = [0] * (1 << len(u))
    v[0] = init % q
    length = 1
    for u_j in reversed(u):
        for i in range(length):
            v[length + i] = v[i] * u_j % q
        length *= 2
    return v


# ---------------------------------------------------------------------------
# Multiopen (ipa/multiopen/{prover,verifier}.rs)
# ---------------------------------------------------------------------------


def multiopen_prove(params: ParamsIPA, rng, transcript, queries: List[ProverQuery]):
    """x1..x4 multiopen (reference ipa/multiopen/prover.rs) over device
    polynomials: scalar folds, Kate divisions and one batched eval at x3."""
    q = params.curve.SCALAR.MODULUS
    F = params.curve.SCALAR
    dev = params.device
    x_1 = int(transcript.squeeze_challenge())
    x_2 = int(transcript.squeeze_challenge())

    # commitment key: identity of (poly object, blind value)
    poly_cache: Dict[int, FVec] = {}

    def key_of(query):
        pid = id(query.poly)
        if pid not in poly_cache:
            poly_cache[pid] = (
                FVec.from_ints(F, query.poly, dev) if isinstance(query.poly, list) else query.poly.vec
            )
        return (pid, query.blind.value)

    poly_map, point_sets = construct_intermediate_sets(
        queries,
        get_point=lambda qq: qq.point,
        get_commitment_key=key_of,
        get_eval=lambda qq: None,
    )

    x1_s = F(x_1)
    q_polys: List[Optional[FVec]] = [None] * len(point_sets)
    q_blinds = [0] * len(point_sets)
    with span("multiopen: q-poly folds"):
        for cd in poly_map:
            pid, blind_v = cd.commitment
            coeffs = poly_cache[pid]
            si = cd.set_index
            q_polys[si] = coeffs.copy() if q_polys[si] is None else q_polys[si] * x1_s + coeffs
            q_blinds[si] = (q_blinds[si] * x_1 + blind_v) % q

    x2_s = F(x_2)
    q_prime: Optional[FVec] = None
    with span("multiopen: kate divisions"):
        for points, poly in zip(point_sets, q_polys):
            reduced = poly.vals
            for point in points:
                reduced = kate_division_mont(F, reduced, point)
            rvec = FVec(F, reduced)
            q_prime = rvec if q_prime is None else q_prime * x2_s + rvec

    q_prime_blind = F.random(rng).v
    with span("multiopen: q' commit"):
        q_prime_commitment = params.commit_many(
            q_prime.vals[None], [Blind(q_prime_blind)], lagrange=False
        )[0]
    transcript.write_point(q_prime_commitment)

    x_3 = int(transcript.squeeze_challenge())
    with span("multiopen: q evals at x3"):
        stacked = torch.stack([qp.vals for qp in q_polys])
        for ev in q_prime.ctx.decode_ints(batch_eval_mont(F, stacked, [x_3] * len(q_polys))):
            transcript.write_scalar(F(ev))

    x_4 = int(transcript.squeeze_challenge())
    x4_s = F(x_4)
    p_vec = q_prime
    p_blind = q_prime_blind
    for poly, blind in zip(q_polys, q_blinds):
        p_vec = p_vec * x4_s + poly
        p_blind = (p_blind * x_4 + blind) % q

    ipa_commit_open(params, rng, transcript, p_vec, Blind(p_blind), x_3)


def multiopen_verify(params: ParamsIPA, transcript, queries: List[VerifierQuery],
                     msm_acc: MSMIPA) -> GuardIPA:
    q = params.curve.SCALAR.MODULUS
    F = params.curve.SCALAR
    x_1 = int(transcript.squeeze_challenge())
    x_2 = int(transcript.squeeze_challenge())

    # Key by commitment OBJECT IDENTITY, not value: the reference's
    # CommitmentReference compares with std::ptr::eq, so two distinct
    # columns with equal commitments stay separate entries in the x1-fold.
    def key_of(qq):
        return ("c" if qq.kind == "commitment" else "m", id(qq.commitment))

    commitment_map, point_sets = construct_intermediate_sets(
        queries,
        get_point=lambda qq: qq.point,
        get_commitment_key=key_of,
        get_eval=lambda qq: qq.eval,
    )

    q_commitments = [params.empty_msm() for _ in point_sets]
    q_eval_sets = [[0] * len(ps) for ps in point_sets]
    obj_by_id = {id(qq.commitment): qq.commitment for qq in queries}
    for cd in commitment_map:
        si = cd.set_index
        q_commitments[si].scale(x_1)
        kind, ref = cd.commitment
        if kind == "c":
            q_commitments[si].append_term(1, obj_by_id[ref])
        else:
            q_commitments[si].add_msm(obj_by_id[ref])
        for i, ev in enumerate(cd.evals):
            q_eval_sets[si][i] = (q_eval_sets[si][i] * x_1 + ev) % q

    q_prime_commitment = transcript.read_point()
    x_3 = int(transcript.squeeze_challenge())
    u = [int(transcript.read_scalar()) for _ in q_eval_sets]

    msm_eval = 0
    for points, evals, proof_eval in zip(point_sets, q_eval_sets, u):
        r_poly = lagrange_interpolate_host(points, evals, F)
        r_eval = eval_polynomial_host(r_poly, x_3, q)
        ev = (proof_eval - r_eval) % q
        for point in points:
            ev = ev * pow((x_3 - point) % q, -1, q) % q
        msm_eval = (msm_eval * x_2 + ev) % q

    x_4 = int(transcript.squeeze_challenge())
    msm_acc.append_term(1, q_prime_commitment)
    v = msm_eval
    for q_commitment, q_eval in zip(q_commitments, u):
        msm_acc.scale(x_4)
        msm_acc.add_msm(q_commitment)
        v = (v * x_4 + q_eval) % q

    return ipa_commit_verify(params, msm_acc, transcript, x_3, v)
