"""Evaluation domains with part-wise extended-domain transforms.

Counterpart of `halo2_tpu/poly/domain.py` (reference `poly/domain.rs`):
the constants (omega, extended omega, zeta coset, t(X) evaluations,
barycentric weight) are host bigints; basis transforms run as NTTs over limb
tensors on the domain's device through `ops.ntt.get_plan`.
"""

from __future__ import annotations

from typing import List, Sequence, Type

import torch

from ..fields import FieldElement
from ..ops import field as fo
from ..ops.field import NLIMBS
from ..ops.ntt import get_plan, powers
from ..utils.measure import span
from . import COEFF, EXTENDED, LAGRANGE, FVec, Polynomial, Rotation


class EvaluationDomain:
    def __init__(self, field: Type[FieldElement], j: int, k: int, device):
        """j = max constraint degree (quotient_poly_degree = j - 1)."""
        p = field.MODULUS
        self.field = field
        self.device = torch.device(device)
        self.ctx = fo.FieldCtx(field)
        self.k = k
        self.n = 1 << k
        self.quotient_poly_degree = j - 1

        extended_k = k
        while (1 << extended_k) < self.n * self.quotient_poly_degree:
            extended_k += 1
        self.extended_k = extended_k
        self.extended_n = 1 << extended_k

        self.extended_omega = pow(field.ROOT_OF_UNITY, 1 << (field.S - extended_k), p)
        self.omega = pow(self.extended_omega, 1 << (extended_k - k), p)
        self.omega_inv = pow(self.omega, -1, p)
        self.extended_omega_inv = pow(self.extended_omega, -1, p)

        self.g_coset = field.ZETA
        self.g_coset_inv = field.ZETA * field.ZETA % p

        num_parts = 1 << (extended_k - k)
        orig = pow(field.ZETA, self.n, p)
        step = pow(self.extended_omega, self.n, p)
        t_evals = []
        cur = orig
        for _ in range(num_parts):
            t_evals.append((cur - 1) % p)
            cur = cur * step % p
        self.t_evaluations_inv = [pow(t, -1, p) for t in t_evals]

        self.ifft_divisor = pow(1 << k, -1, p)
        self.extended_ifft_divisor = pow(1 << extended_k, -1, p)
        self.barycentric_weight = pow(self.n, -1, p)
        self._powers: dict = {}

    def _ntt(self, log_n: int, omega: int, v: torch.Tensor) -> torch.Tensor:
        """The DFT of v with omega on the engine NTT names, timed into the
        'fft' total (the JAX package's span in `NttPlan.__call__`)."""
        with span(f"ntt 2^{log_n}", category="fft"):
            return get_plan(self.field, log_n, omega)(v)

    def _const(self, v: int) -> torch.Tensor:
        return self.ctx.const(v, self.device)

    # ---------------- constructors ----------------
    def empty_lagrange(self) -> Polynomial:
        return Polynomial(LAGRANGE, FVec.zeros(self.field, self.n, self.device))

    def empty_coeff(self) -> Polynomial:
        return Polynomial(COEFF, FVec.zeros(self.field, self.n, self.device))

    def empty_extended(self) -> Polynomial:
        return Polynomial(EXTENDED, FVec.zeros(self.field, self.extended_n, self.device))

    def constant_lagrange(self, c: int) -> Polynomial:
        return Polynomial(LAGRANGE, FVec.fill(self.field, self.n, c, self.device))

    def constant_extended(self, c: int) -> Polynomial:
        return Polynomial(EXTENDED, FVec.fill(self.field, self.extended_n, c, self.device))

    def lagrange_from_vec(self, vec: FVec) -> Polynomial:
        assert len(vec) == self.n
        return Polynomial(LAGRANGE, vec)

    def coeff_from_vec(self, vec: FVec) -> Polynomial:
        assert len(vec) == self.n
        return Polynomial(COEFF, vec)

    # ---------------- transforms ----------------
    def lagrange_to_coeff(self, a: Polynomial) -> Polynomial:
        assert a.basis == LAGRANGE and len(a) == self.n
        out = self._ntt(self.k, self.omega_inv, a.vec.vals)
        out = self.ctx.mul(out, self._const(self.ifft_divisor))
        return Polynomial(COEFF, FVec(self.field, out))

    def coeff_to_extended(self, a: Polynomial) -> Polynomial:
        assert a.basis == COEFF and len(a) == self.n
        v = self._distribute_powers_zeta(a.vec.vals, into_coset=True)
        v = torch.nn.functional.pad(v, (0, 0, 0, self.extended_n - self.n))
        return Polynomial(EXTENDED, FVec(self.field, self._ntt(self.extended_k, self.extended_omega, v)))

    def coeff_to_extended_part(self, a: Polynomial, ext_omega_factor: int) -> Polynomial:
        """FFT(f(zeta * ext_omega_factor * X), n) - one O(n) part of the
        extended coset evaluation (reference domain.rs:314-380)."""
        assert a.basis == COEFF and len(a) == self.n
        c = self.g_coset * ext_omega_factor % self.field.MODULUS
        v = self._distribute_powers(a.vec.vals, c)
        return Polynomial(LAGRANGE, FVec(self.field, self._ntt(self.k, self.omega, v)))

    def coeff_to_extended_parts(self, a: Polynomial) -> List[Polynomial]:
        num_parts = self.extended_n >> self.k
        factor = 1
        parts = []
        for _ in range(num_parts):
            parts.append(self.coeff_to_extended_part(a, factor))
            factor = factor * self.extended_omega % self.field.MODULUS
        return parts

    def lagrange_vec_to_extended(self, values: Sequence[Polynomial]) -> Polynomial:
        """Interleave m n-sized part vectors into one extended vector."""
        m = self.extended_n >> self.k
        assert len(values) == m and all(len(v) == self.n for v in values)
        stacked = torch.stack([v.vec.vals for v in values], dim=1)  # (n, m, L)
        return Polynomial(EXTENDED, FVec(self.field, stacked.reshape(self.extended_n, NLIMBS)))

    def extended_to_coeff(self, a: Polynomial) -> FVec:
        """iFFT out of the extended coset; truncated to quotient size
        (reference domain.rs:404-430)."""
        assert a.basis == EXTENDED and len(a) == self.extended_n
        v = self._ntt(self.extended_k, self.extended_omega_inv, a.vec.vals)
        v = self.ctx.mul(v, self._const(self.extended_ifft_divisor))
        v = self._distribute_powers_zeta(v, into_coset=False)
        return FVec(self.field, v[: self.n * self.quotient_poly_degree])

    def lagrange_vecs_to_extended(self, a: List[List[Polynomial]]) -> Polynomial:
        """Merge per-degree-cluster partial results (lists of 2^i n-sized
        Lagrange parts) into one extended-basis polynomial
        (reference domain.rs:433-495)."""
        p = self.field.MODULUS
        a = list(a)
        if a and len(a[-1]) == (1 << (self.extended_k - self.k)):
            result_poly = self.lagrange_vec_to_extended(a.pop())
        else:
            result_poly = self.empty_extended()
        if not a:
            return result_poly

        ifft_divisor = self.extended_ifft_divisor
        omega_inv = self.extended_omega_inv
        i = len(a[-1]) << self.k
        while i < self.extended_n:
            ifft_divisor = ifft_divisor * 2 % p
            omega_inv = omega_inv * omega_inv % p
            i <<= 1

        result = torch.zeros((self.extended_n, NLIMBS), dtype=torch.int32, device=self.device)
        for i in range(len(a) - 1, -1, -1):
            parts = a[i]
            assert len(parts) == (1 << i)
            size = self.n << i
            vec = torch.stack([pp.vec.vals for pp in parts], dim=1).reshape(size, NLIMBS)
            v = self._ntt(self.k + i, omega_inv, vec)
            v = self.ctx.mul(v, self._const(ifft_divisor))  # 1 / 2^(k+i)
            ifft_divisor = ifft_divisor * 2 % p
            omega_inv = omega_inv * omega_inv % p
            result = torch.cat([self.ctx.add(result[:size], v), result[size:]], dim=0)
        merged = self._ntt(self.extended_k, self.extended_omega, result)
        return Polynomial(EXTENDED, FVec(self.field, self.ctx.add(result_poly.vec.vals, merged)))

    def divide_by_vanishing_poly(self, a: Polynomial) -> Polynomial:
        assert a.basis == EXTENDED and len(a) == self.extended_n
        m = len(self.t_evaluations_inv)
        tinv = self.ctx.consts(self.t_evaluations_inv, self.device)  # (m, L)
        tiled = tinv.repeat(self.extended_n // m, 1)
        return Polynomial(EXTENDED, FVec(self.field, self.ctx.mul(a.vec.vals, tiled)))

    def rotate_extended(self, a: Polynomial, rotation: Rotation) -> Polynomial:
        assert a.basis == EXTENDED
        step = (1 << (self.extended_k - self.k)) * rotation.i
        return Polynomial(EXTENDED, FVec(self.field, torch.roll(a.vec.vals, -step, dims=0)))

    # ---------------- host-side scalar helpers ----------------
    def rotate_omega(self, value: int, rotation: Rotation) -> int:
        p = self.field.MODULUS
        if rotation.i >= 0:
            return value * pow(self.omega, rotation.i, p) % p
        return value * pow(self.omega_inv, -rotation.i, p) % p

    def l_i_range(self, x: int, xn: int, rotations) -> List[int]:
        """Barycentric Lagrange evaluations l_i(x) (reference domain.rs:652-677)."""
        p = self.field.MODULUS
        rotations = list(rotations)
        denoms = [(x - self.rotate_omega(1, Rotation(r))) % p for r in rotations]
        inv = [pow(d, -1, p) if d else 0 for d in denoms]
        common = (xn - 1) * self.barycentric_weight % p
        return [
            self.rotate_omega(iv * common % p, Rotation(r)) for r, iv in zip(rotations, inv)
        ]

    def get_quotient_poly_degree(self) -> int:
        return self.quotient_poly_degree

    # ---------------- internal ----------------
    def _distribute_powers_zeta(self, v: torch.Tensor, into_coset: bool) -> torch.Tensor:
        """Multiply index i by [1, zeta, zeta^2][i mod 3] (or inverse pattern)."""
        cp = [self.g_coset, self.g_coset_inv] if into_coset else [self.g_coset_inv, self.g_coset]
        pat = self.ctx.consts([1, cp[0], cp[1]], self.device)  # (3, L)
        idx = torch.arange(v.shape[0], device=self.device) % 3
        return self.ctx.mul(v, pat[idx])

    def _distribute_powers(self, v: torch.Tensor, c: int) -> torch.Tensor:
        """v[i] * c^i; the power table is built once per (c, length)."""
        key = (c, v.shape[0])
        if key not in self._powers:
            self._powers[key] = powers(c, v.shape[0], self.ctx, self.device)
        return self.ctx.mul(v, self._powers[key])

