"""Key generation (reference `halo2_proofs/src/plonk/keygen.rs`).

`keygen_vk`: configure -> synthesize into an Assembly (fixed cells,
selectors, copy constraints) -> batch-invert fixed -> compress selectors ->
build permutation VK (sigma commitments) -> commit fixed columns -> VK with
transcript_repr.

`keygen_pk`: adds coeff-form fixed polys, permutation PK (sigma values +
polys), and the l0/l_last/l_active_row helper polynomials.

Counterpart of `halo2_tpu/plonk/keygen.py`; the domain and every device
polynomial live on the params' device.
"""

from __future__ import annotations

import hashlib
from typing import List, Type

from ..curves import Curve, Point
from ..fields import FieldElement
from ..frontend import Value
from ..frontend.floor_planner import synthesize_circuit
from ..poly import COEFF, LAGRANGE, FVec, Polynomial
from ..poly.commitment import Blind
from ..poly.domain import EvaluationDomain
from . import permutation as permutation_mod
from .assigned import Assigned, batch_invert_assigned
from .constraint_system import ConstraintSystem, configure_circuit
from .error import NotEnoughRowsAvailable
from .expression import Selector


class PermutationVerifyingKey:
    def __init__(self, commitments: List[Point]):
        self.commitments = commitments


class PermutationProvingKey:
    def __init__(self, sigma_values: List[List[int]], polys: List[Polynomial]):
        self.permutations = sigma_values  # lagrange values per column
        self.polys = polys  # coeff basis


class VerifyingKey:
    def __init__(
        self,
        curve: Type[Curve],
        domain: EvaluationDomain,
        fixed_commitments: List[Point],
        permutation: PermutationVerifyingKey,
        cs: ConstraintSystem,
        selectors: List[List[bool]],
    ):
        self.curve = curve
        self.domain = domain
        self.fixed_commitments = fixed_commitments
        self.permutation = permutation
        self.cs = cs
        self.cs_degree = cs.degree()
        self.selectors = selectors
        self.transcript_repr = self._compute_transcript_repr()

    def _compute_transcript_repr(self) -> int:
        """Scalar binding the VK (reference plonk.rs:280-315): Blake2b-64
        with personalization "Halo2-Verify-Key" over the length-prefixed
        compact Rust-Debug string of the pinned VK — reproduced
        byte-for-byte by `plonk.pinned` (validated against the pinned VK
        literal in the reference's tests/plonk_api.rs)."""
        s = self.pinned_repr()
        h = hashlib.blake2b(digest_size=64, person=b"Halo2-Verify-Key")
        h.update(len(s).to_bytes(8, "little"))
        h.update(s.encode())
        return self.curve.SCALAR.from_uniform_bytes(h.digest()).v

    def pinned_repr(self, pretty: bool = False) -> str:
        """format!("{:?}", vk.pinned()) — or "{:#?}" when pretty=True."""
        from .pinned import pinned_debug_string

        return pinned_debug_string(self, pretty)

    def hash_into(self, transcript):
        transcript.common_scalar(self.curve.SCALAR(self.transcript_repr))

    # ---- serde (reference plonk.rs:170-263) ----
    def to_bytes(self, fmt: str = "processed") -> bytes:
        import io as _io

        from .. import helpers

        w = _io.BytesIO()
        w.write(self.domain.k.to_bytes(4, "big"))
        w.write(len(self.fixed_commitments).to_bytes(4, "big"))
        for c in self.fixed_commitments:
            helpers.write_point(w, c, fmt)
        for c in self.permutation.commitments:
            helpers.write_point(w, c, fmt)
        for selector in self.selectors:
            w.write(helpers.pack_selector(selector))
        return w.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes, circuit_cls, params, fmt: str = "processed") -> "VerifyingKey":
        import io as _io

        from .. import helpers

        r = _io.BytesIO(data)
        curve = params.curve
        field = curve.SCALAR
        k = int.from_bytes(r.read(4), "big")
        domain, cs, _config = create_domain(field, k, circuit_cls, params.device)
        num_fixed = int.from_bytes(r.read(4), "big")
        fixed_commitments = [helpers.read_point(r, curve, fmt) for _ in range(num_fixed)]
        perm_commitments = [
            helpers.read_point(r, curve, fmt) for _ in cs.permutation.columns
        ]
        selectors = []
        nbytes = ((1 << k) + 7) // 8
        for _ in range(cs.num_selectors):
            selectors.append(helpers.unpack_selector(r.read(nbytes), 1 << k))
        cs.compress_selectors([list(s) for s in selectors])
        return cls(
            curve, domain, fixed_commitments,
            PermutationVerifyingKey(perm_commitments), cs, selectors,
        )


class ProvingKey:
    def __init__(
        self,
        vk: VerifyingKey,
        l0: Polynomial,
        l_last: Polynomial,
        l_active_row: Polynomial,
        fixed_values: List[Polynomial],
        fixed_polys: List[Polynomial],
        permutation: PermutationProvingKey,
    ):
        self.vk = vk
        self.l0 = l0
        self.l_last = l_last
        self.l_active_row = l_active_row
        self.fixed_values = fixed_values
        self.fixed_polys = fixed_polys
        self.permutation = permutation

    def get_vk(self) -> VerifyingKey:
        return self.vk

    # ---- serde (reference plonk.rs:418-490) ----
    def to_bytes(self, fmt: str = "processed") -> bytes:
        import io as _io

        from .. import helpers

        field = self.vk.curve.SCALAR
        w = _io.BytesIO()
        w.write(self.vk.to_bytes(fmt))
        helpers.write_poly_ints(w, field, self.l0.vec.to_ints(), fmt)
        helpers.write_poly_ints(w, field, self.l_last.vec.to_ints(), fmt)
        helpers.write_poly_ints(w, field, self.l_active_row.vec.to_ints(), fmt)
        helpers.write_poly_vec(w, field, self.fixed_values, fmt)
        helpers.write_poly_vec(w, field, self.fixed_polys, fmt)
        helpers.write_poly_vec(w, field, self.permutation.permutations, fmt)
        helpers.write_poly_vec(w, field, self.permutation.polys, fmt)
        return w.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes, circuit_cls, params, fmt: str = "processed") -> "ProvingKey":
        import io as _io

        from .. import helpers

        vk = VerifyingKey.from_bytes(data, circuit_cls, params, fmt)
        # VK consumed a prefix; re-scan to find the offset
        prefix_len = len(vk.to_bytes(fmt))
        r = _io.BytesIO(data[prefix_len:])
        field = vk.curve.SCALAR
        dev = params.device

        def poly(basis):
            return Polynomial(basis, FVec.from_ints(field, helpers.read_poly_ints(r, field, fmt), dev))

        l0 = poly(COEFF)
        l_last = poly(COEFF)
        l_active_row = poly(COEFF)
        fixed_values = [
            Polynomial(LAGRANGE, FVec.from_ints(field, v, dev))
            for v in helpers.read_poly_vec(r, field, fmt)
        ]
        fixed_polys = [
            Polynomial(COEFF, FVec.from_ints(field, v, dev))
            for v in helpers.read_poly_vec(r, field, fmt)
        ]
        sigma_values = helpers.read_poly_vec(r, field, fmt)
        sigma_polys = [
            Polynomial(COEFF, FVec.from_ints(field, v, dev))
            for v in helpers.read_poly_vec(r, field, fmt)
        ]
        return cls(
            vk, l0, l_last, l_active_row, fixed_values, fixed_polys,
            PermutationProvingKey(sigma_values, sigma_polys),
        )


class Assembly:
    """Keygen-time Assignment backend: collects fixed cells, selectors, and
    copies; ignores advice (reference keygen.rs:53-204)."""

    def __init__(self, field: Type[FieldElement], k: int, cs: ConstraintSystem, n: int):
        self.field = field
        self.k = k
        self.n = n
        self.fixed = [[Assigned.zero() for _ in range(n)] for _ in range(cs.num_fixed_columns)]
        self.permutation = permutation_mod.Assembly(cs.permutation, n)
        self.selectors = [[False] * n for _ in range(cs.num_selectors)]
        self.usable_rows = n - (cs.blinding_factors() + 1)

    # Assignment interface
    def enter_region(self, name):
        pass

    def exit_region(self):
        pass

    def annotate_column(self, annotation, column):
        pass

    def enable_selector(self, annotation, selector: Selector, row: int):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        self.selectors[selector.index][row] = True

    def query_instance(self, column, row: int) -> Value:
        if row >= self.n:
            raise NotEnoughRowsAvailable(self.k)
        return Value.unknown()

    def assign_advice(self, annotation, column, row, to):
        pass  # advice is not collected at keygen time

    def assign_fixed(self, annotation, column, row: int, to):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        v = to()
        if isinstance(v, Value) and not v.is_none():
            a = v.force_value()
            self.fixed[column.index][row] = a if isinstance(a, Assigned) else Assigned(int(a))

    def copy(self, l_col, l_row, r_col, r_row):
        self.permutation.copy(l_col, l_row, r_col, r_row)

    def fill_from_row(self, column, from_row: int, to: Value):
        if from_row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        if isinstance(to, Value) and not to.is_none():
            a = to.force_value()
            a = a if isinstance(a, Assigned) else Assigned(int(a))
            for row in range(from_row, self.usable_rows):
                self.fixed[column.index][row] = a

    def get_challenge(self, challenge) -> Value:
        return Value.unknown()

    def push_namespace(self, name):
        pass

    def pop_namespace(self, gadget_name=None):
        pass


def create_domain(field: Type[FieldElement], k: int, circuit, device):
    """`circuit` may be an instance (circuit-params honoured) or a class
    (reference keygen.rs:27-50 + circuit-params plonk/circuit.rs:752-793)."""
    cs = ConstraintSystem()
    config = configure_circuit(circuit, cs)
    degree = cs.degree()
    domain = EvaluationDomain(field, degree, k, device)
    return domain, cs, config


def keygen_vk(params, circuit) -> VerifyingKey:
    curve = params.curve
    field = curve.SCALAR
    k = params.k
    n = params.n
    domain, cs, config = create_domain(field, k, circuit, params.device)
    if n < cs.minimum_rows():
        raise NotEnoughRowsAvailable(k)

    assembly = Assembly(field, k, cs, n)
    synthesize_circuit(assembly, circuit, config, cs.constants)

    fixed_cols = batch_invert_assigned(field.MODULUS, assembly.fixed)
    selectors_snapshot = [list(s) for s in assembly.selectors]
    selector_polys = cs.compress_selectors(assembly.selectors)
    fixed_cols.extend(selector_polys)

    sigma_values = assembly.permutation.sigma_values(field, domain.omega)
    perm_commitments = [
        params.commit_lagrange(col, Blind()) for col in sigma_values
    ]
    permutation_vk = PermutationVerifyingKey(perm_commitments)

    fixed_commitments = [params.commit_lagrange(col, Blind()) for col in fixed_cols]

    return VerifyingKey(
        curve, domain, fixed_commitments, permutation_vk, cs, selectors_snapshot
    )


def keygen_pk(params, vk: VerifyingKey, circuit) -> ProvingKey:
    curve = params.curve
    field = curve.SCALAR
    k = params.k
    n = params.n
    cs0 = ConstraintSystem()
    config = configure_circuit(circuit, cs0)
    if n < cs0.minimum_rows():
        raise NotEnoughRowsAvailable(k)
    domain = vk.domain
    dev = params.device

    assembly = Assembly(field, k, cs0, n)
    synthesize_circuit(assembly, circuit, config, cs0.constants)

    fixed_cols = batch_invert_assigned(field.MODULUS, assembly.fixed)
    selector_polys = cs0.compress_selectors(assembly.selectors)
    fixed_cols.extend(selector_polys)

    fixed_values = [
        Polynomial(LAGRANGE, FVec.from_ints(field, col, dev)) for col in fixed_cols
    ]
    fixed_polys = [domain.lagrange_to_coeff(p.copy()) for p in fixed_values]

    sigma_values = assembly.permutation.sigma_values(field, domain.omega)
    sigma_polys = [
        domain.lagrange_to_coeff(Polynomial(LAGRANGE, FVec.from_ints(field, col, dev)))
        for col in sigma_values
    ]
    permutation_pk = PermutationProvingKey(sigma_values, sigma_polys)

    blinding = vk.cs.blinding_factors()
    l0_v = [0] * n
    l0_v[0] = 1
    l0 = domain.lagrange_to_coeff(Polynomial(LAGRANGE, FVec.from_ints(field, l0_v, dev)))
    l_blind_v = [0] * n
    for i in range(n - blinding, n):
        l_blind_v[i] = 1
    l_last_v = [0] * n
    l_last_v[n - blinding - 1] = 1
    l_last = domain.lagrange_to_coeff(Polynomial(LAGRANGE, FVec.from_ints(field, l_last_v, dev)))
    l_active_v = [1 - (a + b) for a, b in zip(l_last_v, l_blind_v)]
    l_active_row = domain.lagrange_to_coeff(
        Polynomial(LAGRANGE, FVec.from_ints(field, l_active_v, dev))
    )

    return ProvingKey(
        vk, l0, l_last, l_active_row, fixed_values, fixed_polys, permutation_pk
    )
