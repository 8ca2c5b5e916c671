"""Quotient (h) polynomial evaluation engine.

Counterpart of the reference's `plonk/evaluation.rs`: all gate,
permutation, and lookup constraints are evaluated over the extended coset
domain as batched device tensor programs (FVec ops on limb tensors), folded with
powers of y in exactly the verifier's expression order
(`plonk/verifier.rs:245-327`, `permutation/verifier.rs:115-196`,
`lookup/verifier.rs:80-167`).

Counterpart of `halo2_tpu/plonk/evaluation.py`. The default engine is the
fork's memory-optimized *part-wise* walk with constraint clusters and
`need_to_compute` part skipping (evaluation.rs:394-975); `EVAL_H=full`
selects the plain full extended-domain fold (the equivalence oracle). The
part-wise and the row-sharded engines' fold (`make_fold`) runs, on the card,
as two launches of kernel B a part, its scalar table and the fold
(`ops/fold.py`: the fold's walk recorded once as a program, as `jax.jit`
traces `fold_fn` at `halo2_tpu/plonk/evaluation.py:412`), and on the CPU
eagerly as tensor code; the full fold runs eagerly on kernel A's field ops.
"""

from __future__ import annotations

import os
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from ..poly import EXTENDED, LAGRANGE, FVec, Polynomial
from ..ops.fold import Fold
from ..ops.ntt import powers
from .expression import ADVICE, FIXED, Expression


def _cluster_idx(degree: int, max_cluster_idx: int) -> int:
    """ceil(log2(degree)) clamped (reference evaluation.rs:977-988)."""
    c = (degree - 1).bit_length() if degree > 1 else 0
    return min(c, max_cluster_idx)


def _expr_columns(exprs):
    """(fixed, advice, instance) column-index sets used by expressions."""
    fixed: set = set()
    advice: set = set()
    instance: set = set()
    for e in exprs:
        e.evaluate(
            constant=lambda c: None,
            selector=lambda s: None,
            fixed=lambda q: fixed.add(q.column_index),
            advice=lambda q: advice.add(q.column_index),
            instance=lambda q: instance.add(q.column_index),
            challenge=lambda c: None,
            negated=lambda a: None,
            sum_=lambda a, b: None,
            product=lambda a, b: None,
            scaled=lambda a, f: None,
        )
    return fixed, advice, instance


class Evaluator:
    """Extended-domain constraint evaluator bound to a proving key."""

    def __init__(self, pk):
        self.pk = pk
        self.domain = pk.vk.domain
        self.field = pk.vk.curve.SCALAR

    def evaluate_h(
        self,
        advice_polys: List[List[Polynomial]],
        instance_polys: List[List[Polynomial]],
        challenges: List[int],
        y: int,
        beta: int,
        gamma: int,
        theta: int,
        lookups: List[List],
        permutations: List,
    ) -> Polynomial:
        """Dispatch on EVAL_H, read at each call, as
        `halo2_tpu/plonk/evaluation.py:113-128` does: "parts", the part-wise
        walk; "full", the plain full extended-domain fold; "mesh", or no
        EVAL_H while a mesh (`parallel.use_mesh`) is active and can shard the
        extended domain, the row-sharded fold `evaluate_h_mesh`; no EVAL_H
        otherwise, the part-wise walk. Any other value raises ValueError
        (the JAX dispatcher takes the part-wise walk without a word)."""
        from ..parallel.context import active_mesh

        mode = os.environ.get("EVAL_H")
        args = (advice_polys, instance_polys, challenges, y, beta, gamma,
                theta, lookups, permutations)
        if mode == "full":
            return self.evaluate_h_full(*args)
        if mode == "parts":
            return self.evaluate_h_parts(*args)
        mc = active_mesh()
        if mode == "mesh" or (
            mode is None and mc is not None and mc.can_shard_ntt(self.domain.extended_k)
        ):
            return self.evaluate_h_mesh(*args)
        if mode is None:
            return self.evaluate_h_parts(*args)
        raise ValueError(f"EVAL_H={mode!r}: expected parts, full or mesh")

    def _fold_machinery(
        self,
        advice_polys: List[List[Polynomial]],
        instance_polys: List[List[Polynomial]],
        challenges: List[int],
        lookups: List[List],
        permutations: List,
        n_rows: int,
        rot_scale: int,
    ):
        """Constraint-fold builder for the part-wise engine.

        Builds (a) the deterministic poly layout, (b) the constraint
        schedule in the verifier's global fold order (verifier.rs:245-327)
        with per-item cluster = ceil(log2(degree)) and column dependencies,
        and (c) `fold_for(c_lo) -> (fold, needed poly indices)` where
        the fold evaluates every item in clusters >= c_lo over length-
        `n_rows` row vectors, rotations scaled by `rot_scale` (1 for n-sized
        parts, extended_n/n for full extended vectors). Each item is scaled
        by the explicit y-power of its fold position, so any partition of
        the items sums to exactly the verifier's y-Horner fold."""
        pk = self.pk
        domain = self.domain
        F = self.field
        p = F.MODULUS
        cs = pk.vk.cs
        L = domain.extended_k - domain.k  # max cluster idx; num_clusters = L+1

        blinding = cs.blinding_factors()
        last_rotation = -(blinding + 1)
        chunk_len = pk.vk.cs_degree - 2
        delta = F.DELTA

        # ---- poly list in deterministic order (part-invariant layout) ----
        num_proofs = len(advice_polys)
        poly_list: List[Polynomial] = []
        poly_list.extend(pk.fixed_polys)
        n_fixed = len(pk.fixed_polys)
        IDX_L0, IDX_LLAST, IDX_LACT = n_fixed, n_fixed + 1, n_fixed + 2
        poly_list.extend([pk.l0, pk.l_last, pk.l_active_row])
        sigma_base = len(poly_list)
        poly_list.extend(pk.permutation.polys)
        layout = []  # per-proof offsets
        for proof_idx in range(num_proofs):
            entry = {"advice": len(poly_list)}
            poly_list.extend(advice_polys[proof_idx])
            entry["instance"] = len(poly_list)
            poly_list.extend(instance_polys[proof_idx])
            entry["z"] = len(poly_list)
            poly_list.extend([s.poly for s in permutations[proof_idx].sets])
            entry["lookups"] = len(poly_list)
            for committed in lookups[proof_idx]:
                poly_list.extend([
                    committed.product_poly,
                    committed.permuted_input_poly,
                    committed.permuted_table_poly,
                ])
            layout.append(entry)

        n_sigma = len(pk.permutation.polys)
        num_lookups = tuple(len(lk) for lk in lookups)
        num_sets = tuple(len(pm.sets) for pm in permutations)
        num_ch = len(challenges)

        def col_poly_idx(column, entry) -> int:
            if column.kind == FIXED:
                return column.index
            if column.kind == ADVICE:
                return entry["advice"] + column.index
            return entry["instance"] + column.index

        # ---- constraint schedule: (kind, proof_idx, aux, cluster, deps) in
        # the verifier's global fold order (verifier.rs:245-327). Fixed
        # low-degree cluster slots (1 and 2, evaluation.rs:566-585) are
        # clamped to L: cluster c only needs c >= ceil(log2(d-1)), and
        # 2^L >= j-1 >= d-1 always, so the clamp stays exact even for
        # domains with extended_k - k < 2 that the reference never hits ----
        items: List[tuple] = []
        for proof_idx in range(num_proofs):
            entry = layout[proof_idx]

            def expr_deps(exprs) -> frozenset:
                ef, ea, ei = _expr_columns(exprs)
                return frozenset(
                    {i for i in ef}
                    | {entry["advice"] + i for i in ea}
                    | {entry["instance"] + i for i in ei}
                )

            for gate in cs.gates:
                for poly in gate.polys:
                    items.append((
                        "gate", proof_idx, poly,
                        _cluster_idx(poly.degree(), L), expr_deps([poly]),
                    ))
            nset = num_sets[proof_idx]
            if nset:
                z0 = entry["z"]
                items.append(("perm_l0", proof_idx, None, min(1, L), frozenset({IDX_L0, z0})))
                items.append((
                    "perm_llast", proof_idx, None, min(2, L),
                    frozenset({IDX_LLAST, z0 + nset - 1}),
                ))
                for i in range(1, nset):
                    items.append((
                        "perm_cont", proof_idx, i, min(1, L),
                        frozenset({IDX_L0, z0 + i, z0 + i - 1}),
                    ))
                prod_cluster = _cluster_idx(2 + chunk_len, L)
                columns = cs.permutation.columns
                for chunk_index in range(nset):
                    cols = columns[chunk_index * chunk_len:(chunk_index + 1) * chunk_len]
                    deps = {IDX_LACT, z0 + chunk_index}
                    deps.update(
                        sigma_base + chunk_index * chunk_len + j for j in range(len(cols))
                    )
                    deps.update(col_poly_idx(c, entry) for c in cols)
                    items.append((
                        "perm_prod", proof_idx, chunk_index, prod_cluster, frozenset(deps),
                    ))
            for lk_idx in range(num_lookups[proof_idx]):
                argument = cs.lookups[lk_idx]
                zi = entry["lookups"] + 3 * lk_idx
                ai, si = zi + 1, zi + 2
                max_in = max((e.degree() for e in argument.input_expressions), default=0)
                max_tab = max((e.degree() for e in argument.table_expressions), default=0)
                prod_cluster = _cluster_idx(2 + max_in + max_tab, L)
                prod_deps = frozenset(
                    {IDX_LACT, zi, ai, si}
                    | expr_deps(argument.input_expressions)
                    | expr_deps(argument.table_expressions)
                )
                items.append(("lk_l0", proof_idx, lk_idx, min(1, L), frozenset({IDX_L0, zi})))
                items.append(("lk_llast", proof_idx, lk_idx, min(2, L), frozenset({IDX_LLAST, zi})))
                items.append(("lk_prod", proof_idx, lk_idx, prod_cluster, prod_deps))
                items.append(("lk_l0_as", proof_idx, lk_idx, min(1, L), frozenset({IDX_L0, ai, si})))
                items.append(("lk_as_prev", proof_idx, lk_idx, min(2, L), frozenset({IDX_LACT, ai, si})))

        N = len(items)
        assert N > 0, "no constraints to evaluate"

        def make_fold(c_lo: int):
            """(fold, needed poly indices) for the clusters >= c_lo (the set a
            part with 2-adic valuation L - c_lo fires). The fold takes
            {poly_idx: (n, L) tensor} for exactly the polys those clusters
            use and returns {cluster: (n, L) tensor}."""
            active = [
                (i + 1, kind, proof_idx, aux, cluster)
                for i, (kind, proof_idx, aux, cluster, _deps) in enumerate(items)
                if cluster >= c_lo
            ]
            needed: set = set()
            for i, (kind, proof_idx, aux, cluster, deps) in enumerate(items):
                if cluster >= c_lo:
                    needed |= deps
            needed_idx = tuple(sorted(needed))
            max_exp = max((N - gi for gi, *_ in active), default=0)

            def walk(vecs, coset_x, sc, const_vec):
                """The fold of every active item over vector-like values:
                FVecs in the eager fold, ops/fold.py's recording stand-ins
                when the program for kernel B is recorded. `vecs` maps a
                poly index to its column, `sc` holds the scalars y, beta,
                gamma, theta, ch and one, `const_vec(c)` is the constant c
                on every row. Returns {cluster: value}."""
                y_pows = [sc.one]
                for _ in range(max_exp):
                    y_pows.append(y_pows[-1] * sc.y)
                beta_s, gamma_s, theta_s, ch_s = sc.beta, sc.gamma, sc.theta, sc.ch

                def rot(vec, r: int):
                    return vec.rotate(r * rot_scale)

                one = const_vec(1)

                def eval_expr(expr: Expression, entry):
                    return expr.evaluate(
                        constant=lambda c: const_vec(c),
                        selector=lambda s: (_ for _ in ()).throw(
                            ValueError("virtual selector in evaluate_h")
                        ),
                        fixed=lambda q: rot(vecs[q.column_index], q.rotation.i),
                        advice=lambda q: rot(
                            vecs[entry["advice"] + q.column_index], q.rotation.i
                        ),
                        instance=lambda q: rot(
                            vecs[entry["instance"] + q.column_index], q.rotation.i
                        ),
                        challenge=lambda c: ch_s[c.index],
                        negated=lambda a: -a,
                        sum_=lambda a, b: a + b,
                        product=lambda a, b: a * b,
                        scaled=lambda a, f: a * F(f),
                    )

                def item_value(kind, proof_idx, aux):
                    entry = layout[proof_idx]
                    if kind == "gate":
                        return eval_expr(aux, entry)
                    z0 = entry["z"]
                    if kind == "perm_l0":
                        return vecs[IDX_L0] * (one - vecs[z0])
                    if kind == "perm_llast":
                        zl = vecs[z0 + num_sets[proof_idx] - 1]
                        return vecs[IDX_LLAST] * (zl * zl - zl)
                    if kind == "perm_cont":
                        return vecs[IDX_L0] * (
                            vecs[z0 + aux] - rot(vecs[z0 + aux - 1], last_rotation)
                        )
                    if kind == "perm_prod":
                        chunk_index = aux
                        columns = cs.permutation.columns
                        cols = columns[chunk_index * chunk_len:(chunk_index + 1) * chunk_len]
                        left = rot(vecs[z0 + chunk_index], 1)
                        for j, col in enumerate(cols):
                            sigma = vecs[sigma_base + chunk_index * chunk_len + j]
                            cv = vecs[col_poly_idx(col, entry)]
                            left = left * (cv + sigma * beta_s + gamma_s)
                        right = vecs[z0 + chunk_index]
                        for j, col in enumerate(cols):
                            cur_s = beta_s * F(pow(delta, chunk_index * chunk_len + j, p))
                            cv = vecs[col_poly_idx(col, entry)]
                            right = right * (cv + coset_x * cur_s + gamma_s)
                        return vecs[IDX_LACT] * (left - right)
                    # lookups
                    lk_idx = aux
                    argument = cs.lookups[lk_idx]
                    zi = entry["lookups"] + 3 * lk_idx
                    z, a_prime, s_prime = vecs[zi], vecs[zi + 1], vecs[zi + 2]
                    if kind == "lk_l0":
                        return vecs[IDX_L0] * (one - z)
                    if kind == "lk_llast":
                        return vecs[IDX_LLAST] * (z * z - z)
                    if kind == "lk_prod":
                        def compress(expressions):
                            acc = const_vec(0)
                            for e in expressions:
                                acc = acc * theta_s + eval_expr(e, entry)
                            return acc

                        inp = compress(argument.input_expressions)
                        tab = compress(argument.table_expressions)
                        left = rot(z, 1) * (a_prime + beta_s) * (s_prime + gamma_s)
                        right = z * (inp + beta_s) * (tab + gamma_s)
                        return vecs[IDX_LACT] * (left - right)
                    if kind == "lk_l0_as":
                        return vecs[IDX_L0] * (a_prime - s_prime)
                    assert kind == "lk_as_prev"
                    return (
                        vecs[IDX_LACT]
                        * (a_prime - s_prime)
                        * (a_prime - rot(a_prime, -1))
                    )

                acc: Dict[int, object] = {}
                for gi, kind, proof_idx, aux, cluster in active:
                    v = item_value(kind, proof_idx, aux) * y_pows[N - gi]
                    acc[cluster] = v if acc.get(cluster) is None else acc[cluster] + v
                return acc

            def fold_fn(arrays, coset_x_vals, scal):
                """The eager fold: the walk on FVecs with the field ops."""
                dev = coset_x_vals.device  # the fold runs where its rows lie
                sc = SimpleNamespace(
                    y=FVec(F, scal["y"]), beta=FVec(F, scal["beta"]),
                    gamma=FVec(F, scal["gamma"]), theta=FVec(F, scal["theta"]),
                    ch=[FVec(F, c) for c in scal["ch"]],
                    one=FVec(F, domain.ctx.const(1, dev)),  # (NLIMBS,) scalar 1
                )
                acc = walk({i: FVec(F, arrays[i]) for i in arrays}, FVec(F, coset_x_vals), sc,
                           lambda c: FVec.fill(F, n_rows, c, dev))
                return {c: a.vals for c, a in acc.items()}

            return Fold(F, walk, fold_fn, needed_idx, num_ch), needed_idx

        folds: Dict[int, tuple] = {}

        def fold_for(c_lo: int):
            """make_fold(c_lo), made once per c_lo (its program is recorded at
            its first call on the card, as jax.jit traces at its first call)."""
            if c_lo not in folds:
                folds[c_lo] = make_fold(c_lo)
            return folds[c_lo]

        return SimpleNamespace(poly_list=poly_list, fold_for=fold_for, L=L)

    def _rotation_reach(self):
        """(back, ahead): the most base-domain rows any constraint item reads
        before and after its own row (its queries, the permutation's and the
        lookups' rotations by 1, -1 and the last blinding row)."""
        cs = self.pk.vk.cs
        rotations = {1, -1, -(cs.blinding_factors() + 1)}
        for _column, rotation in cs.advice_queries + cs.fixed_queries + cs.instance_queries:
            rotations.add(rotation.i)
        return max(0, -min(rotations)), max(0, max(rotations))

    def _scalar_inputs(self, challenges, y, beta, gamma, theta, dev=None):
        """The fold's scalar inputs in Montgomery form: rows of one
        (4 + challenges, 16) tensor, sent to `dev` in one copy."""
        dev = self.domain.device if dev is None else dev
        t = self.domain.ctx.consts([y, beta, gamma, theta, *challenges], dev)
        return {"y": t[0], "beta": t[1], "gamma": t[2], "theta": t[3], "ch": list(t[4:])}

    def evaluate_h_parts(
        self,
        advice_polys: List[List[Polynomial]],
        instance_polys: List[List[Polynomial]],
        challenges: List[int],
        y: int,
        beta: int,
        gamma: int,
        theta: int,
        lookups: List[List],
        permutations: List,
    ) -> Polynomial:
        """Cluster-aware part-wise quotient evaluation (reference
        plonk/evaluation.rs:394-975 + domain.rs:314-495).

        The extended domain is walked in m = extended_n/n parts; part i
        holds the evaluations at zeta * ext_omega^i * omega^t, so base-row
        rotations act within a part as plain rolls. Constraints are grouped
        into **clusters** by ceil(log2(degree)) (evaluation.rs:181-216,
        977-988): cluster c's accumulator only needs 2^c of the m parts
        (`need_to_compute`, evaluation.rs:426-428), so low-degree
        constraints are evaluated on proportionally fewer parts, and only
        the columns a firing cluster references are coset-extended for that
        part. Each constraint item carries the explicit y-power of its
        position in the verifier's global fold order, which makes the
        cluster-merged result (lagrange_vecs_to_extended, domain.rs:433-495)
        exactly equal - and therefore proof-byte equal - to the plain
        y-Horner fold."""
        domain = self.domain
        F = self.field
        p = F.MODULUS
        n = domain.n
        m = domain.extended_n >> domain.k
        mach = self._fold_machinery(
            advice_polys, instance_polys, challenges, lookups, permutations,
            n_rows=n, rot_scale=1,
        )
        L = mach.L
        scal = self._scalar_inputs(challenges, y, beta, gamma, theta)
        ctx = domain.ctx

        pw = powers(domain.omega, n, ctx, domain.device)
        zero_part = Polynomial(LAGRANGE, FVec.zeros(F, n, domain.device))
        value_part_clusters: List[List[Polynomial]] = [
            [zero_part] * (1 << c) for c in range(L + 1)
        ]
        factor = 1
        for part_idx in range(m):
            # need_to_compute(part, c) <=> part % (m >> c) == 0
            # <=> c >= L - v2(part); part 0 fires every cluster
            c_lo = 0 if part_idx == 0 else L - (part_idx & -part_idx).bit_length() + 1
            fold, needed_idx = mach.fold_for(c_lo)
            arrays = {
                i: domain.coeff_to_extended_part(mach.poly_list[i].copy(), factor).vec.vals
                for i in needed_idx
            }
            shift = domain.g_coset * factor % p
            coset_x_vals = ctx.mul(pw, ctx.const(shift, domain.device))
            out = fold(arrays, coset_x_vals, scal)
            for c, vals in out.items():
                value_part_clusters[c][part_idx >> (L - c)] = Polynomial(
                    LAGRANGE, FVec(F, vals)
                )
            factor = factor * domain.extended_omega % p

        return domain.lagrange_vecs_to_extended(value_part_clusters)

    def evaluate_h_mesh(
        self,
        advice_polys: List[List[Polynomial]],
        instance_polys: List[List[Polynomial]],
        challenges: List[int],
        y: int,
        beta: int,
        gamma: int,
        theta: int,
        lookups: List[List],
        permutations: List,
    ) -> Polynomial:
        """The row-sharded quotient fold (the JAX package's SPMD fold,
        `halo2_tpu/plonk/evaluation.py:495-544`).

        Every column the constraints use is coset-extended over the whole
        extended domain (under an active mesh by the four-step NTT that
        `get_plan` returns) and cut into D row blocks, block i on the mesh's
        device i together with the halo rows that its rotations reach on
        either side. Each shard runs the part-wise engine's fold of every
        constraint item on its rows (rotations scaled to the extended
        domain), keeps its block and sends it to the domain's device, where
        the blocks make the quotient's extended evaluations. With no active
        mesh (EVAL_H=mesh alone) the fold runs as one shard on the domain's
        device. Exact integer arithmetic gives the single-device values, so
        the proof bytes are unchanged."""
        from ..parallel.context import CALLS, active_mesh

        CALLS["evaluate_h_mesh"] += 1
        domain = self.domain
        F = self.field
        ctx = domain.ctx
        ext_n = domain.extended_n
        m = ext_n >> domain.k
        mc = active_mesh()
        devices = mc.mesh.devices if mc is not None else (domain.device,)
        D = len(devices)
        block = ext_n // D
        lo, hi = (r * m for r in self._rotation_reach()) if D > 1 else (0, 0)
        mach = self._fold_machinery(
            advice_polys, instance_polys, challenges, lookups, permutations,
            n_rows=block + lo + hi, rot_scale=m,
        )
        fold, needed_idx = mach.fold_for(0)
        ext = {i: domain.coeff_to_extended(mach.poly_list[i].copy()).vec.vals for i in needed_idx}
        pw = powers(domain.extended_omega, ext_n, ctx, domain.device)
        coset_x = ctx.mul(pw, ctx.const(domain.g_coset, domain.device))
        blocks = []
        for i, dev in enumerate(devices):
            rows = (torch.arange(i * block - lo, (i + 1) * block + hi, device=domain.device)
                    % ext_n)
            out = fold({c: v[rows].to(dev) for c, v in ext.items()}, coset_x[rows].to(dev),
                       self._scalar_inputs(challenges, y, beta, gamma, theta, dev))
            h = None
            for c in sorted(out):
                h = out[c] if h is None else ctx.add(h, out[c])
            blocks.append(h[lo:lo + block].to(domain.device))
        return Polynomial(EXTENDED, FVec(F, torch.cat(blocks, dim=0)))

    def evaluate_h_full(
        self,
        advice_polys: List[List[Polynomial]],  # per proof, coeff basis
        instance_polys: List[List[Polynomial]],
        challenges: List[int],
        y: int,
        beta: int,
        gamma: int,
        theta: int,
        lookups: List[List],  # per proof: CommittedLookup
        permutations: List,  # per proof: CommittedPermutation (sets)
    ) -> Polynomial:
        """The plain y-Horner fold of every constraint over the whole
        extended coset, every column held there at once."""
        pk = self.pk
        domain = self.domain
        F = self.field
        p = F.MODULUS
        cs = pk.vk.cs
        ext_n = domain.extended_n
        dev = domain.device

        ext_cache: Dict[int, FVec] = {}

        def ext(poly: Polynomial) -> FVec:
            key = id(poly)
            if key not in ext_cache:
                ext_cache[key] = domain.coeff_to_extended(poly.copy()).vec
            return ext_cache[key]

        def rot_ext(vec: FVec, r: int) -> FVec:
            step = (1 << (domain.extended_k - domain.k)) * r
            return vec.rotate(step)

        fixed_ext = [ext(poly) for poly in pk.fixed_polys]
        l0 = ext(pk.l0)
        l_last = ext(pk.l_last)
        l_active = ext(pk.l_active_row)

        # coset point coordinates zeta * ext_omega^i (for the beta*X term)
        pw = powers(domain.extended_omega, ext_n, domain.ctx, dev)
        coset_x = FVec(F, domain.ctx.mul(pw, domain.ctx.const(domain.g_coset, dev)))

        def const_vec(c: int) -> FVec:
            return FVec.fill(F, ext_n, c, dev)

        one = const_vec(1)

        h: Optional[FVec] = None

        def fold(value: FVec):
            nonlocal h
            if h is None:
                h = value
            else:
                h = h * F(y) + value

        def eval_expr(expr: Expression, advice_ext, instance_ext) -> FVec:
            return expr.evaluate(
                constant=lambda c: const_vec(c),
                selector=lambda s: (_ for _ in ()).throw(
                    ValueError("virtual selector in evaluate_h")
                ),
                fixed=lambda q: rot_ext(fixed_ext[q.column_index], q.rotation.i),
                advice=lambda q: rot_ext(advice_ext[q.column_index], q.rotation.i),
                instance=lambda q: rot_ext(instance_ext[q.column_index], q.rotation.i),
                challenge=lambda c: const_vec(challenges[c.index]),
                negated=lambda a: -a,
                sum_=lambda a, b: a + b,
                product=lambda a, b: a * b,
                scaled=lambda a, f: a * F(f),
            )

        blinding = cs.blinding_factors()
        last_rotation = -(blinding + 1)
        chunk_len = pk.vk.cs_degree - 2
        delta = F.DELTA

        for proof_idx in range(len(advice_polys)):
            advice_ext = [ext(poly) for poly in advice_polys[proof_idx]]
            instance_ext = [ext(poly) for poly in instance_polys[proof_idx]]

            # ---- custom gates ----
            for gate in cs.gates:
                for poly in gate.polys:
                    fold(eval_expr(poly, advice_ext, instance_ext))

            # ---- permutation argument ----
            sets = permutations[proof_idx].sets
            if sets:
                z_ext = [ext(s.poly) for s in sets]
                # l_0(X) * (1 - z_0(X))
                fold(l0 * (one - z_ext[0]))
                # l_last(X) * (z_l(X)^2 - z_l(X))
                zl = z_ext[-1]
                fold(l_last * (zl * zl - zl))
                # l_0(X) * (z_i(X) - z_{i-1}(omega^last X))
                for i in range(1, len(sets)):
                    fold(l0 * (z_ext[i] - rot_ext(z_ext[i - 1], last_rotation)))
                # product constraints per chunk
                sigma_ext = [ext(sp) for sp in pk.permutation.polys]
                columns = cs.permutation.columns
                for chunk_index in range(len(sets)):
                    cols = columns[chunk_index * chunk_len:(chunk_index + 1) * chunk_len]
                    sigmas = sigma_ext[chunk_index * chunk_len:(chunk_index + 1) * chunk_len]
                    left = rot_ext(z_ext[chunk_index], 1)
                    for col, sigma in zip(cols, sigmas):
                        cv = self._column_ext(col, fixed_ext, advice_ext, instance_ext)
                        left = left * (cv + sigma * F(beta) + F(gamma))
                    right = z_ext[chunk_index]
                    cur = beta * pow(delta, chunk_index * chunk_len, p) % p
                    for col in cols:
                        cv = self._column_ext(col, fixed_ext, advice_ext, instance_ext)
                        right = right * (cv + coset_x * F(cur) + F(gamma))
                        cur = cur * delta % p
                    fold(l_active * (left - right))

            # ---- lookups ----
            for lk_idx, committed in enumerate(lookups[proof_idx]):
                argument = cs.lookups[lk_idx]
                z = ext(committed.product_poly)
                a_prime = ext(committed.permuted_input_poly)
                s_prime = ext(committed.permuted_table_poly)
                fold(l0 * (one - z))
                fold(l_last * (z * z - z))

                def compress(expressions):
                    acc = const_vec(0)
                    for e in expressions:
                        acc = acc * F(theta) + eval_expr(e, advice_ext, instance_ext)
                    return acc

                inp = compress(argument.input_expressions)
                tab = compress(argument.table_expressions)
                left = rot_ext(z, 1) * (a_prime + F(beta)) * (s_prime + F(gamma))
                right = z * (inp + F(beta)) * (tab + F(gamma))
                fold(l_active * (left - right))
                fold(l0 * (a_prime - s_prime))
                fold(l_active * (a_prime - s_prime) * (a_prime - rot_ext(a_prime, -1)))

        assert h is not None, "no constraints to evaluate"
        return Polynomial(EXTENDED, h)

    def _column_ext(self, column, fixed_ext, advice_ext, instance_ext) -> FVec:
        if column.kind == FIXED:
            return fixed_ext[column.index]
        if column.kind == ADVICE:
            return advice_ext[column.index]
        return instance_ext[column.index]
