"""Rust-Debug-exact rendering of the pinned verification key.

The reference computes `transcript_repr` by Blake2b-hashing
`format!("{:?}", vk.pinned())` (plonk.rs:301-313); proofs are only
interoperable if this string is reproduced byte-for-byte. This module
reimplements the relevant `std::fmt::Debug` output rules:

  * derived/debug_struct structs: `Name { field: value, .. }`, pretty mode
    breaks each field onto its own line with 4-space indent steps,
  * debug_tuple: `Name(a, b)`, pretty mode one element per line,
  * lists: `[a, b]` / one element per line; empty lists stay `[]`,
  * the fork's manual impls: `Expression` flattens query variants into
    `Advice {{ query_index, column_index, rotation[, phase] }}`
    (circuit.rs:1320-1395), `Advice`/`Any` hide the phase in FirstPhase
    (circuit.rs:184-241), lookup `Argument` shows only the expression
    vectors (lookup.rs:15-22), field elements print as 0x-padded 64-hex,
    affine points as a single-line `(x, y)` tuple.

Validated byte-for-byte against the pinned VK literal in the reference's
tests/plonk_api.rs:625-1005 (pretty mode) — the compact mode feeds
`transcript_repr`.
"""

from __future__ import annotations

from typing import List, Tuple, Union

from .expression import (
    ADVICE,
    FIXED,
    INSTANCE,
    AdviceQuery,
    ChallengeExpr,
    Constant,
    FixedQuery,
    InstanceQuery,
    Negated,
    Product,
    Scaled,
    SelectorExpr,
    Sum,
)

# ---------------------------------------------------------------------------
# Debug-tree nodes
# ---------------------------------------------------------------------------


class Raw:
    """Renders identically in pretty and compact modes (single line)."""

    def __init__(self, s: str):
        self.s = s


class Struct:
    def __init__(self, name: str, fields: List[Tuple[str, "Node"]]):
        self.name = name
        self.fields = fields


class TupleNode:
    """debug_tuple (`Name(..)`) or a bare tuple when name == ''."""

    def __init__(self, name: str, items: List["Node"]):
        self.name = name
        self.items = items


class ListNode:
    def __init__(self, items: List["Node"]):
        self.items = items


Node = Union[Raw, Struct, TupleNode, ListNode]


def render(node: Node, pretty: bool, indent: int = 0) -> str:
    pad = "    " * indent
    pad1 = "    " * (indent + 1)
    if isinstance(node, Raw):
        return node.s
    if isinstance(node, Struct):
        if not node.fields:
            return node.name  # debug_struct with no fields: just the name
        if pretty:
            inner = "".join(
                f"{pad1}{k}: {render(v, True, indent + 1)},\n" for k, v in node.fields
            )
            return f"{node.name} {{\n{inner}{pad}}}"
        inner = ", ".join(f"{k}: {render(v, False)}" for k, v in node.fields)
        return f"{node.name} {{ {inner} }}"
    if isinstance(node, TupleNode):
        if pretty:
            inner = "".join(
                f"{pad1}{render(v, True, indent + 1)},\n" for v in node.items
            )
            return f"{node.name}(\n{inner}{pad})"
        inner = ", ".join(render(v, False) for v in node.items)
        return f"{node.name}({inner})"
    if isinstance(node, ListNode):
        if not node.items:
            return "[]"
        if pretty:
            inner = "".join(
                f"{pad1}{render(v, True, indent + 1)},\n" for v in node.items
            )
            return f"[\n{inner}{pad}]"
        return "[" + ", ".join(render(v, False) for v in node.items) + "]"
    raise TypeError(node)


# ---------------------------------------------------------------------------
# halo2 value renderers
# ---------------------------------------------------------------------------


def fe(v: int) -> Raw:
    """Field element Debug: 0x + zero-padded 64 hex."""
    return Raw(f"0x{v:064x}")


def point(pt) -> Raw:
    """Affine point Debug: single-line (x, y) (halo2curves manual impl)."""
    if pt.is_identity():
        x = y = 0
    else:
        x, y = pt.xy
    return Raw(f"(0x{x:064x}, 0x{y:064x})")


def rotation(r) -> TupleNode:
    return TupleNode("Rotation", [Raw(str(r.i))])


_KIND_NAME = {ADVICE: "Advice", FIXED: "Fixed", INSTANCE: "Instance"}


def column_type(column) -> Struct:
    fields = []
    if column.kind == ADVICE and column.phase != 0:
        fields.append(("phase", TupleNode("Phase", [Raw(str(column.phase))])))
    return Struct(_KIND_NAME[column.kind], fields)


def column(c) -> Struct:
    return Struct("Column", [("index", Raw(str(c.index))),
                             ("column_type", column_type(c))])


def query_tuple(c, r) -> TupleNode:
    return TupleNode("", [column(c), rotation(r)])


def expression(e) -> Node:
    if isinstance(e, Constant):
        return TupleNode("Constant", [fe(e.value)])
    if isinstance(e, SelectorExpr):
        s = e.selector
        return TupleNode("Selector", [TupleNode("Selector", [Raw(str(s.index)), Raw(str(s.simple).lower())])])
    if isinstance(e, FixedQuery):
        return Struct("Fixed", [
            ("query_index", Raw(str(e.query_index))),
            ("column_index", Raw(str(e.column_index))),
            ("rotation", rotation(e.rotation)),
        ])
    if isinstance(e, AdviceQuery):
        fields = [
            ("query_index", Raw(str(e.query_index))),
            ("column_index", Raw(str(e.column_index))),
            ("rotation", rotation(e.rotation)),
        ]
        if e.phase != 0:
            fields.append(("phase", TupleNode("Phase", [Raw(str(e.phase))])))
        return Struct("Advice", fields)
    if isinstance(e, InstanceQuery):
        return Struct("Instance", [
            ("query_index", Raw(str(e.query_index))),
            ("column_index", Raw(str(e.column_index))),
            ("rotation", rotation(e.rotation)),
        ])
    if isinstance(e, ChallengeExpr):
        ch = e.challenge
        return TupleNode("Challenge", [Struct("Challenge", [
            ("index", Raw(str(ch.index))),
            ("phase", TupleNode("Phase", [Raw(str(ch.phase))])),
        ])])
    if isinstance(e, Negated):
        return TupleNode("Negated", [expression(e.a)])
    if isinstance(e, Sum):
        return TupleNode("Sum", [expression(e.a), expression(e.b)])
    if isinstance(e, Product):
        return TupleNode("Product", [expression(e.a), expression(e.b)])
    if isinstance(e, Scaled):
        return TupleNode("Scaled", [expression(e.a), fe(e.f)])
    raise TypeError(e)


def pinned_vk_node(vk) -> Struct:
    """PinnedVerificationKey Debug tree (plonk.rs:361-368)."""
    cs = vk.cs
    cs_fields = [
        ("num_fixed_columns", Raw(str(cs.num_fixed_columns))),
        ("num_advice_columns", Raw(str(cs.num_advice_columns))),
        ("num_instance_columns", Raw(str(cs.num_instance_columns))),
        ("num_selectors", Raw(str(cs.num_selectors))),
    ]
    if cs.num_challenges > 0:
        cs_fields += [
            ("num_challenges", Raw(str(cs.num_challenges))),
            ("advice_column_phase", ListNode(
                [TupleNode("Phase", [Raw(str(p))]) for p in cs.advice_column_phase]
            )),
            ("challenge_phase", ListNode(
                [TupleNode("Phase", [Raw(str(p))]) for p in cs.challenge_phase]
            )),
        ]
    cs_fields += [
        ("gates", ListNode([expression(p) for g in cs.gates for p in g.polys])),
        ("advice_queries", ListNode([query_tuple(c, r) for c, r in cs.advice_queries])),
        ("instance_queries", ListNode([query_tuple(c, r) for c, r in cs.instance_queries])),
        ("fixed_queries", ListNode([query_tuple(c, r) for c, r in cs.fixed_queries])),
        ("permutation", Struct("Argument", [
            ("columns", ListNode([column(c) for c in cs.permutation.columns])),
        ])),
        ("lookups", ListNode([
            Struct("Argument", [
                ("input_expressions", ListNode([expression(e) for e in lk.input_expressions])),
                ("table_expressions", ListNode([expression(e) for e in lk.table_expressions])),
            ])
            for lk in cs.lookups
        ])),
        ("constants", ListNode([column(c) for c in cs.constants])),
        ("minimum_degree", Raw("None" if cs.minimum_degree is None else f"Some({cs.minimum_degree})")),
    ]
    return Struct("PinnedVerificationKey", [
        ("base_modulus", Raw(f'"0x{vk.curve.BASE.MODULUS:064x}"')),
        ("scalar_modulus", Raw(f'"0x{vk.curve.SCALAR.MODULUS:064x}"')),
        ("domain", Struct("PinnedEvaluationDomain", [
            ("k", Raw(str(vk.domain.k))),
            ("extended_k", Raw(str(vk.domain.extended_k))),
            ("omega", fe(vk.domain.omega)),
        ])),
        ("cs", Struct("PinnedConstraintSystem", cs_fields)),
        ("fixed_commitments", ListNode([point(c) for c in vk.fixed_commitments])),
        ("permutation", Struct("VerifyingKey", [
            ("commitments", ListNode([point(c) for c in vk.permutation.commitments])),
        ])),
    ])


def pinned_debug_string(vk, pretty: bool) -> str:
    return render(pinned_vk_node(vk), pretty)
