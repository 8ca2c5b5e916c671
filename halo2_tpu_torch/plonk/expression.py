"""Circuit IR primitives: columns, selectors, challenges, and the
Expression AST.

Mirrors the arithmetization IR of `halo2_proofs/src/plonk/circuit.rs`:
column types with consensus-critical ordering (:157-265), multi-phase advice
and challenges (:98-154, :588-608), simple/complex selectors (:457-480),
query structs (:484-554), and the `Expression` AST with evaluate/degree
helpers (:797-1320).

Expressions are built by user circuits at configure time and later compiled
to batched device programs by `halo2_tpu_torch.plonk.evaluation` (the reference's
GraphEvaluator role).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Union

from ..fields import FieldElement
from ..poly import Rotation

FIXED = "fixed"
ADVICE = "advice"
INSTANCE = "instance"

# Phases (reference circuit.rs:98-131)
FIRST_PHASE = 0
SECOND_PHASE = 1
THIRD_PHASE = 2


@dataclass(frozen=True)
class Column:
    """A typed column. `phase` is meaningful only for advice columns."""

    kind: str
    index: int
    phase: int = 0

    def _order_key(self):
        # Consensus-critical Column<Any> ordering (circuit.rs:220-265):
        # Instance < Advice < Fixed, then by index (and phase for advice).
        kind_order = {INSTANCE: 0, ADVICE: 1, FIXED: 2}[self.kind]
        return (kind_order, self.index, self.phase)

    def __lt__(self, other: "Column"):
        return self._order_key() < other._order_key()

    def __repr__(self):
        if self.kind == ADVICE and self.phase:
            return f"Column({self.kind}[{self.index}]@{self.phase})"
        return f"Column({self.kind}[{self.index}])"


@dataclass(frozen=True)
class Selector:
    """A virtual selector; `simple` selectors participate in compression
    (circuit.rs:457-480)."""

    index: int
    simple: bool

    def enable(self, region, offset: int):
        region.enable_selector(self, offset)

    def expr(self) -> "Expression":
        return SelectorExpr(self)


@dataclass(frozen=True)
class Challenge:
    """A multi-phase challenge usable after `phase` (circuit.rs:588-608)."""

    index: int
    phase: int

    def expr(self) -> "Expression":
        return ChallengeExpr(self)


@dataclass(frozen=True)
class TableColumn:
    """A fixed column constrained to be used only in lookup tables
    (circuit.rs:569)."""

    inner: Column


# ---------------------------------------------------------------------------
# Expression AST
# ---------------------------------------------------------------------------


class Expression:
    """Low-degree expression over columns, selectors, and challenges."""

    # -- operator sugar --
    def __add__(self, other):
        return Sum(self, _coerce(other))

    def __radd__(self, other):
        return Sum(_coerce(other), self)

    def __sub__(self, other):
        return Sum(self, Negated(_coerce(other)))

    def __rsub__(self, other):
        return Sum(_coerce(other), Negated(self))

    def __mul__(self, other):
        other = _coerce(other)
        return Product(self, other)

    def __rmul__(self, other):
        return Product(_coerce(other), self)

    def __neg__(self):
        return Negated(self)

    # -- structural recursion (reference Expression::evaluate) --
    def evaluate(
        self,
        constant: Callable,
        selector: Callable,
        fixed: Callable,
        advice: Callable,
        instance: Callable,
        challenge: Callable,
        negated: Callable,
        sum_: Callable,
        product: Callable,
        scaled: Callable,
    ):
        raise NotImplementedError

    def degree(self) -> int:
        raise NotImplementedError

    def extract_simple_selector(self) -> Optional[Selector]:
        """The unique simple selector in this expression, if any
        (used for selector compression; product of two raises)."""

        def op(a, b):
            if a is not None and b is not None:
                raise ValueError("two simple selectors cannot be in the same expression")
            return a if a is not None else b

        return self.evaluate(
            constant=lambda _: None,
            selector=lambda s: s if s.simple else None,
            fixed=lambda q: None,
            advice=lambda q: None,
            instance=lambda q: None,
            challenge=lambda c: None,
            negated=lambda a: a,
            sum_=op,
            product=op,
            scaled=lambda a, f: a,
        )

    def identifier(self) -> str:
        raise NotImplementedError

    def __repr__(self):
        return self.identifier()


def _coerce(v) -> Expression:
    if isinstance(v, Expression):
        return v
    if isinstance(v, FieldElement):
        return Constant(v.v)
    if isinstance(v, int):
        return Constant(v)
    raise TypeError(f"cannot use {type(v)} in an Expression")


@dataclass(frozen=True)
class Constant(Expression):
    value: int

    def evaluate(self, constant, selector, fixed, advice, instance, challenge, negated, sum_, product, scaled):
        return constant(self.value)

    def degree(self):
        return 0

    def identifier(self):
        return f"0x{self.value:x}"


@dataclass(frozen=True)
class SelectorExpr(Expression):
    selector: Selector

    def evaluate(self, constant, selector, fixed, advice, instance, challenge, negated, sum_, product, scaled):
        return selector(self.selector)

    def degree(self):
        return 1

    def identifier(self):
        return f"selector[{self.selector.index}]"


@dataclass(frozen=True)
class FixedQuery(Expression):
    query_index: Optional[int]
    column_index: int
    rotation: Rotation

    def evaluate(self, constant, selector, fixed, advice, instance, challenge, negated, sum_, product, scaled):
        return fixed(self)

    def degree(self):
        return 1

    def identifier(self):
        return f"fixed[{self.column_index}][{self.rotation.i}]"


@dataclass(frozen=True)
class AdviceQuery(Expression):
    query_index: Optional[int]
    column_index: int
    rotation: Rotation
    phase: int = 0

    def evaluate(self, constant, selector, fixed, advice, instance, challenge, negated, sum_, product, scaled):
        return advice(self)

    def degree(self):
        return 1

    def identifier(self):
        return f"advice[{self.column_index}][{self.rotation.i}]"


@dataclass(frozen=True)
class InstanceQuery(Expression):
    query_index: Optional[int]
    column_index: int
    rotation: Rotation

    def evaluate(self, constant, selector, fixed, advice, instance, challenge, negated, sum_, product, scaled):
        return instance(self)

    def degree(self):
        return 1

    def identifier(self):
        return f"instance[{self.column_index}][{self.rotation.i}]"


@dataclass(frozen=True)
class ChallengeExpr(Expression):
    challenge: Challenge

    def evaluate(self, constant, selector, fixed, advice, instance, challenge, negated, sum_, product, scaled):
        return challenge(self.challenge)

    def degree(self):
        return 0

    def identifier(self):
        return f"challenge[{self.challenge.index}]"


@dataclass(frozen=True)
class Negated(Expression):
    a: Expression

    def evaluate(self, constant, selector, fixed, advice, instance, challenge, negated, sum_, product, scaled):
        v = self.a.evaluate(constant, selector, fixed, advice, instance, challenge, negated, sum_, product, scaled)
        return negated(v)

    def degree(self):
        return self.a.degree()

    def identifier(self):
        return f"(-{self.a.identifier()})"


@dataclass(frozen=True)
class Sum(Expression):
    a: Expression
    b: Expression

    def evaluate(self, constant, selector, fixed, advice, instance, challenge, negated, sum_, product, scaled):
        va = self.a.evaluate(constant, selector, fixed, advice, instance, challenge, negated, sum_, product, scaled)
        vb = self.b.evaluate(constant, selector, fixed, advice, instance, challenge, negated, sum_, product, scaled)
        return sum_(va, vb)

    def degree(self):
        return max(self.a.degree(), self.b.degree())

    def identifier(self):
        return f"({self.a.identifier()}+{self.b.identifier()})"


@dataclass(frozen=True)
class Product(Expression):
    a: Expression
    b: Expression

    def evaluate(self, constant, selector, fixed, advice, instance, challenge, negated, sum_, product, scaled):
        va = self.a.evaluate(constant, selector, fixed, advice, instance, challenge, negated, sum_, product, scaled)
        vb = self.b.evaluate(constant, selector, fixed, advice, instance, challenge, negated, sum_, product, scaled)
        return product(va, vb)

    def degree(self):
        return self.a.degree() + self.b.degree()

    def identifier(self):
        return f"({self.a.identifier()}*{self.b.identifier()})"


@dataclass(frozen=True)
class Scaled(Expression):
    a: Expression
    f: int

    def evaluate(self, constant, selector, fixed, advice, instance, challenge, negated, sum_, product, scaled):
        va = self.a.evaluate(constant, selector, fixed, advice, instance, challenge, negated, sum_, product, scaled)
        return scaled(va, self.f)

    def degree(self):
        return self.a.degree()

    def identifier(self):
        return f"{self.f:x}*{self.a.identifier()}"


def eval_expression_host(
    expr: Expression,
    p: int,
    fixed_fn: Callable,
    advice_fn: Callable,
    instance_fn: Callable,
    challenge_fn: Callable,
    selector_fn: Callable = None,
) -> int:
    """Evaluate an expression to a host int (used by MockProver/verifier)."""
    return expr.evaluate(
        constant=lambda c: c % p,
        selector=selector_fn or (lambda s: (_ for _ in ()).throw(ValueError("virtual selector in evaluation"))),
        fixed=fixed_fn,
        advice=advice_fn,
        instance=instance_fn,
        challenge=challenge_fn,
        negated=lambda a: (-a) % p,
        sum_=lambda a, b: (a + b) % p,
        product=lambda a, b: (a * b) % p,
        scaled=lambda a, f: (a * f) % p,
    )
