"""PLONKish proof system core (reference `halo2_proofs/src/plonk/`)."""

from .assigned import Assigned, batch_invert_assigned
from .constraint_system import ConstraintSystem, Gate, VirtualCells
from .error import (
    BoundsFailure,
    ColumnNotInPermutation,
    ConstraintSystemFailure,
    Error,
    InstanceTooLarge,
    InvalidInstances,
    NotEnoughColumnsForConstants,
    NotEnoughRowsAvailable,
    OpeningError,
    SynthesisError,
    TranscriptIoError,
)
from .expression import (
    ADVICE,
    FIRST_PHASE,
    FIXED,
    INSTANCE,
    SECOND_PHASE,
    THIRD_PHASE,
    AdviceQuery,
    Challenge,
    ChallengeExpr,
    Column,
    Constant,
    Expression,
    FixedQuery,
    InstanceQuery,
    Negated,
    Product,
    Scaled,
    Selector,
    SelectorExpr,
    Sum,
    TableColumn,
)
