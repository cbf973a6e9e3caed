from .callbacks import IterationTrace, init_trace, print_progress, record_trace
from .driver import (
    MinimizeResult,
    SolverBase,
    minimize,
    minimize_batched,
    resume,
)
from .objective import (
    DifferentiabilityMode,
    FunctionState,
    Objective,
    constant,
    max_zero,
    min_zero,
    objective,
)
from .progress import (
    PAST_RING_SIZE,
    ProgressState,
    StoppingCriteria,
    conservative_stopping,
    default_stopping,
    init_progress,
    update_progress,
)
from .status import CONVERGED_STATUSES, Status, status_message
from .tree import tree_where

__all__ = [
    "CONVERGED_STATUSES",
    "DifferentiabilityMode",
    "FunctionState",
    "IterationTrace",
    "MinimizeResult",
    "Objective",
    "PAST_RING_SIZE",
    "ProgressState",
    "SolverBase",
    "Status",
    "StoppingCriteria",
    "conservative_stopping",
    "constant",
    "default_stopping",
    "init_progress",
    "init_trace",
    "max_zero",
    "min_zero",
    "minimize",
    "minimize_batched",
    "objective",
    "print_progress",
    "record_trace",
    "resume",
    "status_message",
    "tree_where",
    "update_progress",
]
