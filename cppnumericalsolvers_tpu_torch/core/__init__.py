from .driver import MinimizeResult, SolverBase, minimize, minimize_batched
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

__all__ = [
    "CONVERGED_STATUSES",
    "DifferentiabilityMode",
    "FunctionState",
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
    "max_zero",
    "min_zero",
    "minimize",
    "minimize_batched",
    "objective",
    "status_message",
    "update_progress",
]
