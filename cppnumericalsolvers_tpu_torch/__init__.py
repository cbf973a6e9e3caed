"""cppnumericalsolvers_tpu_torch -- the PyTorch/CUDA port of
cppnumericalsolvers_tpu for NVIDIA Hopper GPUs.

Same surface and names as the JAX package for what is ported: objectives,
the stopping machine, L-BFGS with the More-Thuente search, and the batched
drivers.  Plain code is PyTorch; the hot kernel of the batched solve
(ops/csrc/flat_trip.cu) is CUDA C++ built at first use.  Entry points run
on the card unless the caller passes ``device="cpu"``.
"""

from .core import (
    CONVERGED_STATUSES,
    DifferentiabilityMode,
    FunctionState,
    MinimizeResult,
    Objective,
    ProgressState,
    SolverBase,
    Status,
    StoppingCriteria,
    conservative_stopping,
    constant,
    default_stopping,
    init_progress,
    max_zero,
    min_zero,
    minimize,
    minimize_batched,
    objective,
    status_message,
)
from . import linesearch, models, ops, solvers
from .solvers import Lbfgs

__version__ = "0.1.0"

__all__ = [
    "CONVERGED_STATUSES",
    "DifferentiabilityMode",
    "FunctionState",
    "Lbfgs",
    "MinimizeResult",
    "Objective",
    "ProgressState",
    "SolverBase",
    "Status",
    "StoppingCriteria",
    "conservative_stopping",
    "constant",
    "default_stopping",
    "init_progress",
    "linesearch",
    "max_zero",
    "min_zero",
    "minimize",
    "minimize_batched",
    "models",
    "objective",
    "ops",
    "solvers",
    "status_message",
]
