"""cppnumericalsolvers_tpu_torch -- the PyTorch/CUDA port of
cppnumericalsolvers_tpu for NVIDIA Hopper GPUs.

Same surface and names as the JAX package for what is ported: objectives,
the stopping machine, the three line searches (More-Thuente, Hager-Zhang,
Armijo), the seven unconstrained solvers (L-BFGS, gradient descent,
conjugate gradient, BFGS, Newton, trust-region Newton, Nelder-Mead),
L-BFGS-B, the constrained layer (``ConstrainedProblem``, the penalty and
augmented-Lagrangian composites, ``AugmentedLagrangian``), the
finite-difference checkers (``utils``), the drivers (``minimize``,
``minimize_batched`` with warm start and trace, ``resume``, the
Hessian-condition criterion), and the multi-device solves (``parallel``:
the batch split over ranks, or each instance's n over a model axis, on
``torch.distributed``).  Plain code is PyTorch; the kernels of the
batched solves (ops/csrc/*.cu: flat_trip, mt_trip, lbfgs_prologue,
lbfgs_prologue_t, lbfgs_epilogue, push_two_loop, two_loop) are CUDA C++
built at first use.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""

from .core import (
    CONVERGED_STATUSES,
    ConstrainedProblem,
    MultiplierState,
    augmented_lagrangian_value,
    lagrangian_gradient,
    to_augmented_lagrangian,
    to_penalty,
    DifferentiabilityMode,
    FunctionState,
    IterationTrace,
    MinimizeResult,
    Objective,
    ProgressState,
    SolverBase,
    SpanRecorder,
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
    print_progress,
    record_spans,
    resume,
    status_message,
)
from . import linesearch, models, ops, parallel, solvers, utils
from .solvers import (
    AugmentedLagrangian,
    Bfgs,
    ConjugateGradientDescent,
    GradientDescent,
    Lbfgs,
    Lbfgsb,
    NelderMead,
    NewtonDescent,
    TrustRegionNewton,
)

__version__ = "0.1.0"

__all__ = [
    "AugmentedLagrangian",
    "Bfgs",
    "CONVERGED_STATUSES",
    "ConjugateGradientDescent",
    "ConstrainedProblem",
    "DifferentiabilityMode",
    "FunctionState",
    "GradientDescent",
    "IterationTrace",
    "Lbfgs",
    "Lbfgsb",
    "MinimizeResult",
    "MultiplierState",
    "NelderMead",
    "NewtonDescent",
    "Objective",
    "ProgressState",
    "SolverBase",
    "SpanRecorder",
    "Status",
    "StoppingCriteria",
    "TrustRegionNewton",
    "augmented_lagrangian_value",
    "conservative_stopping",
    "constant",
    "default_stopping",
    "init_progress",
    "lagrangian_gradient",
    "linesearch",
    "max_zero",
    "min_zero",
    "minimize",
    "minimize_batched",
    "models",
    "objective",
    "ops",
    "parallel",
    "print_progress",
    "record_spans",
    "resume",
    "solvers",
    "status_message",
    "to_augmented_lagrangian",
    "to_penalty",
    "utils",
]
