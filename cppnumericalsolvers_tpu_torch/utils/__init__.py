"""Helpers shared by the port's solvers and drivers, and the
finite-difference checkers."""

from .derivatives import (
    compute_finite_gradient,
    compute_finite_hessian,
    is_gradient_correct,
    is_hessian_correct,
)
from .linalg import (
    condition_test_enabled,
    frobenius_condition,
    invert_small,
    solve_small,
)

__all__ = [
    "compute_finite_gradient",
    "compute_finite_hessian",
    "condition_test_enabled",
    "frobenius_condition",
    "invert_small",
    "is_gradient_correct",
    "is_hessian_correct",
    "solve_small",
]
