"""Penalty and augmented-Lagrangian composite builders.

PyTorch counterpart of ``cppnumericalsolvers_tpu/core/penalty.py`` (the
reference's include/cppoptlib/function_penalty.h:40-246).  Each composite is
one scalar function of ``x`` whose gradient comes from ``torch.func``.  The
inequality part is the Powell-Hestenes-Rockafellar (PHR) form

    I_j(x) = (1 / (2 rho)) * [ max(0, mu_j - rho g_j(x))^2 - mu_j^2 ]

(function_penalty.h:129-194): constant with zero gradient on the strictly
inactive side, C^1 across the switching surface.

Multipliers and penalty are one instance's (``(num_eq,)``, ``(num_ineq,)``,
a scalar) or a batch's (``(B, num_eq)``, ``(B, num_ineq)``, ``(B,)``).  A
batch's composite is a :class:`~.objective.LaneObjective`, so each lane is
evaluated with its own multipliers and penalty.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import grad, vmap

from .objective import LaneObjective, Objective
from .problem import ConstrainedProblem

__all__ = [
    "MultiplierState",
    "quadratic_equality_penalty",
    "quadratic_inequality_penalty_ge",
    "quadratic_inequality_penalty_lt",
    "augmented_lagrangian_value",
    "to_augmented_lagrangian",
    "penalty_value",
    "to_penalty",
    "lagrangian_gradient",
]


@dataclasses.dataclass
class MultiplierState:
    """Lagrange multipliers (function_penalty.h:64-78) as fixed-length
    tensors, with any leading batch dimensions."""

    equality: torch.Tensor  # (..., num_eq) lambda
    inequality: torch.Tensor  # (..., num_ineq) mu >= 0

    @staticmethod
    def zeros(num_eq: int, num_ineq: int, dtype=torch.float64,
              batch_shape=(), device="cpu") -> "MultiplierState":
        shape = tuple(batch_shape)
        return MultiplierState(
            equality=torch.zeros(shape + (num_eq,), dtype=dtype,
                                 device=device),
            inequality=torch.zeros(shape + (num_ineq,), dtype=dtype,
                                   device=device),
        )


def _zero(v):
    return torch.zeros_like(v)


def quadratic_equality_penalty(c: Objective) -> Objective:
    """P(x) = 0.5 c(x)^2 (function_penalty.h:40-43)."""
    return Objective(lambda x, fn=c.fn: 0.5 * fn(x) ** 2, c.mode)


def quadratic_inequality_penalty_ge(c: Objective) -> Objective:
    """P(x) = 0.5 min(0, c(x))^2 for c(x) >= 0 (function_penalty.h:48-52)."""
    def fn(x, f=c.fn):
        v = f(x)
        return 0.5 * torch.minimum(_zero(v), v) ** 2

    return Objective(fn, c.mode)


def quadratic_inequality_penalty_lt(c: Objective) -> Objective:
    """P(x) = 0.5 max(0, c(x))^2 for c(x) < 0 (function_penalty.h:57-61)."""
    def fn(x, f=c.fn):
        v = f(x)
        return 0.5 * torch.maximum(_zero(v), v) ** 2

    return Objective(fn, c.mode)


def _as_scalar(value, x):
    if isinstance(value, torch.Tensor):
        return value
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def augmented_lagrangian_value(problem: ConstrainedProblem, x,
                               multipliers: MultiplierState, penalty):
    """L_aug(x) = f + sum(lambda c) + 0.5 rho sum(c^2) + PHR(mu, rho, g)
    (function_penalty.h:221-246), for one instance."""
    value = problem.objective.fn(x)
    penalty = _as_scalar(penalty, x)
    if problem.num_equalities:
        c_eq = problem.eval_equalities(x)
        value = value + torch.sum(multipliers.equality * c_eq)
        value = value + 0.5 * penalty * torch.sum(c_eq * c_eq)
    if problem.num_inequalities:
        g = problem.eval_inequalities(x)
        mu = multipliers.inequality
        # rho <= 0 makes PHR ill-defined; the reference returns a zero
        # inequality part then (function_penalty.h:161-169).
        rho_ok = penalty > 0
        safe_rho = torch.where(rho_ok, penalty, torch.ones_like(penalty))
        arg = mu - safe_rho * g
        positive_part = torch.maximum(_zero(arg), arg)
        half_inv_rho = 1.0 / (2.0 * safe_rho)
        phr = torch.sum(half_inv_rho * (positive_part ** 2 - mu ** 2))
        value = value + torch.where(rho_ok, phr, _zero(phr))
    return value


def to_augmented_lagrangian(problem: ConstrainedProblem,
                            multipliers: MultiplierState,
                            penalty) -> Objective:
    """The AL composite, the inner solver's subproblem: an
    :class:`Objective` for one instance's multipliers and penalty, a
    :class:`LaneObjective` for a batch's (``penalty`` of shape ``(B,)``)."""
    if isinstance(penalty, torch.Tensor) and penalty.dim() == 1:
        return LaneObjective(
            lambda x, lam, mu, rho: augmented_lagrangian_value(
                problem, x, MultiplierState(lam, mu), rho),
            problem.mode,
            (multipliers.equality, multipliers.inequality, penalty),
        )
    return Objective(
        lambda x: augmented_lagrangian_value(problem, x, multipliers,
                                             penalty),
        problem.mode,
    )


def penalty_value(problem: ConstrainedProblem, x, penalty):
    """Pure penalty composite, no multipliers (function_penalty.h:196-220);
    kept for penalty-method experiments, not used by AugmentedLagrangian."""
    value = problem.objective.fn(x)
    penalty = _as_scalar(penalty, x)
    if problem.num_equalities:
        c_eq = problem.eval_equalities(x)
        value = value + penalty * torch.sum(0.5 * c_eq * c_eq)
    if problem.num_inequalities:
        g = problem.eval_inequalities(x)
        value = value + penalty * torch.sum(
            0.5 * torch.minimum(_zero(g), g) ** 2)
    return value


def to_penalty(problem: ConstrainedProblem, penalty) -> Objective:
    return Objective(lambda x: penalty_value(problem, x, penalty),
                     problem.mode)


def _lagrangian(problem, z, lam, mu):
    """The raw Lagrangian L = f + sum(lambda c) - sum(mu g)."""
    value = problem.objective.fn(z)
    if problem.num_equalities:
        value = value + torch.sum(lam * problem.eval_equalities(z))
    if problem.num_inequalities:
        value = value - torch.sum(mu * problem.eval_inequalities(z))
    return value


def lagrangian_gradient(problem: ConstrainedProblem, x,
                        multipliers: MultiplierState) -> torch.Tensor:
    """grad_x of the raw Lagrangian (augmented_lagrangian.h:577-604), the KKT
    stationarity measure: at one ``(n,)`` point, or at every row of a ``(B,
    n)`` batch with its lane's multipliers."""
    g = grad(lambda z, lam, mu: _lagrangian(problem, z, lam, mu))
    if x.dim() == 2:
        g = vmap(g)
    return g(x, multipliers.equality, multipliers.inequality)
