"""Constrained optimization problems.

PyTorch counterpart of ``cppnumericalsolvers_tpu/core/problem.py`` (the
reference's ``ConstrainedOptimizationProblem``,
include/cppoptlib/function_problem.h:54-103): an objective plus tuples of
equality constraints ``c(x) = 0`` and inequality constraints ``c(x) >= 0``,
each a scalar :class:`Objective`.  The stacked evaluations take one ``(n,)``
point, as an objective's ``fn`` does; batched callers vmap them.
"""

from __future__ import annotations

import dataclasses

import torch

from .objective import Objective

__all__ = ["ConstrainedProblem"]

_ORDER = {"none": 0, "first": 1, "second": 2}


@dataclasses.dataclass(frozen=True)
class ConstrainedProblem:
    objective: Objective
    equality_constraints: tuple[Objective, ...] = ()
    inequality_constraints: tuple[Objective, ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self, "equality_constraints", tuple(self.equality_constraints))
        object.__setattr__(
            self, "inequality_constraints",
            tuple(self.inequality_constraints))

    @property
    def num_equalities(self) -> int:
        return len(self.equality_constraints)

    @property
    def num_inequalities(self) -> int:
        return len(self.inequality_constraints)

    @property
    def has_general_constraints(self) -> bool:
        return bool(self.equality_constraints or self.inequality_constraints)

    @property
    def mode(self) -> str:
        """The lowest differentiability mode of its functions."""
        modes = [self.objective.mode]
        modes += [c.mode for c in self.equality_constraints]
        modes += [c.mode for c in self.inequality_constraints]
        return min(modes, key=lambda m: _ORDER[m])

    def eval_equalities(self, x: torch.Tensor) -> torch.Tensor:
        """Stacked equality residuals ``c_eq(x)``, shape (num_equalities,)."""
        return _stack(self.equality_constraints, x)

    def eval_inequalities(self, x: torch.Tensor) -> torch.Tensor:
        """Stacked inequality values ``c_ineq(x)`` (feasible when >= 0)."""
        return _stack(self.inequality_constraints, x)


def _stack(constraints, x):
    if not constraints:
        return torch.zeros((0,), dtype=x.dtype, device=x.device)
    return torch.stack([c.fn(x) for c in constraints])
