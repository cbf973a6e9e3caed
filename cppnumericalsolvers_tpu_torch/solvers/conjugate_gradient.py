"""Fletcher-Reeves nonlinear conjugate gradient, batched.

PyTorch counterpart of
``cppnumericalsolvers_tpu/solvers/conjugate_gradient.py`` (the reference's
ConjugatedGradientDescent, include/cppoptlib/solver/
conjugated_gradient_descent.h:37-90): ``beta = g.g / g_prev.g_prev``, the
direction reset to ``-g`` on the first iteration, and the Armijo
backtracking search (hard-wired, :81).  The previous gradient and direction
ride in the solver internals.  No kernel: the JAX package leaves it all to
XLA.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.driver import SolverBase
from ..core.objective import FunctionState, Objective
from ..core.progress import StoppingCriteria
from ..core.tree import lane_sum
from ..linesearch.armijo import armijo

__all__ = ["ConjugateGradientDescent", "CgInternals"]


@dataclasses.dataclass
class CgInternals:
    previous_gradient: torch.Tensor  # (B, n)
    direction: torch.Tensor  # (B, n)
    iteration: torch.Tensor  # (B,) int32 (the reference keys the reset on it)


def _dot(a, b):
    # Through core.tree's lane reduction: inside a model-sharded solve the
    # sum over n spans the ranks.
    return lane_sum(a * b)


@dataclasses.dataclass(frozen=True)
class ConjugateGradientDescent(SolverBase):
    def init_batched(self, objective: Objective,
                     state: FunctionState) -> CgInternals:
        return CgInternals(
            previous_gradient=state.gradient.clone(),
            direction=torch.zeros_like(state.x),
            iteration=torch.zeros(state.value.shape, dtype=torch.int32,
                                  device=state.x.device),
        )

    def step(
        self,
        objective: Objective,
        state: FunctionState,
        internals: CgInternals,
        stopping: StoppingCriteria,
    ):
        del stopping
        g = state.gradient
        pg = internals.previous_gradient
        beta = _dot(g, g) / _dot(pg, pg)
        direction = torch.where(
            (internals.iteration == 0)[:, None],
            -g,
            -g + beta[:, None] * internals.direction,
        )
        ls = armijo(objective.batched_value, state.x, state.value, g,
                    direction, alpha_init=1.0)
        new_x = state.x + ls.alpha[:, None] * direction
        # The reference returns an unpopulated state that its Minimize loop
        # re-evaluates (solver.h:210-216); here the rebuild is in the step:
        # one value-and-gradient evaluation.
        value, gradient = objective.batched_value_and_grad(new_x)
        next_state = FunctionState(
            x=new_x, value=value, gradient=gradient,
            nfev=state.nfev + ls.nfev + 1,
        )
        return next_state, CgInternals(
            previous_gradient=g,
            direction=direction,
            iteration=internals.iteration + 1,
        ), ls.trips + 1
