"""Steepest descent with a pluggable line search, batched.

PyTorch counterpart of ``cppnumericalsolvers_tpu/solvers/gradient_descent.py``
(the reference's GradientDescent, include/cppoptlib/solver/
gradient_descent.h:37-74): each step is one line search along ``-g``, by
default More-Thuente, whose trips run the ``mt_trip`` kernel on the card.
No solver internals.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.driver import SolverBase
from ..core.objective import FunctionState, Objective
from ..core.progress import StoppingCriteria
from ..linesearch.dispatch import run_line_search
from ..linesearch.more_thuente import DEFAULT_MAX_FEV

__all__ = ["GradientDescent"]


@dataclasses.dataclass(frozen=True)
class GradientDescent(SolverBase):
    max_linesearch_fev: int = DEFAULT_MAX_FEV
    #: Pluggable search (the reference's LineSearch template parameter,
    #: gradient_descent.h:37-38): more_thuente | hager_zhang | armijo.
    line_search: str = "more_thuente"

    def init_batched(self, objective: Objective, state: FunctionState):
        return ()

    def step(
        self,
        objective: Objective,
        state: FunctionState,
        internals,
        stopping: StoppingCriteria,
    ):
        del stopping
        ls = run_line_search(
            self.line_search,
            objective.batched_value_and_grad,
            state.x,
            state.value,
            state.gradient,
            -state.gradient,
            alpha_init=torch.ones_like(state.value),
            max_fev=self.max_linesearch_fev,
            batched_value=objective.batched_value,
        )
        next_state = FunctionState(
            x=ls.x, value=ls.f, gradient=ls.g, nfev=state.nfev + ls.nfev
        )
        return next_state, internals, ls.trips
