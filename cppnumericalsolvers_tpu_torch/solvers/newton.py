"""Newton descent with a regularised dense solve, batched.

PyTorch counterpart of ``cppnumericalsolvers_tpu/solvers/newton.py`` (the
reference's NewtonDescent, include/cppoptlib/solver/newton_descent.h:
38-85): the Hessian shifted by ``1e-5 I``, the direction from a batched
dense solve (``torch.linalg.solve_ex``, a library call, as
``jnp.linalg.solve`` is in the JAX package), and the second-order Armijo
search (armijo.h:67-103).  A singular shifted Hessian gives non-finite
directions, as the JAX package's solve does; nothing raises.  No kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.driver import SolverBase
from ..core.objective import FunctionState, Objective
from ..core.progress import StoppingCriteria
from ..linesearch.armijo import armijo
from ..utils.linalg import condition_test_enabled, frobenius_condition

__all__ = ["NewtonDescent", "NewtonInternals"]


@dataclasses.dataclass
class NewtonInternals:
    #: cond(H) at the point the step direction was computed from, for the
    #: HessianConditionViolation test (progress.h:197-208, :318-325): the
    #: step's Hessian is reused (one iteration of lag, no extra evaluation).
    condition_hessian: torch.Tensor  # (B,)


@dataclasses.dataclass(frozen=True)
class NewtonDescent(SolverBase):
    mode: str = dataclasses.field(default="second", init=False, repr=False)
    safe_guard: float = 1e-5  # diagonal shift (newton_descent.h:69)

    def init_batched(self, objective: Objective, state: FunctionState):
        return NewtonInternals(condition_hessian=torch.zeros_like(state.value))

    def step(
        self,
        objective: Objective,
        state: FunctionState,
        internals,
        stopping: StoppingCriteria,
    ):
        n = state.x.shape[-1]
        hessian = objective.hessian(state.x)
        gradient = state.gradient
        shifted = hessian + self.safe_guard * torch.eye(
            n, dtype=state.x.dtype, device=state.x.device)
        delta_x = torch.linalg.solve_ex(shifted, -gradient)[0]

        curvature = torch.sum(
            delta_x * torch.matmul(hessian, delta_x[..., None])[..., 0],
            dim=-1)
        ls = armijo(objective.batched_value, state.x, state.value, gradient,
                    delta_x, alpha_init=1.0, curvature_term=curvature)
        new_x = state.x + ls.alpha[:, None] * delta_x
        value, grad = objective.batched_value_and_grad(new_x)
        # The Hessian evaluation counts as one extra call in the reference's
        # protocol (newton_descent.h:73).
        next_state = FunctionState(
            x=new_x, value=value, gradient=grad,
            nfev=state.nfev + ls.nfev + 2,
        )
        # cond(H) costs an inverse: only when the criterion is on.
        cond_h = (frobenius_condition(hessian)
                  if condition_test_enabled(stopping)
                  else torch.zeros_like(state.value))
        return next_state, NewtonInternals(condition_hessian=cond_h), (
            ls.trips + 1)
