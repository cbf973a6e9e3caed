"""Dense BFGS with inverse-Hessian updates, batched.

PyTorch counterpart of ``cppnumericalsolvers_tpu/solvers/bfgs.py`` (the
reference's Bfgs, include/cppoptlib/solver/bfgs.h:39-145).  The ``(B, n,
n)`` inverse Hessians ride in the internals; the direction and the rank-2
update are batched ``torch`` matrix products, as they are XLA's in the JAX
package.  The default More-Thuente search runs the ``mt_trip`` kernel on the
card.  Guards preserved:

* reset to identity and steepest descent when the approximation loses
  positive definiteness or turns NaN (bfgs.h:84-92);
* fresh-approximation step scaling ``alpha0 = 1/|d|``, else 1
  (bfgs.h:94-106);
* curvature-gated update ``y.s > eps |s||y|`` skipping degenerate pairs
  (bfgs.h:114-134).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.driver import SolverBase
from ..core.objective import FunctionState, Objective
from ..core.progress import StoppingCriteria
from ..linesearch.dispatch import run_line_search
from ..linesearch.more_thuente import DEFAULT_MAX_FEV

__all__ = ["Bfgs", "BfgsInternals"]


@dataclasses.dataclass
class BfgsInternals:
    inverse_hessian: torch.Tensor  # (B, n, n)
    fresh: torch.Tensor  # (B,) bool: identity approximation (scales alpha0)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _matvec(h, v):
    return torch.matmul(h, v[..., None])[..., 0]


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


@dataclasses.dataclass(frozen=True)
class Bfgs(SolverBase):
    max_linesearch_fev: int = DEFAULT_MAX_FEV
    #: Pluggable search (bfgs.h:39-40): more_thuente | hager_zhang | armijo.
    line_search: str = "more_thuente"

    def init_batched(self, objective: Objective,
                     state: FunctionState) -> BfgsInternals:
        b, n = state.x.shape
        eye = torch.eye(n, dtype=state.x.dtype, device=state.x.device)
        return BfgsInternals(
            inverse_hessian=eye.expand(b, n, n).clone(),
            fresh=torch.ones((b,), dtype=torch.bool, device=state.x.device),
        )

    def step(
        self,
        objective: Objective,
        state: FunctionState,
        internals: BfgsInternals,
        stopping: StoppingCriteria,
    ):
        del stopping
        dtype = state.x.dtype
        eps = torch.finfo(dtype).eps
        n = state.x.shape[-1]
        g = state.gradient
        eye = torch.eye(n, dtype=dtype, device=state.x.device)

        direction = -_matvec(internals.inverse_hessian, g)
        phi = _dot(g, direction)

        # PD/NaN reset (bfgs.h:84-92).
        reset = (phi > 0) | torch.isnan(phi)
        h = torch.where(reset[:, None, None], eye, internals.inverse_hessian)
        direction = torch.where(reset[:, None], -g, direction)
        fresh = internals.fresh | reset

        dnorm = torch.linalg.vector_norm(direction, dim=-1)
        one = torch.ones_like(dnorm)
        alpha_init = torch.where(
            fresh, torch.where(dnorm > eps, 1.0 / dnorm, one), one)

        ls = run_line_search(
            self.line_search,
            objective.batched_value_and_grad,
            state.x,
            state.value,
            g,
            direction,
            alpha_init,
            max_fev=self.max_linesearch_fev,
            batched_value=objective.batched_value,
        )
        next_state = FunctionState(
            x=ls.x, value=ls.f, gradient=ls.g, nfev=state.nfev + ls.nfev
        )

        # Inverse-Hessian update, N&W eqn 6.17, gated on curvature
        # (bfgs.h:114-134).
        s = next_state.x - state.x
        y = next_state.gradient - g
        ys = _dot(y, s)
        norm = torch.linalg.vector_norm
        accept = ys > eps * norm(s, dim=-1) * norm(y, dim=-1)
        rho = (1.0 / torch.where(accept, ys, one))[:, None, None]
        hy = _matvec(h, y)
        yhy = _dot(y, hy)[:, None, None]
        h_updated = (
            h
            - rho * (_outer(s, hy) + _outer(hy, s))
            + rho * (rho * yhy + 1.0) * _outer(s, s)
        )
        return next_state, BfgsInternals(
            inverse_hessian=torch.where(accept[:, None, None], h_updated, h),
            fresh=torch.where(accept, torch.zeros_like(fresh), fresh),
        ), ls.trips
