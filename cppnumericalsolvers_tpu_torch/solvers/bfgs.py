"""Dense BFGS with inverse-Hessian updates, batched.

PyTorch counterpart of ``cppnumericalsolvers_tpu/solvers/bfgs.py`` (the
reference's Bfgs, include/cppoptlib/solver/bfgs.h:39-145).  The ``(B, n,
n)`` inverse Hessians ride in the internals; the direction and the rank-2
update are per-lane products (elementwise, summed by
``core.tree.fixed_sum``), XLA's in the JAX package: a batched ``matmul``'s
library picks its algorithm by the batch count, so a lane's bits would
depend on the batch it is solved in.  The default More-Thuente search runs
the ``mt_trip`` kernel on the card.  Guards preserved:

* reset to identity and steepest descent when the approximation loses
  positive definiteness or turns NaN (bfgs.h:84-92);
* fresh-approximation step scaling ``alpha0 = 1/|d|``, else 1
  (bfgs.h:94-106);
* curvature-gated update ``y.s > eps |s||y|`` skipping degenerate pairs
  (bfgs.h:114-134).

Model-sharded (inside ``core.tree.model_axis_group``) each rank holds its
rows of every inverse Hessian, ``(B, n_local, n)``: ``H g`` and ``H y`` are
row-local products of the gathered vector (each row's sum keeps its
unsharded bits), the dot products are partial sums all-reduced
(``core.tree.model_sum``), and the rank-2 update takes ``s`` and ``H y``
whole.  Three ``all_gather``s an iteration (g; y and s; H y) beside the
all-reduces; outside the context every collective is the identity.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.driver import SolverBase
from ..core.objective import FunctionState, Objective
from ..core.progress import StoppingCriteria
from ..core.tree import (
    fixed_sum, lane_matvec, model_gather, model_shard, model_sum,
    model_width)
from ..linesearch.dispatch import run_line_search
from ..linesearch.more_thuente import DEFAULT_MAX_FEV

__all__ = ["Bfgs", "BfgsInternals"]


@dataclasses.dataclass
class BfgsInternals:
    inverse_hessian: torch.Tensor  # (B, n, n); a shard's rows (B, n_local, n)
    fresh: torch.Tensor  # (B,) bool: identity approximation (scales alpha0)


def _dot(a, b):
    return model_sum(fixed_sum(a * b))


def _eye_rows(n_local, like):
    """This rank's rows of the n x n identity (all of it unsharded)."""
    offset = model_shard()[0]
    eye = torch.eye(model_width(n_local), dtype=like.dtype,
                    device=like.device)
    return eye[offset:offset + n_local]


def _norm(a):
    return torch.sqrt(_dot(a, a))


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
        eye = _eye_rows(n, state.x)
        return BfgsInternals(
            inverse_hessian=eye.expand(b, *eye.shape).clone(),
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
        g = state.gradient
        eye = _eye_rows(state.x.shape[-1], state.x)

        direction = -lane_matvec(internals.inverse_hessian, model_gather(g))
        phi = _dot(g, direction)

        # PD/NaN reset (bfgs.h:84-92).
        reset = (phi > 0) | torch.isnan(phi)
        h = torch.where(reset[:, None, None], eye, internals.inverse_hessian)
        direction = torch.where(reset[:, None], -g, direction)
        fresh = internals.fresh | reset

        dnorm = _norm(direction)
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
        accept = ys > eps * _norm(s) * _norm(y)
        rho = (1.0 / torch.where(accept, ys, one))[:, None, None]
        y_full, s_full = model_gather(torch.stack([y, s]))
        hy = lane_matvec(h, y_full)
        yhy = _dot(y, hy)[:, None, None]
        hy_full = model_gather(hy)
        h_updated = (
            h
            - rho * (_outer(s, hy_full) + _outer(hy, s_full))
            + rho * (rho * yhy + 1.0) * _outer(s, s_full)
        )
        return next_state, BfgsInternals(
            inverse_hessian=torch.where(accept[:, None, None], h_updated, h),
            fresh=torch.where(accept, torch.zeros_like(fresh), fresh),
        ), ls.trips
