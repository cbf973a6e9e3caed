"""Nelder-Mead derivative-free simplex solver, batched.

PyTorch counterpart of ``cppnumericalsolvers_tpu/solvers/nelder_mead.py``
(the reference's NelderMead, include/cppoptlib/solver/nelder_mead.h:
40-235): coefficients rho = 1, xi = 20, gamma = 0.1, sigma = 0.5, the
adaptive initial simplex (:202-217), the degeneracy restart (:120-139), the
coincidence-guarded reflection (:150-153), and the conservative stopping
preset with a 5-strike x-delta counter (:87-91).

The simplices are ``(B, n+1, n)``.  An iteration makes three batched
value-only evaluations: the vertices, the restart simplex, and the four
candidate points (reflection, expansion, outer and inner contraction).  The
branches are selected with ``torch.where``; nfev counts only the
evaluations the reference's control flow would make, as in the JAX
package.  No kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.driver import SolverBase
from ..core.objective import FunctionState, Objective
from ..core.progress import StoppingCriteria, conservative_stopping

__all__ = ["NelderMead", "NmInternals"]

_RHO = 1.0  # reflection
_XI = 20.0  # expansion
_GAMMA = 0.1  # contraction
_SIGMA = 0.5  # shrink
_DEGENERATE_TOL = 1e-8


@dataclasses.dataclass
class NmInternals:
    simplex: torch.Tensor  # (B, n+1, n) vertices; row 0 is the initial point


def _initial_simplex(x: torch.Tensor) -> torch.Tensor:
    """The adaptive initial simplex of every lane of ``x`` ``(B, n)``
    (:202-217): vertex c is ``x + delta_c e_c`` with ``delta = 0.05 |x_c|``
    (0.001 where ``|x_c| <= 1e-6``)."""
    delta = torch.where(torch.abs(x) > 1e-6, 0.05 * torch.abs(x),
                        torch.full_like(x, 0.001))
    steps = torch.cat([torch.zeros_like(x)[:, None, :],
                       torch.diag_embed(delta)], dim=1)
    return x[:, None, :] + steps


def _rows(t, index):
    """``t[lane, index[lane]]`` for every lane."""
    return torch.gather(t, 1, index[:, None])[:, 0] if t.dim() == 2 else (
        torch.gather(t, 1, index[:, None, None].expand(-1, 1, t.shape[-1]))
        [:, 0])


@dataclasses.dataclass(frozen=True)
class NelderMead(SolverBase):
    mode: str = dataclasses.field(default="none", init=False, repr=False)
    #: Progress updates treat the solve as derivative-free whatever the
    #: objective's own mode (no gradient-norm stopping test).
    progress_mode: str = dataclasses.field(
        default="none", init=False, repr=False
    )

    def default_stopping(self, dtype) -> StoppingCriteria:
        # The conservative preset with a 5-strike x-delta (nelder_mead.h:
        # 68-91): the simplex makes consecutive tiny x-deltas while it
        # contracts.
        return conservative_stopping(dtype).replace(x_delta_violations=5)

    def init_batched(self, objective: Objective,
                     state: FunctionState) -> NmInternals:
        return NmInternals(simplex=_initial_simplex(state.x))

    def step(
        self,
        objective: Objective,
        state: FunctionState,
        internals: NmInternals,
        stopping: StoppingCriteria,
    ):
        del stopping
        simplex = internals.simplex
        b, n = state.x.shape
        nv = n + 1

        def eval_points(points):
            k = points.shape[1]
            return objective.batched_value(
                points.reshape(b * k, n)).reshape(b, k)

        f = eval_points(simplex)
        nfev = state.nfev + nv
        order = torch.argsort(f, dim=-1, stable=True)

        # Degeneracy restart around the best vertex (nelder_mead.h:120-139).
        best = _rows(simplex, order[:, 0])
        dist = torch.amax(torch.abs(simplex - best[:, None, :]), dim=-1)
        dist = dist.scatter(1, order[:, :1], 0.0)
        degenerate = torch.amax(dist, dim=-1) < _DEGENERATE_TOL
        restart = _initial_simplex(best)
        simplex = torch.where(degenerate[:, None, None], restart, simplex)
        f_restart = eval_points(restart)
        f = torch.where(degenerate[:, None], f_restart, f)
        nfev = nfev + torch.where(degenerate, nv, 0).to(torch.int32)
        order = torch.where(degenerate[:, None],
                            torch.argsort(f_restart, dim=-1, stable=True),
                            order)

        i_best = order[:, 0]
        i_worst = order[:, n]
        worst = _rows(simplex, i_worst)
        f_best = _rows(f, i_best)
        f_second_worst = _rows(f, order[:, n - 1])
        f_worst = _rows(f, i_worst)

        # Centroid of the best n vertices (:141-146).
        x_bar = (torch.sum(simplex, dim=1) - worst) / n

        x_r = (1.0 + _RHO) * x_bar - _RHO * worst
        coincident = (
            (torch.amax(torch.abs(x_r - x_bar), dim=-1) < _DEGENERATE_TOL)
            | (torch.amax(torch.abs(x_r - worst), dim=-1) < _DEGENERATE_TOL)
        )
        x_e = (1.0 + _RHO * _XI) * x_bar - _RHO * _XI * worst
        x_c_out = (1.0 + _RHO * _GAMMA) * x_bar - _RHO * _GAMMA * worst
        x_c_in = (1.0 - _GAMMA) * x_bar + _GAMMA * worst
        f_r, f_e, f_c_out, f_c_in = eval_points(
            torch.stack([x_r, x_e, x_c_out, x_c_in], dim=1)).unbind(1)

        # Branch selection (:156-191): `replacement` is written over the
        # worst vertex; `do_shrink` contracts everything toward the best.
        case_expand = f_r < f_best
        case_reflect = ~case_expand & (f_r < f_second_worst)
        case_out = ~(case_expand | case_reflect) & (f_r < f_worst)
        case_in = ~(case_expand | case_reflect | case_out)

        def pick(c, u, v):
            return torch.where(c[:, None], u, v)

        replacement = pick(
            case_expand, pick(f_e < f_r, x_e, x_r),
            pick(case_reflect, x_r, pick(case_out, x_c_out, x_c_in)))
        branch_ok = torch.where(
            case_out, f_c_out <= f_r,
            torch.where(case_in, f_c_in < f_worst,
                        torch.ones_like(case_in)))
        do_shrink = coincident | ~branch_ok

        vertex = torch.arange(nv, device=simplex.device)
        at_worst = (vertex[None, :] == i_worst[:, None])[:, :, None]
        at_best = (vertex[None, :] == i_best[:, None])[:, :, None]
        replaced = torch.where(at_worst, replacement[:, None, :], simplex)
        shrunk = _SIGMA * simplex + (1.0 - _SIGMA) * best[:, None, :]
        shrunk = torch.where(at_best, best[:, None, :], shrunk)
        new_simplex = torch.where(do_shrink[:, None, None], shrunk, replaced)

        # nfev of the reference's control flow: coincident -> the shrink
        # only (n+1, no f_r); expand -> f_r + f_e; reflect -> f_r;
        # contraction -> f_r + f_c (+ the shrink's n+1 on a rejection).
        i32 = torch.int32
        branch_nfev = torch.where(
            coincident,
            torch.full_like(nfev, nv),
            1 + case_expand.to(i32) + (case_out | case_in).to(i32)
            + ((~coincident & do_shrink).to(i32) * nv),
        )
        # The best vertex of the sort before the restart (:152, :194), and
        # one evaluation for the reference driver's state rebuild
        # (solver.h:210-216).
        next_state = FunctionState(
            x=best,
            value=f_best,
            gradient=torch.zeros_like(state.gradient),
            nfev=nfev + branch_nfev + 1,
        )
        return next_state, NmInternals(simplex=new_simplex), 3
