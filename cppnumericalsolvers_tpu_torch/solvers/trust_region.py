"""Trust-region Newton with a CG-Steihaug subproblem solver, batched.

PyTorch counterpart of ``cppnumericalsolvers_tpu/solvers/trust_region.py``
(the reference's TrustRegionNewton, include/cppoptlib/solver/
trust_region_newton.h:78-456):

* Eisenstat-Walker CG forcing ``0.5 * min(0.5, sqrt(|g|)) * |g|``
  (trust_region_newton.h:215-220);
* CG-Steihaug with negative-curvature and boundary exits plus the
  boundary-extension root (:339-451);
* the in-step rejection loop: shrink on poor agreement, grow on good
  agreement at the boundary, accept on ``rho > eta`` (:238-311);
* all 11 configuration knobs with the reference's defaults (:78-141).

Both inner loops are loops at batch level with a per-lane exit, as the JAX
package's vmapped ``lax.while_loop``s (:func:`~..core.tree.masked_while`):
each pass is one device-to-host read, and a lane that has left keeps its
carry.
The rejection loop runs the CG loop inside it on the lanes still rejecting.
``hessian_free=True`` replaces the dense ``(B, n, n)`` Hessian by batched
Hessian-vector products (``Objective.hvp``), one per CG step.  No kernel.

Model-sharded (inside ``core.tree.model_axis_group``) every dot product and
norm is a partial sum or maximum all-reduced over the ranks, and the CG
budget counts the global n.  The dense form holds the rank's columns of the
Hessian, ``(B, n, n_local)``: a product with them is a partial sum of the
whole vector, all-reduced (``B n`` values a CG step) and cut back to the
shard; cond(H), where asked for, takes the gathered Hessian.  The
Hessian-free form keeps x, the gradient, p, r and d sharded (O(n / W) a
rank) and asks the objective for each product, which evaluates it on the
gathered vectors.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.driver import SolverBase
from ..core.objective import FunctionState, Objective
from ..core.progress import StoppingCriteria
from ..core.tree import (
    fixed_sum, lane_amax, lane_matvec, masked_while, model_cut, model_gather,
    model_sum, model_width)
from ..utils.linalg import condition_test_enabled, frobenius_condition

__all__ = ["TrustRegionNewton", "TrInternals", "solve_tr_subproblem"]


@dataclasses.dataclass
class TrInternals:
    radius: torch.Tensor  # (B,) persists across steps (:455)
    #: cond(H) of the step's Hessian for the HessianConditionViolation test
    #: (progress.h:197-208); zero (the test inert) where H is never formed.
    condition_hessian: torch.Tensor  # (B,)


def _dot(a, b):
    # A fixed order: the lane's bits do not depend on its batch (C#12).
    return model_sum(fixed_sum(a * b))


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _extend_to_boundary(p, direction, radius):
    """Positive root of ``|p + tau d|^2 = radius^2`` (:436-451)."""
    a = _dot(direction, direction)
    b = 2.0 * _dot(p, direction)
    c = _dot(p, p) - radius * radius
    disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
    tau = (-b + torch.sqrt(disc)) / (2.0 * a)
    return p + tau[:, None] * direction


def solve_tr_subproblem(gradient, hvp, radius, cg_tolerance, max_iterations,
                        live=None):
    """CG-Steihaug for every lane of ``gradient`` ``(B, n)``: approximately
    minimise ``g.p + 0.5 p.H.p`` subject to ``|p| <= radius`` (:339-426).

    ``hvp`` maps ``(B, n)`` directions to Hessian-vector products;
    ``radius`` and ``cg_tolerance`` are ``(B,)``.  ``live`` (optional,
    ``(B,)`` bool) restricts the loop to those lanes.  Returns ``(step,
    hit_boundary)``."""
    dev = gradient.device
    b = gradient.shape[0]
    if live is None:
        live = torch.ones((b,), dtype=torch.bool, device=dev)
    residual_dot0 = _dot(gradient, gradient)
    # Early exit: the gradient already below tolerance (:366-370).
    trivially_done = torch.sqrt(residual_dot0) <= cg_tolerance

    def cond(c):
        return ~c[5] & (c[4] < max_iterations)

    def body(c, _active):
        p, residual, direction, residual_dot, iteration, _, hit = c
        hd = hvp(direction)
        curvature = _dot(direction, hd)
        # `!(curvature > 0)` absorbs NaN (:380-386).
        negative_curvature = ~(curvature > 0.0)
        alpha = residual_dot / torch.where(
            negative_curvature, torch.ones_like(curvature), curvature)
        p_candidate = p + alpha[:, None] * direction
        leaves_region = _norm(p_candidate) >= radius
        boundary_exit = negative_curvature | leaves_region
        p_boundary = _extend_to_boundary(p, direction, radius)

        residual_new = residual + alpha[:, None] * hd
        converged = _norm(residual_new) <= cg_tolerance
        residual_dot_new = _dot(residual_new, residual_new)
        beta = residual_dot_new / residual_dot
        direction_new = -residual_new + beta[:, None] * direction

        done = boundary_exit | converged
        d2 = done[:, None]
        p_next = torch.where(boundary_exit[:, None], p_boundary, p_candidate)
        return (
            torch.where(d2, p_next, p_candidate),
            torch.where(d2, residual, residual_new),
            torch.where(d2, direction, direction_new),
            torch.where(done, residual_dot, residual_dot_new),
            iteration + 1,
            done,
            hit | boundary_exit,
        )

    false = torch.zeros((b,), dtype=torch.bool, device=dev)
    p, *_, hit_boundary = masked_while(cond, body, (
        torch.zeros_like(gradient), gradient, -gradient, residual_dot0,
        torch.zeros((b,), dtype=torch.int32, device=dev), trivially_done,
        false,
    ), live)
    return p, hit_boundary


@dataclasses.dataclass(frozen=True)
class TrustRegionNewton(SolverBase):
    """Configuration defaults match TrustRegionNewtonConfig (:78-141)."""

    mode: str = dataclasses.field(default="second", init=False, repr=False)
    initial_radius: float = 1.0
    max_radius: float = 1e10
    acceptance_threshold: float = 0.15
    shrink_factor: float = 0.25
    expand_factor: float = 2.0
    rho_low: float = 0.25
    rho_high: float = 0.75
    cg_forcing_coefficient: float = 0.5
    cg_max_iterations_floor: int = 10
    min_radius: float = 1e-12
    rejection_retry_limit: int = 50
    #: Use Hessian-vector products (``Objective.hvp``) instead of the dense
    #: Hessian: for large n, where ``(B, n, n)`` would not fit.
    hessian_free: bool = False

    def init_batched(self, objective: Objective,
                     state: FunctionState) -> TrInternals:
        return TrInternals(
            radius=torch.full_like(state.value, self.initial_radius),
            condition_hessian=torch.zeros_like(state.value),
        )

    def check_mode(self, objective: Objective) -> None:
        required = "first" if self.hessian_free else "second"
        order = {"none": 0, "first": 1, "second": 2}
        if order[objective.mode] < order[required]:
            raise ValueError(
                f"TrustRegionNewton(hessian_free={self.hessian_free}) "
                f"requires a {required}-mode objective."
            )

    def step(
        self,
        objective: Objective,
        state: FunctionState,
        internals: TrInternals,
        stopping: StoppingCriteria,
    ):
        x = state.x
        b, n = x.shape
        gradient = state.gradient
        current_value = state.value
        evaluations = 0

        if self.hessian_free:
            def hvp(v):
                nonlocal evaluations
                evaluations += 1
                return objective.hvp(x, v)

            hessian_nfev = 0
            condition_hessian = torch.zeros_like(current_value)
        else:
            hessian = objective.hessian(x)
            evaluations += 1

            def hvp(v):
                return model_cut(model_sum(lane_matvec(hessian, v)))

            hessian_nfev = 1  # the fresh Hessian (:199-201)
            # cond(H) costs an inverse: only when the criterion is on.
            condition_hessian = (
                frobenius_condition(model_gather(hessian))
                if condition_test_enabled(stopping)
                else torch.zeros_like(current_value)
            )

        # Eisenstat-Walker forcing (:215-220).
        gradient_inf = lane_amax(torch.abs(gradient))
        forcing = torch.clamp(torch.sqrt(gradient_inf), max=0.5)
        cg_tolerance = self.cg_forcing_coefficient * forcing * gradient_inf

        cg_max_iterations = model_width(n) + max(
            self.cg_max_iterations_floor, 0)
        retry_limit = min(max(self.rejection_retry_limit, 0), 1000)

        def reject_body(c, active):
            nonlocal evaluations
            radius, _, trial_x_kept, retry, nfev, _ = c
            step_p, hit_boundary = solve_tr_subproblem(
                gradient, hvp, radius, cg_tolerance, cg_max_iterations,
                live=active)
            trial_x = x + step_p
            trial_value = objective.batched_value(trial_x)
            evaluations += 1
            predicted = -_dot(gradient, step_p) - 0.5 * _dot(
                step_p, hvp(step_p))
            actual = current_value - trial_value
            unpredicted = predicted <= 0.0
            rho = torch.where(
                unpredicted,
                torch.full_like(actual, -torch.inf),
                actual / torch.where(unpredicted,
                                     torch.ones_like(predicted), predicted),
            )
            # Radius update (:274-287).
            grown = torch.clamp(self.expand_factor * radius,
                                max=self.max_radius)
            new_radius = torch.where(
                rho < self.rho_low,
                radius * self.shrink_factor,
                torch.where((rho > self.rho_high) & hit_boundary, grown,
                            radius),
            )
            accepted = rho > self.acceptance_threshold
            # The radius stall floor ends the rejection loop (:300-310).
            stop = accepted | (new_radius <= self.min_radius)
            return (new_radius, accepted,
                    torch.where(accepted[:, None], trial_x, trial_x_kept),
                    retry + 1, nfev + 1, stop)

        zero_i = torch.zeros((b,), dtype=torch.int32, device=x.device)
        false = torch.zeros((b,), dtype=torch.bool, device=x.device)
        radius, accepted, trial_x, _, rej_nfev, _ = masked_while(
            lambda c: ~c[5] & (c[3] < retry_limit), reject_body,
            (internals.radius, false, x, zero_i, zero_i, false),
            torch.ones((b,), dtype=torch.bool, device=x.device))

        # Accepted: a fresh populated state at the trial point (:296-298);
        # rejected to the stall: the current state, so that the outer x_delta
        # test fires.
        new_x = torch.where(accepted[:, None], trial_x, x)
        value, grad = objective.batched_value_and_grad(new_x)
        evaluations += 1
        next_state = FunctionState(
            x=new_x,
            value=torch.where(accepted, value, current_value),
            gradient=torch.where(accepted[:, None], grad, gradient),
            nfev=(state.nfev + rej_nfev + hessian_nfev
                  + accepted.to(torch.int32)),
        )
        return next_state, TrInternals(
            radius=radius, condition_hessian=condition_hessian
        ), evaluations
