"""Augmented-Lagrangian outer loop for generally-constrained problems.

PyTorch counterpart of ``cppnumericalsolvers_tpu/solvers/
augmented_lagrangian.py`` (the reference's AugmentedLagrangian,
include/cppoptlib/solver/augmented_lagrangian.h:94-713), batched: the outer
loop runs at batch level, every lane with its own multipliers and penalty,
and each outer iteration's inner solve is the driver's iteration-granular
loop (``core/driver.py::_solve_loop_batched``) over the lanes' composites
(a :class:`~..core.objective.LaneObjective`).  Lanes whose outer loop has
stopped enter the inner solve already stopped, so they cost it nothing.
With ``Lbfgs`` inside, an inner iteration is ``lbfgs_prologue``, the
search's ``mt_trip`` launches and ``lbfgs_epilogue``; with ``Lbfgsb``, the
generic body over ``Lbfgsb.step``, whose search runs ``mt_trip``.  Never
the flat solve: the JAX package's inner solve is its loop body too.

Behaviours kept from the JAX package, lane by lane:

* first-order multiplier updates ``lambda += rho c``, ``mu = max(0, mu -
  rho g)`` with the +/-1e20 clamp and the NaN reset (:360-387, :545-563);
* the auto-scaled initial penalty, balancing |f(x0)| against the active
  constraint mass (:301-318, :476-499);
* the subproblem warm-up: 10 inner iterations at a 1e-2 gradient tolerance
  on the first outer iteration of a generally-constrained problem, and the
  inner f_delta test off on every outer iteration (:530-543);
* conditional penalty growth (x10 unless the violation shrank to a
  quarter, :435-441);
* KKT stationarity as the raw or box-projected Lagrangian-gradient
  sup-norm (projected when the inner solver is L-BFGS-B, :44-61, :577-604);
* the Pareto (feasible first, then objective) best-iterate filter with its
  NaN guards, installed on the returned state (:412-426, :633-712).

All live lanes of a batch are at the same outer iteration (every lane starts
at 0 and a stopped lane stays stopped), so one ``StoppingCriteria`` per
outer iteration serves the inner solve, warm-up included.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import vmap

from ..core.driver import SolverBase, _own, _solve_loop_batched, resolve_device
from ..core.penalty import (
    MultiplierState,
    lagrangian_gradient,
    to_augmented_lagrangian,
)
from ..core.problem import ConstrainedProblem
from ..core.progress import (
    ProgressState,
    StoppingCriteria,
    default_stopping,
    init_progress,
    update_progress_constrained,
)
from ..core.status import Status
from ..core.tree import any_lane, tree_map, tree_where
from .lbfgsb import Lbfgsb, projected_gradient_inf_norm

__all__ = ["AugmentedLagrangian", "AugmentedLagrangeState", "AlResult"]


@dataclasses.dataclass
class AugmentedLagrangeState:
    """Outer-loop state (augmented_lagrangian.h:163-238), per lane."""

    x: torch.Tensor
    multipliers: MultiplierState
    penalty: torch.Tensor  # rho
    max_violation: torch.Tensor
    max_lagrangian_gradient: torch.Tensor
    penalty_was_auto_scaled: torch.Tensor  # bool
    nfev: torch.Tensor  # int32 cumulative composite/objective evaluations


@dataclasses.dataclass
class _BestTracker:
    """Pareto best-iterate tracker (augmented_lagrangian.h:624-712)."""

    recorded: torch.Tensor  # bool
    x: torch.Tensor
    multipliers: MultiplierState
    penalty: torch.Tensor
    objective: torch.Tensor
    violation: torch.Tensor
    kkt: torch.Tensor


@dataclasses.dataclass
class AlResult:
    state: AugmentedLagrangeState
    progress: ProgressState  # the outer loop's
    #: Batched iterations of the inner loops, summed over outer iterations.
    inner_iterations: int = 0
    #: Batched objective evaluations of the inner loops.
    trips: int = 0


@dataclasses.dataclass(frozen=True)
class AugmentedLagrangian:
    """Config defaults match AugmentedLagrangianConfig
    (augmented_lagrangian.h:94-161)."""

    inner_solver: SolverBase
    penalty_growth_factor: float = 10.0
    violation_shrink_ratio: float = 0.25
    auto_scale_initial_penalty: bool = True
    penalty_auto_objective_scale: float = 10.0
    penalty_auto_min: float = 1e-8
    penalty_auto_max: float = 1e8
    warmup_max_inner_iterations: int = 10
    warmup_inner_gradient_tolerance: float = 1e-2
    multiplier_max: float = 1e20
    filter_feasibility_tolerance: float = 1e-5
    #: How ``minimize_batched`` runs: "native", one outer loop at batch
    #: level; "vmap", one ``minimize`` per lane, results stacked (what vmap
    #: of the whole solve means).
    batched_impl: str = "native"

    # -- public API ---------------------------------------------------------

    def minimize(
        self,
        problem: ConstrainedProblem,
        x0,
        multipliers: MultiplierState | None = None,
        penalty=0.0,
        stopping: StoppingCriteria | None = None,
        inner_stopping: StoppingCriteria | None = None,
        inner_internals=None,
        *,
        device=None,
    ) -> AlResult:
        """Solve one instance from ``x0`` ``(n,)``: a batch of one.

        ``inner_internals`` optionally supplies the inner solver's internals
        for every inner solve (one instance's, e.g.
        ``Lbfgsb.make_internals(n, dtype, lower, upper)`` for a box given at
        run time); the projected KKT norm then projects onto that box.  Each
        outer iteration starts its inner solve from them afresh, as the
        reference clones its inner solver per outer iteration."""
        device = resolve_device(device)
        x0 = _floating(torch.as_tensor(x0, device=device))
        dtype = x0.dtype
        if multipliers is None:
            multipliers = MultiplierState.zeros(
                problem.num_equalities, problem.num_inequalities, dtype,
                device=device)
        state0 = _initial_state(
            x0[None],
            tree_map(lambda t: t.to(device=device, dtype=dtype)[None],
                     multipliers),
            torch.as_tensor(penalty, dtype=dtype, device=device)[None])
        if inner_internals is not None:
            inner_internals = tree_map(lambda t: t[None], inner_internals)
        res = self._solve(problem, state0, stopping, inner_stopping,
                          inner_internals)
        return AlResult(
            state=tree_map(lambda t: t[0], res.state),
            progress=tree_map(lambda t: t[0], res.progress),
            inner_iterations=res.inner_iterations, trips=res.trips,
        )

    def minimize_batched(
        self,
        problem: ConstrainedProblem,
        x0_batch,
        stopping: StoppingCriteria | None = None,
        inner_stopping: StoppingCriteria | None = None,
        inner_internals=None,
        *,
        device=None,
    ) -> AlResult:
        """Solve a batch of starts ``(B, n)``, every lane with its own
        multipliers and penalty, from zero multipliers and penalty.

        ``inner_internals`` (optional) has a leading batch axis, e.g. a box
        per lane from ``Lbfgsb.make_internals(n, dtype, lower_batch,
        upper_batch)``."""
        device = resolve_device(device)
        x0 = _floating(torch.as_tensor(x0_batch, device=device))
        if x0.dim() != 2:
            raise ValueError(f"x0_batch must be (B, n), got {tuple(x0.shape)}")
        if self.batched_impl == "vmap":
            return self._lane_by_lane(problem, x0, stopping, inner_stopping,
                                      inner_internals, device)
        if self.batched_impl != "native":
            raise ValueError(f"unknown batched_impl {self.batched_impl!r}")
        b = x0.shape[0]
        state0 = _initial_state(
            x0,
            MultiplierState.zeros(problem.num_equalities,
                                  problem.num_inequalities, x0.dtype, (b,),
                                  device),
            torch.zeros((b,), dtype=x0.dtype, device=device))
        return self._solve(problem, state0, stopping, inner_stopping,
                           inner_internals)

    # -- internals ----------------------------------------------------------

    def _lane_by_lane(self, problem, x0, stopping, inner_stopping,
                      inner_internals, device) -> AlResult:
        results = [
            self.minimize(
                problem, x0[k], stopping=stopping,
                inner_stopping=inner_stopping,
                inner_internals=(None if inner_internals is None else
                                 tree_map(lambda t: t[k], inner_internals)),
                device=device)
            for k in range(x0.shape[0])
        ]

        def stack(t, *rest):
            return torch.stack((t,) + rest)

        head, rest = results[0], results[1:]
        return AlResult(
            state=tree_map(stack, head.state, *(r.state for r in rest)),
            progress=tree_map(stack, head.progress,
                              *(r.progress for r in rest)),
            inner_iterations=sum(r.inner_iterations for r in results),
            trips=sum(r.trips for r in results),
        )

    def _auto_scaled_penalty(self, problem: ConstrainedProblem, x):
        """rho_0 = scale * max(1, |f(x0)|) / max(1, active residual mass)
        (augmented_lagrangian.h:476-499), per lane of a ``(B, n)`` batch."""
        objective_magnitude = torch.clamp(
            torch.abs(vmap(problem.objective.fn)(x)), min=1.0)
        residual = torch.zeros_like(objective_magnitude)
        if problem.num_equalities:
            c = vmap(problem.eval_equalities)(x)
            residual = residual + torch.sum(0.5 * c * c, dim=-1)
        if problem.num_inequalities:
            g = vmap(problem.eval_inequalities)(x)
            residual = residual + torch.sum(
                torch.where(g < 0, 0.5 * g * g, torch.zeros_like(g)), dim=-1)
        rho = (self.penalty_auto_objective_scale * objective_magnitude
               / torch.clamp(residual, min=1.0))
        return torch.clamp(rho, self.penalty_auto_min, self.penalty_auto_max)

    def _clamp_eq(self, candidate):
        """Clamp to +/- multiplier_max, then a non-finite candidate -> 0
        (:550-554)."""
        clamped = torch.clamp(candidate, -self.multiplier_max,
                              self.multiplier_max)
        return torch.where(torch.isfinite(candidate), clamped,
                           torch.zeros_like(clamped))

    def _clamp_ineq(self, candidate):
        clamped = torch.clamp(candidate, 0.0, self.multiplier_max)
        return torch.where(torch.isfinite(candidate), clamped,
                           torch.zeros_like(clamped))

    def _kkt_norm(self, problem, x, multipliers, bounds=None):
        """The Lagrangian-gradient sup-norm, projected onto the inner
        solver's box when it has one (:577-604); ``bounds`` (the box given
        at run time) overrides the config box."""
        grad_l = lagrangian_gradient(problem, x, multipliers)
        if bounds is None and isinstance(self.inner_solver, Lbfgsb):
            bounds = self.inner_solver._bounds(x.shape[-1], x.dtype,
                                               x.device)
        if bounds is not None:
            return projected_gradient_inf_norm(x, grad_l, *bounds)
        return torch.amax(torch.abs(grad_l), dim=-1)

    def _solve(self, problem, state, stopping, inner_stopping,
               inner_internals) -> AlResult:
        """The outer loop at batch level over ``state`` (leading batch
        axis)."""
        x = state.x
        dtype, dev = x.dtype, x.device
        b = x.shape[0]
        inner = self.inner_solver
        if stopping is None:
            stopping = default_stopping(dtype)
        if inner_stopping is None:
            inner_stopping = inner.default_stopping(dtype)
        # A box given at run time flows into the projected KKT norm (the
        # reference's pickup of the inner L-BFGS-B's bounds,
        # augmented_lagrangian.h:44-61, lbfgsb.h:124-130).
        runtime_bounds = None
        if inner_internals is not None:
            inner_internals = _own(inner_internals, dev)
            if hasattr(inner_internals, "lower"):
                runtime_bounds = (inner_internals.lower,
                                  inner_internals.upper)

        cont = int(Status.CONTINUE)
        tracker = _fresh_tracker(state)
        progress = init_progress((b,), dtype, dev)
        inner_iterations = torch.zeros((), dtype=torch.int64, device=dev)
        trips = 0
        k = 0  # outer iterations run so far: every live lane's count
        while any_lane(progress.status == cont):
            outer_done = progress.status != cont
            if any_lane(~outer_done & (progress.num_iterations != k)):
                raise AssertionError(
                    "the live lanes of an outer iteration must share it")
            penalty, was_scaled = self._outer_penalty(problem, state, k)
            inner_stop = self._inner_stopping(problem, inner_stopping, k)

            composite = to_augmented_lagrangian(problem, state.multipliers,
                                                penalty)
            inner_state0 = composite.evaluate(state.x, nfev=0)
            internals0 = (inner.init_batched(composite, inner_state0)
                          if inner_internals is None
                          else _own(inner_internals, dev))
            # A lane whose outer loop has stopped enters the inner solve
            # stopped: the batch's inner loop runs as long as its slowest
            # live lane, and the outer select discards what it would do.
            inner_progress0 = init_progress((b,), dtype, dev)
            inner_progress0.status = torch.where(
                outer_done,
                torch.full_like(outer_done, int(Status.ITERATION_LIMIT),
                                dtype=torch.int32),
                inner_progress0.status)
            res = _solve_loop_batched(
                composite, inner, _own(inner_state0, dev), internals0,
                inner_progress0, inner_stop)
            inner_iterations += res.progress.num_iterations.max()
            trips += res.trips

            new_state, new_tracker, new_progress = self._outer_post(
                problem, state, tracker, progress, penalty, was_scaled,
                inner_state0, res.state, stopping, runtime_bounds)
            state = tree_where(outer_done, state, new_state)
            tracker = tree_where(outer_done, tracker, new_tracker)
            progress = tree_where(outer_done, progress, new_progress)
            k += 1

        # Install the Pareto-best iterate on the returned state (:453-466).
        best = dataclasses.replace(
            state, x=tracker.x, multipliers=tracker.multipliers,
            penalty=tracker.penalty, max_violation=tracker.violation,
            max_lagrangian_gradient=tracker.kkt)
        return AlResult(
            state=tree_where(tracker.recorded, best, state),
            progress=progress,
            inner_iterations=int(inner_iterations), trips=trips,
        )

    def _outer_penalty(self, problem, state, k):
        """The penalty of outer iteration ``k``: rho_0 auto-scaled on the
        first (:301-318) where the caller gave none."""
        was_scaled = state.penalty_was_auto_scaled
        if not (self.auto_scale_initial_penalty and k == 0):
            return state.penalty, was_scaled
        do_scale = ~was_scaled & (state.penalty == 0.0)
        penalty = torch.where(
            do_scale, self._auto_scaled_penalty(problem, state.x),
            state.penalty)
        return penalty, was_scaled | do_scale

    def _inner_stopping(self, problem, inner_stopping, k):
        """The inner criteria of outer iteration ``k``: no f_delta test, and
        the warm-up's cap and tolerance on the first (:334-353)."""
        stop = inner_stopping.replace(f_delta=0.0)
        if (k == 0 and problem.has_general_constraints
                and self.warmup_max_inner_iterations > 0):
            stop = stop.replace(
                max_iterations=self.warmup_max_inner_iterations,
                gradient_norm=self.warmup_inner_gradient_tolerance)
        return stop

    def _outer_post(self, problem, state, tracker, progress, penalty,
                    was_scaled, inner_state0, inner_state, stopping,
                    runtime_bounds):
        """After the inner solve: multiplier updates, KKT, the Pareto
        best-iterate filter, conditional penalty growth and the constrained
        ``Progress::Update`` (:356-441, progress.h:217-253)."""
        x_new = inner_state.x
        nfev = state.nfev + inner_state.nfev
        zero = torch.zeros_like(penalty)

        # Multiplier updates and the violation (:356-387).
        max_violation = zero
        lam, mu = state.multipliers.equality, state.multipliers.inequality
        if problem.num_equalities:
            c_eq = vmap(problem.eval_equalities)(x_new)
            max_violation = torch.maximum(
                max_violation, torch.amax(torch.abs(c_eq), dim=-1))
            lam = self._clamp_eq(lam + penalty[:, None] * c_eq)
        if problem.num_inequalities:
            g = vmap(problem.eval_inequalities)(x_new)
            max_violation = torch.maximum(
                max_violation,
                torch.amax(torch.clamp(-g, min=0.0), dim=-1))
            arg = mu - penalty[:, None] * g
            mu = self._clamp_ineq(torch.maximum(torch.zeros_like(arg), arg))
        new_multipliers = MultiplierState(equality=lam, inequality=mu)

        # KKT stationarity (:389-409).
        kkt = self._kkt_norm(problem, x_new, new_multipliers, runtime_bounds)

        # Pareto best-iterate tracking (:412-426, :656-701), with the
        # penalty before growth.
        cand_obj = vmap(problem.objective.fn)(x_new)
        nfev = nfev + 1
        finite = (torch.isfinite(cand_obj) & torch.isfinite(max_violation)
                  & torch.isfinite(x_new).all(dim=-1))
        feas_tol = self.filter_feasibility_tolerance
        cand_feas = max_violation <= feas_tol
        best_feas = tracker.violation <= feas_tol
        both_feasible_better = (cand_feas & best_feas
                                & (cand_obj < tracker.objective))
        both_infeasible_better = (
            ~cand_feas & ~best_feas
            & ((max_violation < tracker.violation)
               | ((max_violation == tracker.violation)
                  & (cand_obj < tracker.objective))))
        take = (~tracker.recorded | (cand_feas & ~best_feas)
                | both_feasible_better | both_infeasible_better) & finite
        candidate = _BestTracker(
            recorded=torch.ones_like(tracker.recorded), x=x_new,
            multipliers=new_multipliers, penalty=penalty,
            objective=cand_obj, violation=max_violation, kkt=kkt)
        new_tracker = tree_where(take, candidate, tracker)

        # Conditional penalty growth (:428-441).
        shrank = (max_violation
                  <= self.violation_shrink_ratio * state.max_violation)
        penalty_next = torch.where(
            shrank, penalty, penalty * self.penalty_growth_factor)

        new_state = AugmentedLagrangeState(
            x=x_new, multipliers=new_multipliers, penalty=penalty_next,
            max_violation=max_violation, max_lagrangian_gradient=kkt,
            penalty_was_auto_scaled=was_scaled, nfev=nfev)
        # The constrained Progress::Update, with the composite that was just
        # minimised at its start and end points: its f_delta and gradient
        # norm are a record only (the JAX package's choice: two fewer
        # evaluations than the reference's fresh composites).
        new_progress = update_progress_constrained(
            progress, state.x, x_new, inner_state0.value, inner_state.value,
            torch.amax(torch.abs(inner_state.gradient), dim=-1),
            max_violation, kkt, stopping)
        return new_state, new_tracker, new_progress


def _floating(x):
    return x if x.is_floating_point() else x.to(torch.float64)


def _initial_state(x0, multipliers, penalty) -> AugmentedLagrangeState:
    b = x0.shape[0]
    dtype, dev = x0.dtype, x0.device
    return AugmentedLagrangeState(
        x=x0,
        multipliers=multipliers,
        penalty=penalty,
        max_violation=torch.zeros((b,), dtype=dtype, device=dev),
        # +inf, so the first outer iteration cannot read as KKT-satisfied
        # (augmented_lagrangian.h:191-194).
        max_lagrangian_gradient=torch.full((b,), float("inf"), dtype=dtype,
                                           device=dev),
        penalty_was_auto_scaled=torch.zeros((b,), dtype=torch.bool,
                                            device=dev),
        nfev=torch.zeros((b,), dtype=torch.int32, device=dev),
    )


def _fresh_tracker(state0: AugmentedLagrangeState) -> _BestTracker:
    inf = torch.full_like(state0.penalty, float("inf"))
    return _BestTracker(
        recorded=torch.zeros_like(state0.penalty_was_auto_scaled),
        x=state0.x,
        multipliers=state0.multipliers,
        penalty=torch.zeros_like(state0.penalty),
        objective=inf,
        violation=inf,
        kkt=inf,
    )
