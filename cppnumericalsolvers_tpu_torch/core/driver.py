"""Minimize drivers: ``minimize``, ``minimize_batched`` and ``resume``.

PyTorch counterpart of ``cppnumericalsolvers_tpu/core/driver.py`` for the
unconstrained solvers.  A batched solve takes one of two loops, by the JAX
driver's rule:

* a fresh solve without a trace goes to the solver's own batched loop where
  the solver has one (``SolverBase.supports_solve_batched``; for L-BFGS with
  the More-Thuente search the flat trip-granular solve of
  ops/flat_solve.py, at every n);
* a warm start (``internals=``), a trace (``trace=K``), a callback and
  ``resume`` go to the iteration-granular loop here: one loop at batch level
  over ``SolverBase.step_and_update``, which continues while any lane's
  status is CONTINUE (one device-to-host read per iteration) and whose lanes
  freeze themselves once they stop.  Where the solver says so
  (``supports_batched_native``) the same loop runs the solver's batch-native
  step on its own storage layout, converted at entry and exit;
* a solve whose solver has no fused update for its objective (every solver
  but L-BFGS, and L-BFGS with the Hessian-diagonal preconditioner), or
  whose Hessian-condition criterion is on (a second-mode objective and
  ``stopping.condition_hessian > 0``), takes that loop with the generic
  body: ``SolverBase.step``, cond(H) from the solver's internals or at the
  new iterate (billed as one evaluation), ``update_progress``, the solver's
  ``post_update`` and the freeze of done lanes; the step and the test see
  the solver's ``transform_stopping`` of the criteria, ``post_update`` the
  caller's (L-BFGS-B's projected-gradient test).  A solver that freezes its own internals
  (``freeze_in_step``: L-BFGS) gets ``done`` and the body selects state and
  progress; any other gets no ``done`` and the body selects its whole
  carry, internals included.

``minimize`` is a batch of one, un-batched on return.  Lanes are
independent, so the semantics are those of a single solve.

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
when there is no GPU.  Pass ``device="cpu"`` for the plain PyTorch version
on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import spans
from .callbacks import IterationTrace, init_trace, record_trace
from .objective import FunctionState, Objective
from .progress import (
    ProgressState,
    StoppingCriteria,
    default_stopping,
    init_progress,
    update_progress,
)
from .status import Status
from .tree import any_lane, lane_amax, tree_map, tree_where

__all__ = [
    "SolverBase",
    "MinimizeResult",
    "minimize",
    "minimize_batched",
    "resume",
]


@dataclasses.dataclass(frozen=True)
class SolverBase:
    """Base protocol for unconstrained solvers (frozen dataclasses)."""

    #: Required objective differentiability: 'none' | 'first' | 'second'.
    mode: str = dataclasses.field(default="first", init=False, repr=False)
    #: The solver's :meth:`step` takes ``done=`` and returns a done lane's
    #: internals bit-identical; the generic body then selects only state and
    #: progress.  Otherwise it selects the whole carry.
    freeze_in_step: bool = dataclasses.field(
        default=False, init=False, repr=False
    )

    def supports_solve_batched(self, objective: Objective) -> bool:
        """Whether a fresh solve without a trace goes to
        :meth:`solve_batched`, the solver's own batched loop."""
        del objective
        return False

    def solve_batched(
        self,
        objective: Objective,
        state0: FunctionState,
        stopping: StoppingCriteria,
    ) -> "MinimizeResult":
        raise NotImplementedError

    def init_batched(self, objective: Objective, state: FunctionState) -> Any:
        """Fresh solver internals for a batched start ``state``."""
        raise NotImplementedError

    def step_and_update(
        self,
        objective: Objective,
        state: FunctionState,
        internals: Any,
        progress: ProgressState,
        stopping: StoppingCriteria,
        done: torch.Tensor,
    ):
        """One iteration of every lane, convergence machine included, in
        place on ``(state, internals, progress)``; a ``done`` lane keeps
        every bit.  Returns them and the batched evaluations it made."""
        raise NotImplementedError

    def supports_fused_update(self, objective: Objective) -> bool:
        """Whether :meth:`step_and_update` may replace the generic
        composition of :meth:`step`, ``update_progress`` and the freeze of
        done lanes for this objective."""
        del objective
        return False

    def supports_batched_native(self, objective: Objective, x0_batch) -> bool:
        """Whether the iteration-granular loop of this batch runs on the
        solver's own storage layout: :meth:`to_batch_minor` at entry,
        :meth:`batched_step_and_update` per iteration, :meth:`to_rows` at
        exit."""
        del objective, x0_batch
        return False

    def step(
        self,
        objective: Objective,
        state: FunctionState,
        internals: Any,
        stopping: StoppingCriteria,
        done: torch.Tensor | None = None,
    ):
        """One iteration of every lane without the convergence test.
        Returns ``(next_state, next_internals, evaluations)``, the last the
        batched evaluations it made; ``state`` is not changed.  A
        ``freeze_in_step`` solver gets ``done``, may consume ``internals``
        and returns a done lane's internals bit-identical; any other gets no
        ``done`` and leaves ``internals`` as it was."""
        raise NotImplementedError

    def default_stopping(self, dtype) -> StoppingCriteria:
        return default_stopping(dtype)

    def transform_stopping(self, stopping: StoppingCriteria
                           ) -> StoppingCriteria:
        """The criteria the step and the generic convergence test see
        (L-BFGS-B switches the full-gradient test off, lbfgsb.h:258-260);
        the default is the caller's."""
        return stopping

    def post_update(
        self,
        objective: Objective,
        state: FunctionState,
        internals: Any,
        progress: ProgressState,
        stopping: StoppingCriteria,
    ) -> ProgressState:
        """Runs in the generic body after the convergence test, before done
        lanes are frozen, with the caller's untransformed ``stopping``, so a
        solver can impose a convergence signal of its own (L-BFGS-B's
        projected-gradient test, lbfgsb.h:280-283).  The default returns
        ``progress``."""
        del objective, state, internals, stopping
        return progress

    def check_mode(self, objective: Objective) -> None:
        order = {"none": 0, "first": 1, "second": 2}
        if order[objective.mode] < order[self.mode]:
            raise ValueError(
                f"{type(self).__name__} requires a {self.mode!r}-mode "
                f"objective, got {objective.mode!r}."
            )


@dataclasses.dataclass
class MinimizeResult:
    state: FunctionState  # final iterate with populated (value, gradient)
    progress: ProgressState  # convergence record, per lane when batched
    internals: Any  # final solver internals (resume-friendly)
    #: Batched objective evaluations of the solve's loop (each is followed by
    #: one device-to-host read of a loop predicate).
    trips: int = 0
    trace: IterationTrace | None = None  # per-iteration record (trace > 0)


def resolve_device(device) -> torch.device:
    """``None`` is the card; a CUDA device without a GPU raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "No CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch version on the CPU."
        )
    return device


def _solve_loop_batched(
    objective: Objective,
    solver: SolverBase,
    state: FunctionState,
    internals: Any,
    progress: ProgressState,
    stopping: StoppingCriteria,
    trace: int = 0,
    callback=None,
    compute_cond_h: bool = False,
) -> MinimizeResult:
    """The iteration-granular loop, shared by warm starts, traced solves
    and :func:`resume`.  It updates ``(state, internals, progress)`` in
    place, so its callers hand it tensors of their own.

    ``compute_cond_h`` makes the Hessian-condition criterion
    solver-independent: the reference evaluates cond(H) inside
    ``Progress::Update`` for every second-mode function (progress.h:203-210),
    paying one Hessian per iteration.  The loop evaluates it here when the
    criterion is on, billed as one evaluation per iteration."""
    cont = int(Status.CONTINUE)
    b = state.value.shape[0]
    stopping_inner = solver.transform_stopping(stopping)
    generic = compute_cond_h or not solver.supports_fused_update(objective)
    native = not generic and solver.supports_batched_native(
        objective, state.x)
    if native:
        internals = solver.to_batch_minor(internals)
    trace_buf = (
        init_trace(trace, state.value.dtype, (b,), state.value.device)
        if trace > 0 else None
    )
    trips = 0
    # One device-to-host read per iteration: any lane still continuing.
    while any_lane(progress.status == cont):
        done = progress.status != cont
        if generic:
            state, internals, progress, n_eval = _generic_iteration(
                objective, solver, state, internals, progress,
                stopping_inner, done, compute_cond_h, stopping)
        else:
            step = (solver.batched_step_and_update if native
                    else solver.step_and_update)
            state, internals, progress, n_eval = step(
                objective, state, internals, progress, stopping_inner, done
            )
        trips += n_eval
        if trace_buf is not None:
            trace_buf = record_trace(trace_buf, progress, state)
        if callback is not None:
            # Live observability (PrintProgressCallback analog,
            # solver.h:59-147): one host call per iteration, with copies,
            # since the loop goes on writing into its carry.
            callback({
                "num_iterations": progress.num_iterations.clone(),
                "value": state.value.clone(),
                "gradient_norm": lane_amax(torch.abs(state.gradient)),
                "x_delta": progress.x_delta.clone(),
                "f_delta": progress.f_delta.clone(),
                "status": progress.status.clone(),
            })
    if native:
        internals = solver.to_rows(internals)
    return MinimizeResult(
        state=state, progress=progress, internals=internals, trips=trips,
        trace=trace_buf,
    )


def _generic_iteration(objective, solver, state, internals, progress,
                       stopping, done, compute_cond_h, user_stopping=None):
    """The generic loop body: the solver's step, cond(H), the convergence
    test, the solver's ``post_update``, and the freeze of done lanes.

    ``stopping`` is the solver's ``transform_stopping`` of the caller's
    ``user_stopping`` (None: the same); the step and the test see the
    first, ``post_update`` the second.  Solvers that materialise the Hessian (Newton, trust region)
    give cond(H) in their internals; otherwise it is evaluated at the new
    iterate where asked for.  A solver may run the test derivative-free
    whatever the objective's mode (``progress_mode``: Nelder-Mead)."""
    if solver.freeze_in_step:
        new_state, new_internals, n_eval = solver.step(
            objective, state, internals, stopping, done=done)
    else:
        new_state, new_internals, n_eval = solver.step(
            objective, state, internals, stopping)
    cond_h = getattr(new_internals, "condition_hessian", None)
    if cond_h is None and compute_cond_h:
        from ..utils.linalg import frobenius_condition

        cond_h = frobenius_condition(objective.hessian(new_state.x))
        new_state.nfev = new_state.nfev + 1
    progress_mode = getattr(solver, "progress_mode", None) or objective.mode
    new_progress = update_progress(
        progress, state, new_state, stopping, mode=progress_mode,
        condition_hessian=cond_h,
    )
    new_progress = solver.post_update(
        objective, new_state, new_internals, new_progress,
        stopping if user_stopping is None else user_stopping)
    if not solver.freeze_in_step:
        new_internals = tree_where(done, internals, new_internals)
    return (tree_where(done, state, new_state), new_internals,
            tree_where(done, progress, new_progress), n_eval)


def _wants_driver_cond_h(objective: Objective,
                         stopping: StoppingCriteria) -> bool:
    """Whether the loop evaluates cond(H) every iteration: only for a
    second-mode objective with the criterion on.  Paying a Hessian per
    iteration with the criterion off (the default) would be waste."""
    from ..utils.linalg import condition_test_enabled

    return objective.mode == "second" and condition_test_enabled(stopping)


def _own(tree, device):
    """A copy of every tensor of ``tree`` on ``device``: the loop works in
    place and must not change what its caller holds."""
    return tree_map(lambda t: t.to(device).clone().contiguous(), tree)


def minimize_batched(
    objective: Objective,
    x0_batch,
    solver: SolverBase,
    stopping: StoppingCriteria | None = None,
    *,
    trace: int = 0,
    internals: Any | None = None,
    device=None,
) -> MinimizeResult:
    """Solve a batch of instances of one objective; ``x0_batch`` is
    ``(B, n)`` and every result field gains a leading batch axis.

    ``internals`` (optional) is a solver-internals record with a leading
    batch axis, e.g. a previous result's for a warm start; it is not
    changed.  ``trace=K`` records the first K iterations of every lane in
    ``result.trace``."""
    return _solve_batched(objective, x0_batch, solver, stopping, trace,
                          internals, None, device)


def _solve_batched(objective, x0_batch, solver, stopping, trace, internals,
                   callback, device) -> MinimizeResult:
    with spans.span(spans.SOLVE):
        solver.check_mode(objective)
        device = resolve_device(device)
        x0 = torch.as_tensor(x0_batch, device=device)
        if not x0.is_floating_point():
            x0 = x0.to(torch.float64)
        if x0.dim() != 2:
            raise ValueError(
                f"x0_batch must be (B, n), got {tuple(x0.shape)}")
        if stopping is None:
            stopping = solver.default_stopping(x0.dtype)
        with spans.span(spans.EVAL):
            state0 = objective.evaluate(x0.contiguous(), nfev=0)
        compute_cond_h = _wants_driver_cond_h(objective, stopping)
        if (internals is None and trace == 0 and callback is None
                and not compute_cond_h
                and solver.supports_solve_batched(objective)):
            return solver.solve_batched(objective, state0, stopping)
        state0 = _own(state0, device)
        internals0 = (
            solver.init_batched(objective, state0) if internals is None
            else _own(internals, device)
        )
        progress0 = init_progress((x0.shape[0],), x0.dtype, device)
        return _solve_loop_batched(
            objective, solver, state0, internals0, progress0, stopping,
            trace, callback, compute_cond_h,
        )


def _unbatch(tree):
    return tree_map(lambda t: t[0], tree)


def _batch(tree):
    return tree_map(lambda t: t[None], tree)


def _unbatch_result(res: MinimizeResult) -> MinimizeResult:
    return MinimizeResult(
        state=_unbatch(res.state),
        progress=_unbatch(res.progress),
        internals=_unbatch(res.internals),
        trips=res.trips,
        trace=_unbatch(res.trace),
    )


def minimize(
    objective: Objective,
    x0,
    solver: SolverBase,
    stopping: StoppingCriteria | None = None,
    *,
    trace: int = 0,
    callback=None,
    internals: Any | None = None,
    device=None,
) -> MinimizeResult:
    """Minimize ``objective`` from ``x0`` (n,): a batch of one.

    ``internals`` overrides the solver's fresh internal state (a previous
    un-batched result's, for a warm start).  ``callback`` is called once per
    iteration with a dict of that iteration's figures
    (:func:`~.callbacks.print_progress` prints them)."""
    x0 = torch.as_tensor(x0)
    res = _solve_batched(
        objective, x0[None], solver, stopping, trace,
        None if internals is None else _batch(internals),
        None if callback is None
        else lambda info: callback(_unbatch_info(info)),
        device,
    )
    return _unbatch_result(res)


def _unbatch_info(info: dict) -> dict:
    return {k: v[0] for k, v in info.items()}


def resume(
    objective: Objective,
    checkpoint: MinimizeResult,
    solver: SolverBase,
    stopping: StoppingCriteria | None = None,
    *,
    trace: int = 0,
    callback=None,
    device=None,
) -> MinimizeResult:
    """Continue a solve from a checkpointed :class:`MinimizeResult`, batched
    or un-batched (the result comes back in the same form).

    All solver state is value state, so a checkpoint is just the result
    record.  The terminal status is re-opened and every counter kept
    (violation counts, the plateau ring, ``num_iterations``), so a solve
    interrupted at iteration k (e.g. by ``max_iterations=k``) and resumed
    reproduces the uninterrupted trajectory.  The checkpoint is not
    changed."""
    solver.check_mode(objective)
    device = resolve_device(device)
    batched = checkpoint.state.x.dim() == 2
    if stopping is None:
        stopping = solver.default_stopping(checkpoint.state.x.dtype)
    state, internals, progress = (
        _own(t if batched else _batch(t), device)
        for t in (checkpoint.state, checkpoint.internals,
                  checkpoint.progress)
    )
    progress.status.fill_(int(Status.CONTINUE))
    if callback is not None and not batched:
        user_callback = callback
        callback = lambda info: user_callback(_unbatch_info(info))  # noqa: E731
    res = _solve_loop_batched(
        objective, solver, state, internals, progress, stopping, trace,
        callback, _wants_driver_cond_h(objective, stopping),
    )
    return res if batched else _unbatch_result(res)
