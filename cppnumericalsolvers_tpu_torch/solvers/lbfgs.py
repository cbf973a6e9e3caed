"""L-BFGS with a pluggable line search (More-Thuente by default).

PyTorch counterpart of ``cppnumericalsolvers_tpu/solvers/lbfgs.py`` for
batched solves.  Two loops serve it, as in the JAX package:

* the flat trip-granular solve (ops/flat_solve.py), whose trip is one batched
  objective evaluation and one ``flat_trip`` call: every fresh solve without
  a trace with the More-Thuente search, at every n (the JAX package's n
  cut-offs between its lowerings were tuned on a TPU and are not carried
  over);
* the iteration-granular loop of core/driver.py, which serves warm starts
  (``internals=``), traces, callbacks, ``resume``, and every solve with the
  Hager-Zhang or Armijo search (the flat trip carries More-Thuente's state
  machine, so they never reach it).  Its iteration is one of three steps:

  - :meth:`Lbfgs.step_and_update`: ``lbfgs_prologue`` -> the batched search
    (More-Thuente: ``mt_trip`` per evaluation; Hager-Zhang and Armijo: plain
    PyTorch, leaving done lanes out) -> ``lbfgs_epilogue``;
  - :meth:`Lbfgs.batched_step_and_update`: the same with the history in the
    batch-minor layout of ops/fused_step_t.py (``lbfgs_prologue_t``), where
    :meth:`Lbfgs.supports_batched_native` holds (More-Thuente only).  The
    loop converts the history once at entry and once at exit;
  - :meth:`Lbfgs.step`: the generic step (``lbfgs_push_and_direction``, the
    descent check, the search, the guards in plain PyTorch), for what the
    fused steps do not cover: the Hessian-condition criterion, which the
    loop evaluates between step and convergence test, the
    Hessian-diagonal preconditioner, and ``two_loop_impl="xla"``.

``Lbfgs(two_loop_impl="xla")`` is the port's counterpart of the JAX
package's pure-XLA lowering: the generic step in plain PyTorch, with the
push, the two-loop and the More-Thuente trips in their plain versions
(``push_history``, ``two_loop_direction_reference``, ``mt_trip_reference``),
on any device and at any n, launching no kernel.  The model-sharded solve
(``parallel.minimize_model_sharded``) sets it, since its reductions span
ranks.

All return :class:`LbfgsInternals`, chronological and batch-major:
``(B, m, n)`` with row 0 the oldest correction.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import spans
from ..core.driver import MinimizeResult, SolverBase
from ..core.objective import FunctionState
from ..core.tree import lane_amax, model_shard
from ..linesearch.dispatch import run_line_search
from ..linesearch.more_thuente import DEFAULT_MAX_FEV
from ..ops.flat_solve import flat_lbfgs_solve
from ..ops.fused_step import lbfgs_epilogue, lbfgs_prologue
from ..ops.fused_step_t import (
    gather_rows,
    history_rows_to_t,
    lbfgs_prologue_t,
    make_history_t,
)
from ..ops.two_loop import (
    lbfgs_push_and_direction,
    lbfgs_push_and_direction_reference,
    push_history,
    search_direction,
    two_loop_direction,
    two_loop_direction_reference,
)

__all__ = ["Lbfgs", "LbfgsInternals", "LbfgsInternalsT", "two_loop_direction"]


@dataclasses.dataclass
class LbfgsInternals:
    """Correction history in chronological layout: row 0 is the oldest
    valid correction, row ``mem_count - 1`` the newest.

    The newest pair an iteration produced is carried as ``(s_pending,
    y_pending, pending_valid)`` and appended at the top of the next
    iteration, together with that iteration's two-loop recursion.  The flat
    solve appends at the iteration boundary itself and returns no pending
    pair (zeros and False)."""

    s_memory: torch.Tensor  # (B, m, n) x-diff history
    y_memory: torch.Tensor  # (B, m, n) grad-diff history
    mem_count: torch.Tensor  # (B,) int32 stored corrections (<= m)
    gamma: torch.Tensor  # (B,) H0 scaling factor (N&W 7.20)
    s_pending: torch.Tensor  # (B, n) newest x-diff, not yet appended
    y_pending: torch.Tensor  # (B, n) newest grad-diff, not yet appended
    pending_valid: torch.Tensor  # (B,) bool: the pair came from a finite step


@dataclasses.dataclass
class LbfgsInternalsT:
    """:class:`LbfgsInternals` with the history in the batch-minor layout of
    ops/fused_step_t.py: ``(m * n, B)``, the batch in the contiguous
    dimension, kept as a ring per lane: the row of age ``k`` (0 the oldest)
    is physical row ``(head + k) mod m``, so an accepted pair writes one row
    and nothing shifts.  It is the carry of the batch-minor loop and lives
    only inside it: :meth:`Lbfgs.to_rows` gathers it chronological before a
    result is returned."""

    s_memory_t: torch.Tensor  # (m*n, B) x-diff history, batch-minor
    y_memory_t: torch.Tensor  # (m*n, B)
    mem_count: torch.Tensor  # (B,) int32
    gamma: torch.Tensor  # (B,)
    s_pending: torch.Tensor  # (B, n)
    y_pending: torch.Tensor  # (B, n)
    pending_valid: torch.Tensor  # (B,) bool
    head: torch.Tensor  # (B,) int32 physical row of each lane's oldest pair


@dataclasses.dataclass(frozen=True)
class Lbfgs(SolverBase):
    """Limited-memory BFGS (default history m=10, lbfgs.h:40)."""

    m: int = 10
    #: Use the Hessian-diagonal preconditioner (needs a second-mode
    #: objective); lbfgs.h:97-139.
    use_hessian_preconditioner: bool = False
    max_linesearch_fev: int = DEFAULT_MAX_FEV
    line_search: str = "more_thuente"
    #: "auto": the kernels (the flat solve, prologue/epilogue, the fused
    #: push and two-loop, ``mt_trip``) on CUDA tensors; "xla": their plain
    #: versions on any device, through the generic step (the JAX package's
    #: pure-XLA lowering, which its model-sharded solve forces).
    two_loop_impl: str = "auto"

    #: Largest n, and least batch, that the iteration-granular loop runs on
    #: the batch-minor history.  0 routes nothing there: on an NVIDIA H100
    #: 80GB HBM3 (700 W) the batch-minor prologue took 0.0309, 0.0732,
    #: 0.1541 and 0.1934 ms per launch at (1024, 32), (1024, 256), (1024,
    #: 1024) and (512, 2048) in float32 against the batch-major prologue's
    #: 0.0139, 0.0316, 0.1183 and 0.1201 ms (PERF.md, the routing table;
    #: measured by chip_smoke.py's routing phase).
    _TRANSPOSED_N_MAX = 0
    _TRANSPOSED_B_MIN = 128

    #: The generic step freezes a done lane's internals itself (the push is
    #: gated on ``done``), so the driver selects only state and progress.
    freeze_in_step: bool = dataclasses.field(
        default=True, init=False, repr=False
    )

    def __post_init__(self):
        if self.two_loop_impl not in ("auto", "xla"):
            raise ValueError(
                f"two_loop_impl must be 'auto' or 'xla', got "
                f"{self.two_loop_impl!r}"
            )

    def supports_fused_update(self, objective) -> bool:
        """Whether :meth:`step_and_update` may stand in for :meth:`step` +
        the convergence test + the freeze of done lanes: every
        configuration but the Hessian-diagonal preconditioner, which needs
        an objective transform inside the step, and ``two_loop_impl="xla"``,
        which runs no kernel."""
        del objective
        return (self.two_loop_impl == "auto"
                and not self.use_hessian_preconditioner)

    def supports_solve_batched(self, objective) -> bool:
        """Whether a fresh solve without a trace takes the flat solve: the
        fused-update configuration with the More-Thuente search, whose
        state machine the flat trip carries."""
        return (self.supports_fused_update(objective)
                and self.line_search == "more_thuente")

    def supports_batched_native(self, objective, x0_batch) -> bool:
        """Whether the iteration-granular loop of this batch runs on the
        batch-minor history (:meth:`batched_step_and_update`): the
        fused-update configuration with the More-Thuente search, at least
        ``_TRANSPOSED_B_MIN`` lanes and n up to ``_TRANSPOSED_N_MAX``.  The
        rule is the same on the CPU and on the card."""
        b, n = x0_batch.shape
        return (
            self.supports_fused_update(objective)
            and self.line_search == "more_thuente"
            and b >= self._TRANSPOSED_B_MIN
            and n <= self._TRANSPOSED_N_MAX
        )

    def solve_batched(self, objective, state0, stopping):
        res = flat_lbfgs_solve(
            objective, state0, stopping, m=self.m,
            max_fev=self.max_linesearch_fev,
        )
        with spans.span(spans.ASSEMBLE):
            internals = self.init_batched(objective, state0)
            internals = dataclasses.replace(
                internals, s_memory=res.s, y_memory=res.y,
                mem_count=res.count, gamma=res.gamma,
            )
            return MinimizeResult(
                state=res.state, progress=res.progress, internals=internals,
                trips=res.trips,
            )

    def init_batched(self, objective, state, batch_minor: bool = False):
        """Empty internals for a batched start ``state`` ``(B, n)``:
        :class:`LbfgsInternals`, or with ``batch_minor`` the
        :class:`LbfgsInternalsT` that :meth:`batched_step_and_update`
        takes."""
        del objective
        b, n = state.x.shape
        dtype, dev = state.x.dtype, state.x.device

        def zeros(*shape, dtype=dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        rest = dict(
            mem_count=zeros(b, dtype=torch.int32),
            gamma=torch.ones((b,), dtype=dtype, device=dev),
            s_pending=zeros(b, n),
            y_pending=zeros(b, n),
            pending_valid=zeros(b, dtype=torch.bool),
        )
        if batch_minor:
            return LbfgsInternalsT(
                s_memory_t=make_history_t(b, self.m, n, dtype, dev),
                y_memory_t=make_history_t(b, self.m, n, dtype, dev),
                head=zeros(b, dtype=torch.int32), **rest)
        return LbfgsInternals(
            s_memory=zeros(b, self.m, n), y_memory=zeros(b, self.m, n),
            **rest)

    def to_batch_minor(self, internals: LbfgsInternals) -> LbfgsInternalsT:
        """A copy of ``internals`` with the history batch-minor, its ring
        starting at head 0."""
        it = internals
        return LbfgsInternalsT(
            s_memory_t=history_rows_to_t(it.s_memory),
            y_memory_t=history_rows_to_t(it.y_memory),
            mem_count=it.mem_count, gamma=it.gamma, s_pending=it.s_pending,
            y_pending=it.y_pending, pending_valid=it.pending_valid,
            head=torch.zeros_like(it.mem_count),
        )

    def to_rows(self, internals: LbfgsInternalsT) -> LbfgsInternals:
        """A copy of ``internals`` with the history ``(B, m, n)``,
        gathered chronological from the ring."""
        it = internals
        n = it.s_pending.shape[1]
        return LbfgsInternals(
            s_memory=gather_rows(it.s_memory_t, it.head, self.m, n),
            y_memory=gather_rows(it.y_memory_t, it.head, self.m, n),
            mem_count=it.mem_count, gamma=it.gamma, s_pending=it.s_pending,
            y_pending=it.y_pending, pending_valid=it.pending_valid,
        )

    def batched_step_and_update(
        self, objective, state, internals: LbfgsInternalsT, progress,
        stopping, done,
    ):
        """:meth:`step_and_update` on the batch-minor history: the
        batch-minor prologue kernel -> line search -> epilogue kernel.  Only
        the storage layout and the order of the sums differ."""
        it = internals
        ls_dir, alpha_init, dginit, _, _, count, _ = lbfgs_prologue_t(
            state.x, state.gradient, it.s_memory_t, it.y_memory_t,
            it.mem_count, it.gamma, it.s_pending, it.y_pending,
            it.pending_valid, done, it.head,
        )
        return self._search_and_epilogue(
            objective, state, internals, progress, stopping, done, ls_dir,
            alpha_init, dginit, count)

    def step_and_update(
        self, objective, state, internals: LbfgsInternals, progress,
        stopping, done,
    ):
        """One L-BFGS iteration of every lane with the convergence machine
        in it: prologue kernel -> line search (objective evaluations) ->
        epilogue kernel.  ``state``, ``internals`` and ``progress`` are
        updated in place and returned, with the search's trip count; a
        ``done`` lane keeps every bit of them."""
        it = internals
        ls_dir, alpha_init, dginit, _, _, count, _ = lbfgs_prologue(
            state.x, state.gradient, it.s_memory, it.y_memory, it.mem_count,
            it.gamma, it.s_pending, it.y_pending, it.pending_valid, done,
        )
        return self._search_and_epilogue(
            objective, state, internals, progress, stopping, done, ls_dir,
            alpha_init, dginit, count)

    def _search_and_epilogue(
        self, objective, state, internals, progress, stopping, done, ls_dir,
        alpha_init, dginit, count,
    ):
        it = internals
        ls = self._search(objective, state, state.gradient, ls_dir,
                          alpha_init, dginit, ~done)
        lbfgs_epilogue(
            state, ls.x, ls.f, ls.g, ls.nfev, count, it.s_pending,
            it.y_pending, it.pending_valid, done, progress, stopping,
        )
        return state, internals, progress, ls.trips

    def _search(self, objective, state, gradient, ls_dir, alpha_init,
                dginit, active):
        """The line search from ``state`` along ``ls_dir``; lanes outside
        ``active`` are left out of the Hager-Zhang and Armijo loops.  Only
        Armijo asks the objective for value-only evaluations."""
        return run_line_search(
            self.line_search, objective.batched_value_and_grad, state.x,
            state.value, gradient, ls_dir, alpha_init,
            max_fev=self.max_linesearch_fev, dginit=dginit, active=active,
            batched_value=(objective.batched_value
                           if self.line_search == "armijo" else None),
            plain=self.two_loop_impl == "xla",
        )

    def step(self, objective, state, internals: LbfgsInternals, stopping,
             done=None):
        """One L-BFGS iteration of every lane without the convergence test:
        the generic step that core/driver.py composes with
        :func:`~..core.progress.update_progress`.  Returns ``(next_state,
        next_internals, trips)``, ``trips`` being the search's batched
        evaluations.  ``state`` is not changed.  ``internals`` is consumed:
        :func:`~..ops.two_loop.lbfgs_push_and_direction` updates its
        history, count and gamma in place, and the record returned shares
        the history tensors (with the preconditioner the history is new
        tensors).  With ``done`` given, a done lane's internals come back
        bit-identical; its state is the caller's to freeze."""
        del stopping
        it = internals
        dtype = state.x.dtype
        eps = torch.finfo(dtype).eps
        gradient = state.gradient
        nfev = state.nfev

        # Gating the pending pair's validity makes the push a no-op for a
        # done lane (buffers, count, gamma all pass through); the per-lane
        # resets below are where(done, ...)-guarded.
        pending_valid = it.pending_valid
        if done is not None:
            pending_valid = pending_valid & ~done

        if self.use_hessian_preconditioner:
            if objective.mode != "second":
                raise ValueError(
                    "use_hessian_preconditioner requires a second-mode "
                    "objective"
                )
            # Model-sharded, the Hessian is the shard's columns: its
            # diagonal entries sit the shard's offset below the top.
            hess_diag = torch.diagonal(
                objective.hessian(state.x), offset=-model_shard()[0],
                dim1=-2, dim2=-1)
            precond = 1.0 / (torch.abs(hess_diag) + eps)
            nfev = nfev + 1
            # The preconditioned recursion runs no kernel in the JAX package
            # either: plain push, then the plain two-loop.
            s_memory, y_memory, mem_count, gamma = push_history(
                it.s_memory, it.y_memory, it.mem_count, it.gamma,
                it.s_pending, it.y_pending, pending_valid,
            )
            direction = two_loop_direction_reference(
                gradient, s_memory, y_memory, mem_count, gamma, precond)
        elif self.two_loop_impl == "xla":
            direction, s_memory, y_memory, mem_count, gamma = (
                lbfgs_push_and_direction_reference(
                    gradient.contiguous(), it.s_memory, it.y_memory,
                    it.mem_count, it.gamma, it.s_pending,
                    it.y_pending, pending_valid,
                )
            )
        else:
            # Append the previous step's pair (curvature-gated,
            # lbfgs.h:253-298) and compute the direction (lbfgs.h:141-196).
            direction, s_memory, y_memory, mem_count, gamma = (
                lbfgs_push_and_direction(
                    gradient.contiguous(), it.s_memory, it.y_memory,
                    it.mem_count, it.gamma, it.s_pending,
                    it.y_pending, pending_valid,
                )
            )

        # Descent check, steepest-descent fallback with a history reset
        # (lbfgs.h:199-224), and the first step.
        ls_dir, alpha_init, _, invalid = search_direction(
            state.x, gradient, direction, mem_count)
        mem_count = torch.where(invalid, torch.zeros_like(mem_count),
                                mem_count)

        # Strong-Wolfe search along -direction (lbfgs.h:226-232); it
        # computes the directional derivative itself.
        ls = self._search(objective, state, gradient, ls_dir, alpha_init,
                          None, None if done is None else ~done)
        nfev = nfev + ls.nfev

        # Non-finite guard: keep the last finite state (lbfgs.h:234-241).
        finite = torch.isfinite(ls.f)
        next_state = FunctionState(
            x=torch.where(finite[:, None], ls.x, state.x),
            value=torch.where(finite, ls.f, state.value),
            gradient=torch.where(finite[:, None], ls.g, gradient),
            nfev=nfev,
        )
        s = next_state.x - state.x
        y = next_state.gradient - gradient

        # Stall recovery: a search that could not move x would repeat the
        # same failing direction; clearing the history makes the next step
        # steepest descent with a fresh step length.
        stalled = lane_amax(torch.abs(s)) <= 0.0
        mem_count = torch.where(stalled, torch.zeros_like(mem_count),
                                mem_count)

        if done is not None:
            mem_count = torch.where(done, it.mem_count, mem_count)
            s = torch.where(done[:, None], it.s_pending, s)
            y = torch.where(done[:, None], it.y_pending, y)
            finite = torch.where(done, it.pending_valid, finite)

        return next_state, LbfgsInternals(
            s_memory=s_memory, y_memory=y_memory, mem_count=mem_count,
            gamma=gamma, s_pending=s, y_pending=y, pending_valid=finite,
        ), ls.trips
