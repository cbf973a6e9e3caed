"""L-BFGS with the More-Thuente line search.

PyTorch counterpart of ``cppnumericalsolvers_tpu/solvers/lbfgs.py`` for
batched solves.  Two loops serve it, as in the JAX package:

* the flat trip-granular solve (ops/flat_solve.py), whose trip is one batched
  objective evaluation and one ``flat_trip`` call: every fresh solve without
  a trace, at every n (the JAX package's n cut-offs between its lowerings
  were tuned on a TPU and are not carried over);
* the iteration-granular loop of core/driver.py over
  :meth:`Lbfgs.step_and_update`: ``lbfgs_prologue`` -> the batched
  More-Thuente search (``mt_trip`` per evaluation) -> ``lbfgs_epilogue``.  It
  serves warm starts (``internals=``), traces, callbacks and ``resume``.

Both return :class:`LbfgsInternals`, chronological and batch-major:
``(B, m, n)`` with row 0 the oldest correction.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.driver import MinimizeResult, SolverBase
from ..linesearch.dispatch import run_line_search
from ..linesearch.more_thuente import DEFAULT_MAX_FEV
from ..ops.flat_solve import flat_lbfgs_solve
from ..ops.fused_step import lbfgs_epilogue, lbfgs_prologue

__all__ = ["Lbfgs", "LbfgsInternals"]


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


@dataclasses.dataclass(frozen=True)
class Lbfgs(SolverBase):
    """Limited-memory BFGS (default history m=10, lbfgs.h:40)."""

    m: int = 10
    max_linesearch_fev: int = DEFAULT_MAX_FEV
    line_search: str = "more_thuente"
    use_hessian_preconditioner: bool = False

    def __post_init__(self):
        if self.line_search != "more_thuente":
            raise NotImplementedError(
                f"line_search={self.line_search!r} is not ported yet "
                "(ROADMAP.md queue A item 12: linesearch/armijo.py, "
                "linesearch/hager_zhang.py)."
            )
        if self.use_hessian_preconditioner:
            raise NotImplementedError(
                "use_hessian_preconditioner is not ported yet (ROADMAP.md "
                "queue A item 9: the L-BFGS step with the Hessian-diagonal "
                "preconditioner)."
            )

    def solve_batched(self, objective, state0, stopping):
        res = flat_lbfgs_solve(
            objective, state0, stopping, m=self.m,
            max_fev=self.max_linesearch_fev,
        )
        internals = self.init_batched(objective, state0)
        internals = dataclasses.replace(
            internals, s_memory=res.s, y_memory=res.y, mem_count=res.count,
            gamma=res.gamma,
        )
        return MinimizeResult(
            state=res.state, progress=res.progress, internals=internals,
            trips=res.trips,
        )

    def init_batched(self, objective, state) -> LbfgsInternals:
        """Empty internals for a batched start ``state`` ``(B, n)``."""
        del objective
        b, n = state.x.shape
        dtype, dev = state.x.dtype, state.x.device

        def zeros(*shape, dtype=dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return LbfgsInternals(
            s_memory=zeros(b, self.m, n),
            y_memory=zeros(b, self.m, n),
            mem_count=zeros(b, dtype=torch.int32),
            gamma=torch.ones((b,), dtype=dtype, device=dev),
            s_pending=zeros(b, n),
            y_pending=zeros(b, n),
            pending_valid=zeros(b, dtype=torch.bool),
        )

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
        ls = run_line_search(
            self.line_search, objective.batched_value_and_grad, state.x,
            state.value, state.gradient, ls_dir, alpha_init,
            max_fev=self.max_linesearch_fev, dginit=dginit,
        )
        lbfgs_epilogue(
            state, ls.x, ls.f, ls.g, ls.nfev, count, it.s_pending,
            it.y_pending, it.pending_valid, done, progress, stopping,
        )
        return state, internals, progress, ls.trips
