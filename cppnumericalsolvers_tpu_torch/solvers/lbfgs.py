"""L-BFGS with the More-Thuente line search.

PyTorch counterpart of ``cppnumericalsolvers_tpu/solvers/lbfgs.py`` for the
batched main path.  Every batch goes through the flat trip-granular solve
(ops/flat_solve.py), whose trip is one batched objective evaluation and one
``flat_trip`` call (the CUDA kernel on the card).  The JAX package's n
cut-offs between its lowerings were tuned on a TPU and are not carried over.

The history comes back in :class:`LbfgsInternals`, chronological and
batch-major: ``(B, m, n)`` with row 0 the oldest correction.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.driver import MinimizeResult, SolverBase
from ..linesearch.more_thuente import DEFAULT_MAX_FEV
from ..ops.flat_solve import flat_lbfgs_solve

__all__ = ["Lbfgs", "LbfgsInternals"]


@dataclasses.dataclass
class LbfgsInternals:
    """Correction history in chronological layout: row 0 is the oldest
    valid correction, row ``mem_count - 1`` the newest."""

    s_memory: torch.Tensor  # (B, m, n) x-diff history
    y_memory: torch.Tensor  # (B, m, n) grad-diff history
    mem_count: torch.Tensor  # (B,) int32 stored corrections (<= m)
    gamma: torch.Tensor  # (B,) H0 scaling factor (N&W 7.20)


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
                "queue A item 9: the batch-major L-BFGS step with the "
                "Hessian-diagonal preconditioner)."
            )

    def solve_batched(self, objective, state0, stopping):
        res = flat_lbfgs_solve(
            objective, state0, stopping, m=self.m,
            max_fev=self.max_linesearch_fev,
        )
        internals = LbfgsInternals(
            s_memory=res.s, y_memory=res.y, mem_count=res.count,
            gamma=res.gamma,
        )
        return MinimizeResult(
            state=res.state, progress=res.progress, internals=internals,
            trips=res.trips,
        )
