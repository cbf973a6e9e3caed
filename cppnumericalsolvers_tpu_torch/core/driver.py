"""Minimize drivers: ``minimize_batched`` and ``minimize``.

PyTorch counterpart of ``cppnumericalsolvers_tpu/core/driver.py`` for what
L-BFGS needs.  Every batched solve goes to the solver's batched loop (for
L-BFGS the flat trip-granular solve of ops/flat_solve.py at every n);
``minimize`` is ``minimize_batched`` on a batch of one, unbatched on return.
Lanes are independent, so the semantics are those of a single solve.

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
when there is no GPU.  Pass ``device="cpu"`` for the plain PyTorch version
on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .objective import FunctionState, Objective
from .progress import ProgressState, StoppingCriteria, default_stopping

__all__ = ["SolverBase", "MinimizeResult", "minimize", "minimize_batched"]


@dataclasses.dataclass(frozen=True)
class SolverBase:
    """Base protocol for unconstrained solvers (frozen dataclasses)."""

    #: Required objective differentiability: 'none' | 'first' | 'second'.
    mode: str = dataclasses.field(default="first", init=False, repr=False)

    def solve_batched(
        self,
        objective: Objective,
        state0: FunctionState,
        stopping: StoppingCriteria,
    ) -> "MinimizeResult":
        raise NotImplementedError

    def default_stopping(self, dtype) -> StoppingCriteria:
        return default_stopping(dtype)

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
    internals: Any  # final solver internals
    #: Loop trips of the batched solve (= batched objective evaluations =
    #: device-to-host reads of the loop predicate).
    trips: int = 0


def resolve_device(device) -> torch.device:
    """``None`` is the card; a CUDA device without a GPU raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "No CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch version on the CPU."
        )
    return device


def minimize_batched(
    objective: Objective,
    x0_batch,
    solver: SolverBase,
    stopping: StoppingCriteria | None = None,
    *,
    device=None,
) -> MinimizeResult:
    """Solve a batch of instances of one objective; ``x0_batch`` is
    ``(B, n)`` and every result field gains a leading batch axis."""
    solver.check_mode(objective)
    device = resolve_device(device)
    x0 = torch.as_tensor(x0_batch, device=device)
    if not x0.is_floating_point():
        x0 = x0.to(torch.float64)
    if x0.dim() != 2:
        raise ValueError(f"x0_batch must be (B, n), got {tuple(x0.shape)}")
    if stopping is None:
        stopping = solver.default_stopping(x0.dtype)
    state0 = objective.evaluate(x0.contiguous(), nfev=0)
    return solver.solve_batched(objective, state0, stopping)


def _unbatch(tree):
    if isinstance(tree, torch.Tensor):
        return tree[0]
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{
            f.name: _unbatch(getattr(tree, f.name))
            for f in dataclasses.fields(tree)
        })
    return tree


def minimize(
    objective: Objective,
    x0,
    solver: SolverBase,
    stopping: StoppingCriteria | None = None,
    *,
    device=None,
) -> MinimizeResult:
    """Minimize ``objective`` from ``x0`` (n,): a batch of one."""
    x0 = torch.as_tensor(x0)
    res = minimize_batched(
        objective, x0[None], solver, stopping, device=device
    )
    return MinimizeResult(
        state=_unbatch(res.state),
        progress=_unbatch(res.progress),
        internals=_unbatch(res.internals),
        trips=res.trips,
    )
