"""Per-iteration observability: trace buffers and live callbacks.

PyTorch counterpart of ``cppnumericalsolvers_tpu/core/callbacks.py`` (the
reference's ``Solver::SetCallback`` and ``PrintProgressCallback``,
solver.h:59-147, :176).  Two mechanisms:

* a **fixed-size trace buffer** carried through the loop and returned with
  the result: tensors on the solve's device, no host transfer; and
* a **host callback** called once per iteration with a dict of that
  iteration's figures (one device-to-host transfer per iteration when it
  reads them: for debugging, not production).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .tree import lane_amax

__all__ = ["IterationTrace", "init_trace", "record_trace", "print_progress"]


@dataclasses.dataclass
class IterationTrace:
    """First-``capacity`` iterations of the solve, one entry each on the
    last axis; a batched solve has a leading batch axis.  Unwritten entries
    stay NaN (floats) / -1 (status), so a short solve is self-describing."""

    value: torch.Tensor  # (..., capacity) objective value
    gradient_norm: torch.Tensor  # (..., capacity) ||g||_inf
    x_delta: torch.Tensor  # (..., capacity)
    f_delta: torch.Tensor  # (..., capacity)
    status: torch.Tensor  # (..., capacity) int32 status after the iteration


def init_trace(capacity: int, dtype, batch_shape=(), device="cpu"):
    shape = tuple(batch_shape) + (capacity,)

    def nan():
        return torch.full(shape, torch.nan, dtype=dtype, device=device)

    return IterationTrace(
        value=nan(), gradient_norm=nan(), x_delta=nan(), f_delta=nan(),
        status=torch.full(shape, -1, dtype=torch.int32, device=device),
    )


def record_trace(trace: IterationTrace, progress, state) -> IterationTrace:
    """Record the just-completed iteration (1-based ``num_iterations``).  A
    frozen lane re-records its last entry with the same figures."""
    capacity = trace.value.shape[-1]
    idx = progress.num_iterations - 1
    write = idx < capacity
    idx = torch.clamp(idx, 0, capacity - 1)
    slots = torch.arange(capacity, device=trace.value.device)
    at = (slots == idx[..., None]) & write[..., None]

    def put(buf, val):
        return torch.where(at, val[..., None].to(buf.dtype), buf)

    return IterationTrace(
        value=put(trace.value, state.value),
        gradient_norm=put(
            trace.gradient_norm, lane_amax(torch.abs(state.gradient))
        ),
        x_delta=put(trace.x_delta, progress.x_delta),
        f_delta=put(trace.f_delta, progress.f_delta),
        status=put(trace.status, progress.status),
    )


def print_progress(info: dict[str, Any]) -> None:
    """Stock live callback: the ``PrintProgressCallback`` analog
    (solver.h:59-147).  Pass as ``minimize(..., callback=print_progress)``."""
    print(
        "iter {it:>5}  f = {f: .10e}  |g|inf = {g:.3e}  "
        "x_delta = {xd:.3e}  f_delta = {fd:.3e}".format(
            it=int(info["num_iterations"]),
            f=float(info["value"]),
            g=float(info["gradient_norm"]),
            xd=float(info["x_delta"]),
            fd=float(info["f_delta"]),
        )
    )
