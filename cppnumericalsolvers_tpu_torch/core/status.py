"""Solver status codes.

PyTorch counterpart of ``cppnumericalsolvers_tpu/core/status.py`` (the
reference's ``Status`` enum, include/cppoptlib/solver/progress.h:37-77).
Statuses are plain int32 codes so a batch of problem instances carries a
per-lane status vector on the device.
"""

from __future__ import annotations

import enum


class Status(enum.IntEnum):
    """Status of a solve.  Numeric values are stable (used inside kernels)."""

    NOT_STARTED = -1
    CONTINUE = 0
    ITERATION_LIMIT = 1
    X_DELTA_VIOLATION = 2
    F_DELTA_VIOLATION = 3
    GRADIENT_NORM_VIOLATION = 4
    HESSIAN_CONDITION_VIOLATION = 5
    FINISHED = 6


#: Statuses that indicate the solver terminated because a convergence
#: criterion fired (as opposed to hitting the iteration limit).
CONVERGED_STATUSES = (
    int(Status.X_DELTA_VIOLATION),
    int(Status.F_DELTA_VIOLATION),
    int(Status.GRADIENT_NORM_VIOLATION),
    int(Status.FINISHED),
)


_STATUS_MESSAGES = {
    Status.NOT_STARTED: "Solver not started.",
    Status.CONTINUE: "Convergence criteria not reached.",
    Status.ITERATION_LIMIT: "Iteration limit reached.",
    Status.X_DELTA_VIOLATION: "Change in parameter vector too small.",
    Status.F_DELTA_VIOLATION: "Change in cost function value too small.",
    Status.GRADIENT_NORM_VIOLATION: "Gradient vector norm too small.",
    Status.HESSIAN_CONDITION_VIOLATION: (
        "Condition of Hessian/Covariance matrix too large."
    ),
    Status.FINISHED: "Finished",
}


def status_message(code: int) -> str:
    """Human-readable description of a status code."""
    try:
        return _STATUS_MESSAGES[Status(int(code))]
    except ValueError:
        return f"Unknown status code {code}."
