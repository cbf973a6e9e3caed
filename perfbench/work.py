"""The yardstick's counts: the published peaks of the card and the least
work of the solver's step.

The step's count is a frozen copy of the traffic rule of the port's
roofline harness (``trip_work``): each input read once and each output
written once, by lane state.  A dead lane reads its iterate and writes the
trial point; a lane mid-search reads the trial gradient, the direction and
the iterate and writes the accepted gradient and the trial point; a lane at
the iteration boundary reads the iterate, its gradient, the direction and
the accepted gradient and the history rows its two-loop uses, and writes
the iterate, gradient, direction, accepted gradient, trial point and the one
row of s and of y an accepted pair takes.  The scalar rows count for every
live lane.  Here the states are worked out from what a solve returns per
lane (evaluations, iterations, history count), so the count is the same
whatever kernels carry the step.
"""

from __future__ import annotations

import torch

#: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {4: 67e12, 8: 34e12}

#: The flat carry's scalar rows per lane: 19 float, 13 int32, a plateau
#: ring of 8 floats.
_NF, _NI, _RING = 19, 13, 8


def step_work(trips: int, nfev, iterations, count, n: int, m: int,
              itemsize: int):
    """``(bytes, operations)`` of one solve's ``trips`` trips, summed over
    lanes, as float64 tensors on the lanes' device.  ``nfev`` counts the
    start's evaluation too; every boundary but a lane's last is taken to
    push an accepted pair, and the last reads the ``count`` rows the lane
    ends with."""
    w = itemsize
    f64 = torch.float64
    nfev, it, c = (t.to(f64) for t in (nfev, iterations, count))
    live = nfev - 1
    mid = (live - it).clamp_min(0)
    dead = (trips - live).clamp_min(0)
    pushes = (it - 1).clamp_min(0)
    full = pushes.clamp_max(m)
    rows_after = full * (full + 1) / 2 + (pushes - full) * m
    rows_read = (rows_after - pushes) + c
    scal = (2 * (_NF + _RING) + 1) * w + 2 * _NI * 4
    byts = (dead * (2 * n * w + _NI * 4) + mid * (5 * n * w + scal)
            + it * (9 * n * w + scal) + 2 * n * (rows_read + pushes) * w)
    ops = mid * 4 * n + it * 24 * n + 10 * n * (rows_after + c)
    return byts.sum(), ops.sum()


def bound_seconds(byts: float, ops: float, itemsize: int) -> float:
    """The least time of ``byts`` bytes and ``ops`` operations on the card:
    the larger of the two at the published peaks."""
    return max(byts / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[itemsize])
