"""What decides ``correct``: the window's own solves held to the plain
reference, once the window has closed.

For a sample of lanes of the window's first solves (drawn from the seed
before the window), the benchmark's objective wrapper keeps the points the
solver evaluated in its first trips with the values and gradients its
evaluation gave there, and each solve's result is gathered for those lanes
and for the lane that took the most evaluations.  Three numbers:

* ``step_gap``: each trip of the solver against the reference's trip
  (``reference/lbfgs_trip.py``) in float64, which follows the solver step
  by step from the solver's own evaluations: the largest gap between the
  solver's next trial point and the reference's, over the larger of 1 and
  that point's largest entry.  Followed so, rounding cannot pile up over
  the trips, and the check reaches past the trips in which the history
  fills and its oldest pair starts to drop.  It covers the trip kernel's
  state machine (line search, iteration boundary, history push, two-loop,
  stopping) and the loop's hand-over of each evaluation to it.  The two
  stages this skips are checked by themselves: the first point evaluated is
  the start as drawn, and ``eval_gap`` holds every evaluation kept.
* ``eval_gap``: the values and gradients the solver's evaluation gave at
  the kept points, and those it returned at its returned points, against
  the reference's there; the larger of ``|f - f_ref| / max(1, |f_ref|)``
  and ``max |g - g_ref| / max(1, max |g_ref|)``.
* ``f_final``: the reference's value at the returned point above the
  published minimum: the loop's stop, judged by where it stopped.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from perfbench.reference import lbfgs_trip

NAMES = ("step_gap", "eval_gap", "f_final")
#: Elements (lanes times width) the reference holds at a time.
BLOCK_ELEMENTS = 1 << 22


@dataclasses.dataclass
class Sample:
    """One solve's sampled lanes: the starts, the points its first
    evaluations were given (``trials[c]`` the c-th call, call 0 the start)
    with the values and gradients they gave, and the result.  Row ``-1`` of
    the result is the lane with the most evaluations, which has no
    trials."""

    x0: torch.Tensor        # (S, n)
    trials: torch.Tensor    # (calls, S, n)
    f_trials: torch.Tensor  # (calls, S)
    g_trials: torch.Tensor  # (calls, S, n)
    x: torch.Tensor         # (S + 1, n)
    f: torch.Tensor         # (S + 1,)
    g: torch.Tensor         # (S + 1, n)


def _rel_rows(a, ref):
    """Largest ``|a - ref|`` of each row over ``max(1, max |ref|)``; inside
    ``lbfgs_trip.over_ranks``, over every rank's coordinates of the row."""
    scale = lbfgs_trip.amax_abs(ref).clamp_min(1.0)
    return lbfgs_trip.amax_abs(a - ref) / scale


def _reference(problem, x):
    """The reference's values and gradients at rows ``x`` ``(R, n)``; inside
    ``lbfgs_trip.over_ranks`` each value is summed over the ranks'
    coordinates."""
    f_ref, g_ref = problem.reference(x)
    return lbfgs_trip.rank_sum(f_ref), g_ref


def _worst(a: float, b: float) -> float:
    """The larger of two readings; NaN wins, as a failed reading must."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def _eval_gap(x, f, g, problem):
    """Largest evaluation gap of rows ``x`` ``(..., n)`` whose solver value
    and gradient are ``f`` and ``g``, against the reference's."""
    f_ref, g_ref = _reference(problem, x.reshape(-1, x.shape[-1]))
    fg = (f.reshape(-1) - f_ref).abs() / f_ref.abs().clamp_min(1.0)
    gg = _rel_rows(g.reshape(-1, x.shape[-1]), g_ref)
    return float(torch.maximum(fg, gg).max())


def step_gaps(x, f, g, x0, m, max_fev):
    """Largest gap over the lanes at each call: call 0 the first point
    against the start, call k the k-th trip's trial point against the
    reference's, which follows the solver's evaluations (``x``, ``f``,
    ``g``: ``(calls, S, ...)``) one trip at a time in float64."""
    f64 = torch.float64
    gap = [_rel_rows(x[0].to(f64), x0.to(f64)).amax()]
    if x.shape[0] > 1:
        trials = lbfgs_trip.follow(x[:-1], f[:-1], g[:-1], m, max_fev)
        gap += [_rel_rows(x[k].to(f64), t).amax()
                for k, t in enumerate(trials, 1)]
    return torch.stack(gap)


def compare(samples, problem, m, max_fev) -> dict:
    """The three numbers over every sample, the reference run in float64 in
    blocks of lanes; solves that recorded as many calls are replayed
    together.  ``step_gap_by_trip`` holds the largest step gap at each call,
    for setting how many trips the traffic checks."""
    out = {name: 0.0 for name in NAMES}
    by_trip = []
    if not samples:
        return {name: math.nan for name in NAMES}
    f64 = torch.float64
    groups = {}
    for s in samples:
        groups.setdefault(s.trials.shape[0], []).append(s)
    for group in groups.values():
        x, f, g = (torch.cat([getattr(s, k) for s in group], dim=1)
                   for k in ("trials", "f_trials", "g_trials"))
        x0 = torch.cat([s.x0 for s in group])
        block = max(1, BLOCK_ELEMENTS // x.shape[2])
        for i in range(0, x0.shape[0], block):
            xb, fb, gb = (t[:, i:i + block].to(f64) for t in (x, f, g))
            gap = step_gaps(xb, fb, gb, x0[i:i + block].to(f64), m, max_fev)
            out["step_gap"] = _worst(out["step_gap"], float(gap.max()))
            out["eval_gap"] = _worst(out["eval_gap"],
                                     _eval_gap(xb, fb, gb, problem))
            for k, v in enumerate(gap.tolist()):
                if k == len(by_trip):
                    by_trip.append(v)
                by_trip[k] = _worst(by_trip[k], v)
    for s in samples:
        x = s.x.to(f64)
        out["eval_gap"] = _worst(out["eval_gap"], _eval_gap(
            x, s.f.to(f64), s.g.to(f64), problem))
        out["f_final"] = _worst(out["f_final"], float(
            (_reference(problem, x)[0] - problem.F_STAR).max()))
    out["step_gap_by_trip"] = by_trip
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number finite and at most its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in NAMES)
