"""Reduce a ``torch.profiler`` capture of the window to what the per-layer
metrics read: device time by the host span that launched it, the union of
device intervals, and the idle gaps labelled by what the host was doing.

The benchmark stamps three spans of its own on the host, on the profiler's
clock (``time.time_ns``): ``perfbench.solve`` around each
``minimize_batched`` call and its synchronisation, ``perfbench.eval`` around
each batched evaluation inside it, and ``perfbench.between`` around its
bookkeeping between solves.  A device operation belongs to the span in
which the host launched it: the capture pairs each operation with the
runtime call (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) that issued
it, by their shared correlation id.
"""

from __future__ import annotations

import bisect
import dataclasses

EVAL, SOLVE, BETWEEN = "perfbench.eval", "perfbench.solve", "perfbench.between"


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    eval_s: float          # device time launched inside evaluation spans
    step_s: float          # launched inside a solve, outside evaluations
    other_s: float         # launched between solves
    unattributed_s: float  # no launch found for it
    ops: list              # [(kernel name, seconds)], most time first
    gaps: list             # [(label, seconds)]


class _Spans:
    def __init__(self, intervals):
        self.iv = sorted(intervals)
        self.starts = [a for a, _ in self.iv]

    def holds(self, t) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.iv[i][1]


def reduce(events, spans) -> Summary | None:
    """``events``: the profiler's ``kineto_results.events()`` of a capture
    of the device's activity; ``spans``: span name -> [(start, end)] in ns.
    None when the capture holds no solve span or no device operation."""
    from torch.autograd import DeviceType

    host = {}  # correlation id of a runtime call -> when the host made it
    device = []
    for e in events:
        if e.device_type() == DeviceType.CPU:
            host[e.correlation_id()] = e.start_ns()
        else:
            device.append((e.start_ns(), e.end_ns(), e.name(),
                           e.correlation_id()))
    if not spans[SOLVE] or not device:
        return None
    lo = min(a for a, _ in spans[SOLVE])
    hi = max(b for _, b in spans[SOLVE])
    in_eval, in_solve = _Spans(spans[EVAL]), _Spans(spans[SOLVE])

    def label(corr):
        t = host.get(corr)
        if t is None:
            return "unattributed"
        if in_eval.holds(t):
            return "eval"
        return "loop" if in_solve.holds(t) else "between_solves"

    device = sorted(d for d in device if d[1] > lo and d[0] < hi)
    by_label = {"eval": 0, "loop": 0, "between_solves": 0, "unattributed": 0}
    by_name = {}
    merged = []  # [start, end, label of the operation that opened it]
    for a, b, name, corr in device:
        lab = label(corr)
        by_label[lab] += b - a
        by_name[name] = by_name.get(name, 0) + (b - a)
        a, b = max(a, lo), min(b, hi)
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b, lab])
    busy = sum(b - a for a, b, _ in merged)
    gaps = []
    prev = lo
    for a, b, lab in merged:
        if a > prev:
            gaps.append((lab, a - prev))
        prev = b
    if hi > prev:
        gaps.append(("window_end", hi - prev))
    totals = {}
    for lab, g in gaps:
        totals[lab] = totals.get(lab, 0) + g
    longest = sorted(gaps, key=lambda x: -x[1])
    gap_rows = ([(f"{k}.total", v * 1e-9) for k, v in
                 sorted(totals.items(), key=lambda x: -x[1])]
                + [(k, v * 1e-9) for k, v in longest])[:10]
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    return Summary(
        window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9,
        eval_s=by_label["eval"] * 1e-9, step_s=by_label["loop"] * 1e-9,
        other_s=by_label["between_solves"] * 1e-9,
        unattributed_s=by_label["unattributed"] * 1e-9,
        ops=[(name[:120], t * 1e-9) for name, t in ops], gaps=gap_rows,
    )
