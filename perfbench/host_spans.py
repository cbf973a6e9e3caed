"""Split a capture of the window by the program's own host spans.

Beside ``trace.reduce``, which labels each idle gap by the device operation
that ended it, this reduction reads the spans the port records under
``cppnumericalsolvers_tpu_torch.record_spans()`` (``core/spans.py``): each
is ``(name, start_ns, end_ns, span_id, parent_id, solve_id)`` on the
profiler's clock.  Two things come of it:

* every idle nanosecond of the window goes to the innermost program span
  open on the host at that instant, in one of six buckets: ``eval``
  (``cns.eval``, the enqueue of a batched evaluation), the loop's three --
  ``read`` (``cns.read``, the status read and the wait on it), ``trip``
  (``cns.trip``, the step's launch) and ``solve`` (``cns.solve``'s own
  time) --, ``fixed`` (``cns.init`` and ``cns.assemble``, once a solve)
  and ``outside`` (no solve open: the benchmark's bookkeeping between
  solves);
* the device time of the operations launched inside ``cns.init`` and
  ``cns.assemble``, paired with their launches by correlation id as
  ``trace.reduce`` pairs them.

The window and the device intervals' union are ``trace.reduce``'s: from the
first benchmark solve span's start to the last one's end, each operation
clipped to it, so the buckets sum to ``1 - busy / window`` of the window.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq

from perfbench import trace

# Frozen copies of the program's span names (``core/spans.py``).
SOLVE, EVAL, INIT = "cns.solve", "cns.eval", "cns.init"
READ, TRIP, ASSEMBLE = "cns.read", "cns.trip", "cns.assemble"
BUCKET = {EVAL: "eval", READ: "read", TRIP: "trip", SOLVE: "solve",
          INIT: "fixed", ASSEMBLE: "fixed"}
BUCKETS = ("eval", "read", "trip", "solve", "fixed", "outside")
LOOP = ("read", "trip", "solve")


@dataclasses.dataclass
class HostSplit:
    idle_s: dict           # bucket -> seconds the card was idle there
    window_idle_s: float   # the window less the device intervals' union
    fixed_device_s: float  # device time launched in cns.init / cns.assemble
    trips: int             # cns.trip spans that start in the window
    solves: int            # cns.solve spans inside the window
    first_eval_s: float | None  # the process's first cns.eval span

    @property
    def loop_s(self) -> float:
        """Idle seconds in the loop's buckets: read, trip, solve."""
        return sum(self.idle_s[k] for k in LOOP)

    def line(self) -> str:
        """The split as one line for stderr."""
        parts = ", ".join(f"{k} {self.idle_s[k]:.6f} s" for k in BUCKETS)
        return (f"perfbench: card idle by host span: {parts} (loop "
                f"{self.loop_s:.6f} s); sum "
                f"{sum(self.idle_s.values()):.9f} s of the window's idle "
                f"{self.window_idle_s:.9f} s; device time launched in "
                f"cns.init/cns.assemble {self.fixed_device_s:.6f} s over "
                f"{self.solves} solves, {self.trips} trips")


def busy_union(device, lo, hi) -> list:
    """``trace.reduce``'s merge: the union of device intervals ``(start,
    end, ...)`` that reach into ``[lo, hi]``, each clipped to it, as sorted
    disjoint ``[start, end]``."""
    merged = []
    for a, b, *_ in sorted(d for d in device if d[1] > lo and d[0] < hi):
        a, b = max(a, lo), min(b, hi)
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def innermost(spans, lo, hi) -> list:
    """``[(start, end, name)]`` covering ``[lo, hi]`` in order: the name of
    the innermost span open over each piece (the one that started last),
    None where none is."""
    spans = sorted((a, b, name) for name, a, b, *_ in spans
                   if b > lo and a < hi and b > a)
    points = sorted({lo, hi} | {t for a, b, _ in spans for t in (a, b)
                                if lo < t < hi})
    out, heap, k = [], [], 0
    for p, q in zip(points, points[1:]):
        while k < len(spans) and spans[k][0] <= p:
            a, b, name = spans[k]
            heapq.heappush(heap, (-a, b, name))
            k += 1
        while heap and heap[0][1] <= p:
            heapq.heappop(heap)
        name = heap[0][2] if heap else None
        if out and out[-1][2] == name and out[-1][1] == p:
            out[-1] = (out[-1][0], q, name)
        else:
            out.append((p, q, name))
    return out


def idle_by_span(busy, pieces, lo, hi) -> dict:
    """Each idle nanosecond of ``[lo, hi]`` (outside ``busy``) in the
    bucket of the piece it falls in."""
    idle, prev = [], lo
    for a, b in busy:
        if a > prev:
            idle.append((prev, a))
        prev = b
    if hi > prev:
        idle.append((prev, hi))
    out = dict.fromkeys(BUCKETS, 0)
    j = 0
    for a, b in idle:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            p, q, name = pieces[k]
            out[BUCKET.get(name, "outside")] += min(b, q) - max(a, p)
            k += 1
    return out


def split(events, bench_spans, program_spans) -> HostSplit | None:
    """``events``: the capture's ``kineto_results.events()``;
    ``bench_spans``: the benchmark's own spans (``trace.reduce``'s), which
    give the window; ``program_spans``: the program's recorder's ``spans``.
    None without a program span, a benchmark solve span or a device
    operation."""
    from torch.autograd import DeviceType

    if not program_spans or not bench_spans.get(trace.SOLVE):
        return None
    host, device = {}, []
    for e in events:
        if e.device_type() == DeviceType.CPU:
            host[e.correlation_id()] = e.start_ns()
        else:
            device.append((e.start_ns(), e.end_ns(), e.correlation_id()))
    if not device:
        return None
    lo = min(a for a, _ in bench_spans[trace.SOLVE])
    hi = max(b for _, b in bench_spans[trace.SOLVE])
    busy = busy_union(device, lo, hi)
    idle = idle_by_span(busy, innermost(program_spans, lo, hi), lo, hi)
    fixed = sorted((a, b) for name, a, b, *_ in program_spans
                   if name in (INIT, ASSEMBLE) and a >= lo and b <= hi)
    starts = [a for a, _ in fixed]
    fixed_ns = 0
    for a, b, corr in device:
        t = host.get(corr)
        if t is None or not (b > lo and a < hi):
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= fixed[i][1]:
            fixed_ns += b - a
    first = min((s for s in program_spans if s[0] == EVAL),
                key=lambda s: s[1], default=None)
    return HostSplit(
        idle_s={k: v * 1e-9 for k, v in idle.items()},
        window_idle_s=(hi - lo - sum(b - a for a, b in busy)) * 1e-9,
        fixed_device_s=fixed_ns * 1e-9,
        trips=sum(1 for s in program_spans
                  if s[0] == TRIP and lo <= s[1] <= hi),
        solves=sum(1 for s in program_spans
                   if s[0] == SOLVE and s[1] >= lo and s[2] <= hi),
        first_eval_s=None if first is None else (first[2] - first[1]) * 1e-9,
    )
