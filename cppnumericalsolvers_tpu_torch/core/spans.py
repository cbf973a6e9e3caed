"""Host spans of a batched solve, on the profiler's clock.

Inside :func:`record_spans` the batched solves record where the host
spends each solve, one span a part, in memory::

    with record_spans() as rec:
        minimize_batched(objective, x0_batch, Lbfgs())
    for name, start_ns, end_ns, span_id, parent_id, solve_id in rec.spans:
        ...

The spans:

* ``cns.solve`` -- one batched solve (``minimize``, ``minimize_batched``),
  every path, up to its returned result; the parent of those below, which
  carry its ``solve_id`` (its own ``span_id``);
* ``cns.eval`` -- the host's enqueue of one batched evaluation: the start's,
  and on the flat L-BFGS loop each trip's;
* ``cns.init`` -- the flat loop's carry set-up;
* ``cns.read`` -- the flat loop's status read: the compare, the reduction,
  the device-to-host read and the wait on it;
* ``cns.trip`` -- the flat loop's ``flat_trip`` launch and its inputs'
  casts;
* ``cns.assemble`` -- from the flat loop's exit to the solve's result, in
  two spans: the flat solve's result (its copies, the history's gather),
  then the solver's internals and its ``MinimizeResult``.

The iteration-granular loop records only ``cns.solve`` and the start's
``cns.eval``.  Timestamps are :func:`clock_ns`, ``time.time_ns``: the clock
of ``torch.profiler``'s events, so a span holds the runtime calls the host
made inside it.  Without a recorder the flat loop reads no clock and builds
nothing a trip.
"""

from __future__ import annotations

import contextlib
import time

__all__ = [
    "ASSEMBLE",
    "EVAL",
    "INIT",
    "READ",
    "SOLVE",
    "SpanRecorder",
    "TRIP",
    "clock_ns",
    "record_spans",
    "recorder",
    "span",
]

SOLVE = "cns.solve"
EVAL = "cns.eval"
INIT = "cns.init"
READ = "cns.read"
TRIP = "cns.trip"
ASSEMBLE = "cns.assemble"

#: The spans' clock, nanoseconds since the epoch: ``torch.profiler``'s.
clock_ns = time.time_ns

_NOTHING = contextlib.nullcontext()
_current: SpanRecorder | None = None


class SpanRecorder:
    """The spans of the solves run while it is installed, in the order they
    ended: ``spans`` is a list of ``(name, start_ns, end_ns, span_id,
    parent_id, solve_id)``.  A span's parent is the span open around it
    (None at top level); its ``solve_id`` is the ``span_id`` of the
    ``cns.solve`` it belongs to (None outside any solve).

    Not thread-safe: one recorder serves the solves of one thread."""

    def __init__(self):
        self.spans: list = []
        self._open: list = []  # (span_id, solve_id), innermost last
        self._last_id = 0

    def _new(self):
        self._last_id += 1
        parent, solve = self._open[-1] if self._open else (None, None)
        return self._last_id, parent, solve

    def add(self, name: str, start_ns: int, end_ns: int) -> int:
        """Record a span that the caller timed itself, as a child of the
        innermost open span; return ``end_ns``, the next span's start."""
        span_id, parent, solve = self._new()
        self.spans.append((name, start_ns, end_ns, span_id, parent, solve))
        return end_ns

    @contextlib.contextmanager
    def span(self, name: str):
        """Time the block as span ``name``; spans recorded inside it are
        its children.  A ``cns.solve`` starts a solve of its own."""
        span_id, parent, solve = self._new()
        if name == SOLVE:
            solve = span_id
        self._open.append((span_id, solve))
        start = clock_ns()
        try:
            yield
        finally:
            end = clock_ns()
            self._open.pop()
            self.spans.append((name, start, end, span_id, parent, solve))


def recorder() -> SpanRecorder | None:
    """The installed recorder, or None."""
    return _current


def span(name: str):
    """``recorder().span(name)``, or a context that does nothing when no
    recorder is installed."""
    return _NOTHING if _current is None else _current.span(name)


@contextlib.contextmanager
def record_spans():
    """Install a fresh :class:`SpanRecorder` for the block and yield it;
    the one installed before comes back at the block's end."""
    global _current
    rec = SpanRecorder()
    before, _current = _current, rec
    try:
        yield rec
    finally:
        _current = before
