"""The port's host spans (``core/spans.py``): a recorder changes no bit of
a solve, the flat loop records each part once where it happens, spans nest
in their solve, and their clock is the profiler's.  Flat solves of the
pairwise Rosenbrock at B = 16, n = 32 on the CPU (``device="cpu"``)."""

import collections
import contextlib

import pytest
import torch

import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.core import spans

torch.set_num_threads(1)

B, N = 16, 32


def starts(seed=3):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((B, N), generator=gen, dtype=torch.float64) * 4.0 - 2.0


def solve(x0=None, **kwargs):
    return cns.minimize_batched(
        cns.models.pairwise_rosenbrock(),
        starts() if x0 is None else x0, cns.Lbfgs(m=10), device="cpu",
        **kwargs)


def names(rec):
    return collections.Counter(s[0] for s in rec.spans)


def test_a_recorder_changes_no_bit_of_the_solve():
    plain = solve()
    with cns.record_spans():
        traced = solve()
    assert traced.trips == plain.trips > 10
    assert torch.equal(traced.state.x, plain.state.x)
    assert torch.equal(traced.state.value, plain.state.value)
    assert torch.equal(traced.progress.status, plain.progress.status)
    assert torch.equal(traced.state.nfev, plain.state.nfev)
    assert torch.equal(traced.internals.s_memory, plain.internals.s_memory)


def test_one_flat_solve_records_each_part_where_it_happens():
    with cns.record_spans() as rec:
        res = solve()
    t = res.trips
    # Two assembly spans: the flat solve's result, then the solver's.
    assert names(rec) == {spans.SOLVE: 1, spans.INIT: 1, spans.ASSEMBLE: 2,
                          spans.READ: t + 1, spans.TRIP: t,
                          spans.EVAL: t + 1}


def test_spans_nest_in_their_solve_and_siblings_do_not_overlap():
    with cns.record_spans() as rec:
        solve()
    (root,) = [s for s in rec.spans if s[0] == spans.SOLVE]
    _, lo, hi, solve_id, parent, own = root
    assert parent is None and own == solve_id
    kids = sorted((s for s in rec.spans if s[0] != spans.SOLVE),
                  key=lambda s: s[1])
    for name, a, b, span_id, parent, sid in kids:
        assert lo <= a <= b <= hi, name
        assert parent == solve_id and sid == solve_id, name
        assert span_id != solve_id
    for left, right in zip(kids, kids[1:]):
        assert left[2] <= right[1], (left, right)
    # The order of one trip: read, evaluation, step; the start's
    # evaluation and the carry's set-up before, the two assemblies after.
    order = [s[0] for s in kids]
    assert order[:3] == [spans.EVAL, spans.INIT, spans.READ]
    assert order[3:6] == [spans.EVAL, spans.TRIP, spans.READ]
    assert order[-3:] == [spans.READ, spans.ASSEMBLE, spans.ASSEMBLE]
    assert len({s[3] for s in rec.spans}) == len(rec.spans)


def test_two_solves_get_two_ids():
    with cns.record_spans() as rec:
        solve()
        solve(starts(seed=4))
    roots = [s for s in rec.spans if s[0] == spans.SOLVE]
    assert len(roots) == 2 and roots[0][5] != roots[1][5]
    for root in roots:
        assert sum(1 for s in rec.spans if s[5] == root[5]) > 3
    assert roots[0][2] <= roots[1][1]


def test_the_clock_is_the_profilers():
    from torch.profiler import ProfilerActivity, profile

    x = starts()
    with cns.record_spans() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with rec.span("probe"):
                y = torch.add(x, x)
            solve(x, stopping=cns.default_stopping(torch.float64).replace(
                max_iterations=2))
    del y
    events = prof.profiler.kineto_results.events()
    (probe,) = [s for s in rec.spans if s[0] == "probe"]
    adds = [e.start_ns() for e in events if e.name() == "aten::add"]
    assert any(probe[1] <= t <= probe[2] for t in adds)
    # Each status read's reduction starts inside its cns.read span.
    reads = [s for s in rec.spans if s[0] == spans.READ]
    anys = sorted(e.start_ns() for e in events if e.name() == "aten::any")
    assert reads and all(any(a <= t <= b for t in anys)
                         for _, a, b, *_ in reads)


def test_without_a_recorder_the_loop_reads_no_clock(monkeypatch):
    calls = []

    def clock():
        calls.append(1)
        return 0

    monkeypatch.setattr(spans, "clock_ns", clock)
    assert spans.recorder() is None
    solve()
    assert calls == []
    with cns.record_spans():
        res = solve()
    # Three stamps a trip, two more for the last read, two a span for
    # the solve, the start's evaluation, the set-up and the two assemblies.
    assert len(calls) == 3 * res.trips + 2 + 2 * 5


def test_the_recorder_is_uninstalled_and_spans_closed_on_error():
    def broken(x):
        raise RuntimeError("objective failed")

    obj = cns.objective(broken)
    with cns.record_spans() as outer:
        with cns.record_spans() as inner:
            with pytest.raises(RuntimeError, match="objective failed"):
                cns.minimize_batched(obj, starts(), cns.Lbfgs(),
                                     device="cpu")
        assert spans.recorder() is outer
        solve()
    assert spans.recorder() is None
    assert [s[0] for s in inner.spans] == [spans.EVAL, spans.SOLVE]
    assert inner._open == [] and names(outer)[spans.SOLVE] == 1


def test_the_iteration_granular_loop_records_the_solve_alone():
    with cns.record_spans() as rec:
        res = solve(trace=2)
    assert res.trace is not None
    assert names(rec) == {spans.SOLVE: 1, spans.EVAL: 1}


def test_minimize_is_a_recorded_batch_of_one():
    with cns.record_spans() as rec:
        res = cns.minimize(cns.models.rosenbrock(),
                           torch.tensor([-1.2, 1.0], dtype=torch.float64),
                           cns.Lbfgs(), device="cpu")
    got = names(rec)
    assert got[spans.SOLVE] == 1 and got[spans.TRIP] == res.trips > 0


def test_the_rings_history_is_freed_before_the_internals_are_made(
        monkeypatch):
    """The solver's internals (``init_batched``) are made after the flat
    solve has returned and its ring buffers are gone, recorded or not: the
    peak holds one history pair less."""
    import weakref

    from cppnumericalsolvers_tpu_torch.ops import flat_solve as fs
    from cppnumericalsolvers_tpu_torch.solvers import lbfgs

    rings, alive = [], []
    init, made = fs.init_flat_state, lbfgs.Lbfgs.init_batched

    def init_flat_state(*args):
        st, x_trial = init(*args)
        rings.extend((weakref.ref(st.s), weakref.ref(st.y)))
        return st, x_trial

    def init_batched(self, *args, **kwargs):
        alive.append([r() is not None for r in rings])
        return made(self, *args, **kwargs)

    monkeypatch.setattr(fs, "init_flat_state", init_flat_state)
    monkeypatch.setattr(lbfgs.Lbfgs, "init_batched", init_batched)
    for recorded in (False, True):
        rings.clear()
        with cns.record_spans() if recorded else contextlib.nullcontext():
            solve()
        assert alive[-1] == [False, False], recorded
