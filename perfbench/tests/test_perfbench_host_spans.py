"""The split of a capture by the program's host spans (``host_spans``), on
made-up profiler events as ``test_perfbench_trace`` makes them: each idle
nanosecond in the bucket of the innermost span, the buckets summing to the
window's idle, the device time launched in the carry's set-up and the
result's assembly, the readers, and the traced run with the recorder."""

import argparse
import types

import pytest
import torch

from perfbench import bench, host_spans, spans_run, trace
from perfbench.tests.test_perfbench_trace import CPU, GPU, Ev

BENCH = {trace.SOLVE: [(0, 100)], trace.EVAL: [(3, 10), (25, 40)],
         trace.BETWEEN: []}
PROGRAM = [  # (name, start, end, span_id, parent_id, solve_id)
    ("cns.eval", 3, 10, 2, 1, 1), ("cns.init", 10, 20, 3, 1, 1),
    ("cns.read", 20, 25, 4, 1, 1), ("cns.eval", 25, 40, 5, 1, 1),
    ("cns.trip", 40, 45, 6, 1, 1), ("cns.read", 45, 58, 7, 1, 1),
    ("cns.assemble", 60, 90, 8, 1, 1), ("cns.solve", 2, 98, 1, None, 1),
]
EVENTS = [
    Ev("cudaLaunchKernel", CPU, 4, 5, 1), Ev("add", GPU, 12, 30, 1),
    Ev("cudaMemsetAsync", CPU, 12, 13, 2), Ev("zero", GPU, 30, 35, 2),
    Ev("cudaLaunchKernel", CPU, 41, 42, 3), Ev("flat_trip", GPU, 42, 55, 3),
    Ev("cudaLaunchKernel", CPU, 61, 62, 4), Ev("gather", GPU, 70, 80, 4),
    Ev("cudaLaunchKernel", CPU, 95, 96, 5), Ev("late", GPU, 99, 120, 5),
]


def test_idle_goes_to_the_innermost_span_and_sums_to_the_windows():
    h = host_spans.split(EVENTS, BENCH, PROGRAM)
    # Idle: [0, 12], [35, 42], [55, 70], [80, 99].
    want = {"eval": 7 + 5, "read": 3, "trip": 2, "solve": 1 + 2 + 8,
            "fixed": 2 + 10 + 10, "outside": 2 + 1}
    assert h.idle_s == pytest.approx({k: v * 1e-9 for k, v in want.items()})
    assert h.window_idle_s == pytest.approx(53e-9)
    assert sum(h.idle_s.values()) == pytest.approx(h.window_idle_s,
                                                   abs=1e-15)
    s = trace.reduce(EVENTS, BENCH)
    assert h.window_idle_s == pytest.approx(s.window_s - s.busy_s)
    assert (h.trips, h.solves) == (1, 1)
    assert h.first_eval_s == pytest.approx(7e-9)
    assert h.loop_s == pytest.approx(16e-9)
    assert "read 0.000000 s" in h.line() and "(loop 0.000000 s)" in h.line()


def test_device_time_launched_in_the_set_up_and_the_assembly():
    h = host_spans.split(EVENTS, BENCH, PROGRAM)
    assert h.fixed_device_s == pytest.approx((5 + 10) * 1e-9)
    run = types.SimpleNamespace(host_split=h)
    read = {m: bench._load(bench.HERE / "metrics" / f"{m}.py", m).read
            for m in spans_run.NEW_METRICS}
    assert read["eval.idle_ms_per_trip"](run) == pytest.approx(12e-6)
    assert read["loop.idle_ms_per_trip"](run) == pytest.approx(16e-6)
    assert read["step.per_solve_ms"](run) == pytest.approx(15e-6)
    assert read["eval.first_call_s"](run) == pytest.approx(7e-9)


def test_nested_spans_and_a_span_past_the_window():
    spans = [("outer", 0, 50, 1, None, 1), ("inner", 10, 20, 2, 1, 1),
             ("same_start", 10, 15, 3, 2, 1), ("past", 45, 200, 4, 1, 1)]
    assert host_spans.innermost(spans, 5, 100) == [
        (5, 10, "outer"), (10, 15, "same_start"), (15, 20, "inner"),
        (20, 45, "outer"), (45, 100, "past")]
    assert host_spans.innermost([], 0, 10) == [(0, 10, None)]


@pytest.mark.parametrize("reader", spans_run.NEW_METRICS)
def test_each_reader_finds_nothing_without_program_spans(reader):
    read = bench._load(bench.HERE / "metrics" / f"{reader}.py", reader).read
    assert read(types.SimpleNamespace()) is None
    assert read(types.SimpleNamespace(host_split=None)) is None
    assert host_spans.split(EVENTS, BENCH, []) is None
    assert host_spans.split([], BENCH, PROGRAM) is None
    assert host_spans.split(EVENTS, {trace.SOLVE: []}, PROGRAM) is None


def test_reduce_reads_the_same_beside_the_split():
    before = trace.reduce(EVENTS, BENCH)
    host_spans.split(EVENTS, BENCH, PROGRAM)
    assert trace.reduce(EVENTS, BENCH) == before
    assert before.busy_s == pytest.approx(47e-9)
    assert before.eval_s == pytest.approx(18e-9)
    assert dict(g for g in before.gaps if g[0].endswith(".total")) == {
        "eval.total": pytest.approx(12e-9),
        "loop.total": pytest.approx((7 + 15 + 19) * 1e-9)}


def test_the_traced_run_with_the_recorder_on_the_cpu(capsys):
    torch.set_num_threads(1)
    args = argparse.Namespace(workload="rosen32.wide_b4194304",
                              seed=2**31 + 11, seconds=0.3, recorder=1)
    line = spans_run.cell_run(args, device="cpu", overrides={"batch": 16})
    # The CPU capture holds no device operation, so the split is None and
    # only the recorder's spans show.
    assert line["program_spans"] > 3 * line["trips"]
    assert line["correct"] is True
    assert not set(spans_run.NEW_METRICS) & set(line["metrics"])
    line0 = spans_run.cell_run(argparse.Namespace(**{**vars(args),
                                                     "recorder": 0}),
                               device="cpu", overrides={"batch": 16})
    assert line0["program_spans"] == 0 and line0["trips"] > 0


def test_the_recorders_cost_on_the_cpu():
    out = spans_run.cost(argparse.Namespace(seed=2**31 + 5, rounds=1),
                         device="cpu", batch=16, n=32)
    for k in ("untraced", "untraced_recorder", "traced", "traced_recorder"):
        assert len(out[f"{k}_us_per_trip"]) == 1
        assert out[f"{k}_us_per_trip_median"] > 0
    assert 0 < out["recorder_alone_us_per_trip"] < 1e3
