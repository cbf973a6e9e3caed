"""The reduction of a capture, on made-up profiler events: attribution by
correlation id to the benchmark's spans, the busy union, the idle gaps."""

import pytest
from torch.autograd import DeviceType

from perfbench import trace


class Ev:
    def __init__(self, name, dev, start, end, corr):
        self._v = (name, dev, start, end, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


CPU, GPU = DeviceType.CPU, DeviceType.CUDA


def test_attribution_busy_and_gaps():
    spans = {trace.SOLVE: [(0, 100), (120, 200)],
             trace.EVAL: [(5, 30), (125, 150)],
             trace.BETWEEN: [(100, 120)]}
    events = [
        Ev("cudaLaunchKernel", CPU, 6, 7, 1), Ev("add", GPU, 10, 40, 1),
        Ev("cudaLaunchKernel", CPU, 35, 36, 2), Ev("flat_trip", GPU, 40, 90, 2),
        Ev("cudaLaunchKernel", CPU, 101, 102, 3), Ev("sum", GPU, 105, 110, 3),
        Ev("cudaLaunchKernel", CPU, 126, 127, 4), Ev("add", GPU, 130, 160, 4),
        Ev("lost", GPU, 170, 180, 99),
        Ev("cudaLaunchKernel", CPU, 300, 301, 5), Ev("late", GPU, 300, 310, 5),
    ]
    s = trace.reduce(events, spans)
    assert s.window_s == pytest.approx(200e-9)
    assert s.busy_s == pytest.approx((80 + 5 + 30 + 10) * 1e-9)
    assert s.eval_s == pytest.approx(60e-9)
    assert s.step_s == pytest.approx(50e-9)
    assert s.other_s == pytest.approx(5e-9)
    assert s.unattributed_s == pytest.approx(10e-9)
    assert s.ops[0] == ("add", pytest.approx(60e-9))
    gaps = dict((k, v) for k, v in s.gaps if k.endswith(".total"))
    assert gaps["eval.total"] == pytest.approx(30e-9)
    assert gaps["between_solves.total"] == pytest.approx(15e-9)
    assert gaps["eval.total"] + gaps["between_solves.total"] + gaps[
        "unattributed.total"] + gaps["window_end.total"] == pytest.approx(
        (200 - 125) * 1e-9)


def test_nothing_to_read():
    assert trace.reduce([], {trace.SOLVE: [(0, 1)], trace.EVAL: [],
                             trace.BETWEEN: []}) is None
    assert trace.reduce([Ev("k", GPU, 0, 1, 1)], {
        trace.SOLVE: [], trace.EVAL: [], trace.BETWEEN: []}) is None
