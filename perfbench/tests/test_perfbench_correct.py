"""A whole run on the CPU at a size a test can hold (the look for a card
skipped): a sound run comes out correct, and the lower-precision control
and each fault a cell can have, planted in the timed path, come out not
correct.  The faults: a step that leaves its state unchanged, half of the
batch left out (reported stopped where it started), an answer altered where
it is produced (the step's trial point), and two of the full history: a
history that stops taking pairs once full, and a push that drops the newest
row where it should drop the oldest."""

import argparse
import json
import time

import pytest
import torch

from cppnumericalsolvers_tpu_torch.ops import flat_solve as fs
from perfbench import bench, calibrate

#: Each cell at its own width with a small batch.
SMALL = {"batch": 16}
CELLS = ["rosen4096.wide_b32768", "rosen32.wide_b4194304",
         "rosen4096.near_b32768"]


@pytest.fixture(autouse=True)
def short_build(monkeypatch):
    monkeypatch.setattr(bench, "BUILD_S", 0.0)
    # The test process holds the repository's harnesses, which other tests
    # import; test_perfbench_imports holds the run-time check itself.
    monkeypatch.setattr(bench, "forbidden_modules", lambda names=None: [])


def run(capsys, workload, trace=0, seconds=0.5, hook=None, seed=2**31 + 7,
        grace=30.0):
    torch.set_num_threads(1)
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace)

    def cell_hook(cell):
        cell.grace_s = grace
        if hook:
            hook(cell)

    rc = bench.main(args, time.perf_counter(), device="cpu",
                    overrides=SMALL, cell_hook=cell_hook)
    out = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert out.err.strip().splitlines()[-1].startswith("check f_final")
    return line


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(capsys, workload):
    line = run(capsys, workload)
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"solves_per_s", "setup_s"}
    for k, v in line["checks"].items():
        assert 0 <= v["value"] <= v["limit"], k


def test_traced_run_reads_per_layer_metrics_only(capsys):
    line = run(capsys, CELLS[0], trace=1)
    assert line["correct"] is True
    assert "solves_per_s" not in line["metrics"]
    # On the CPU there is no device trace; the counter is still read.
    assert set(line["metrics"]) == {"loop.trips_per_solve"}


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(capsys, workload):
    line = run(capsys, workload, hook=lambda c: c.with_evaluation(
        calibrate.control_fn(c.base)))
    assert line["correct"] is False
    assert any(v["value"] is None or v["value"] > v["limit"]
               for v in line["checks"].values())


def unchanged(st, f_t, g_t, x_trial, stopping, max_fev):
    return None


def half_left_out(st, f_t, g_t, x_trial, stopping, max_fev):
    before, trial = st.clone(), x_trial.clone()
    fs.flat_trip_reference(st, f_t, g_t, x_trial, stopping, max_fev)
    h = st.x0.shape[0] // 2
    for k, v in vars(before).items():
        getattr(st, k)[h:] = v[h:]
    st.si[h:, 5] = 4  # reported stopped on the gradient norm
    x_trial[h:] = trial[h:]


def altered(st, f_t, g_t, x_trial, stopping, max_fev):
    fs.flat_trip_reference(st, f_t, g_t, x_trial, stopping, max_fev)
    x_trial[:, 0] *= 1.001


def history_frozen(st, f_t, g_t, x_trial, stopping, max_fev):
    full = st.si[:, fs._I_COUNT] >= st.s.shape[1]
    s, y, head = st.s.clone(), st.y.clone(), st.si[:, fs._I_HEAD].clone()
    fs.flat_trip_reference(st, f_t, g_t, x_trial, stopping, max_fev)
    st.s[full], st.y[full], st.si[full, fs._I_HEAD] = s[full], y[full], \
        head[full]


def newest_dropped(st, f_t, g_t, x_trial, stopping, max_fev):
    m = st.s.shape[1]
    head = st.si[:, fs._I_HEAD].clone()
    s, y = st.s.clone(), st.y.clone()
    fs.flat_trip_reference(st, f_t, g_t, x_trial, stopping, max_fev)
    # A push into a full ring wrote the oldest row and moved the head; put
    # the oldest back and write the new pair over the newest instead.
    lanes = (st.si[:, fs._I_HEAD] != head).nonzero().flatten()
    for b in lanes.tolist():
        h = int(head[b])
        newest = (h - 1) % m
        st.s[b, newest], st.y[b, newest] = st.s[b, h].clone(), st.y[b, h]
        st.s[b, h], st.y[b, h] = s[b, h], y[b, h]
        st.si[b, fs._I_HEAD] = h


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered,
                                   history_frozen, newest_dropped])
def test_planted_fault_is_not_correct(capsys, monkeypatch, fault):
    monkeypatch.setattr(fs, "flat_trip", fault)
    line = run(capsys, CELLS[1], grace=3.0)
    assert line["correct"] is False
