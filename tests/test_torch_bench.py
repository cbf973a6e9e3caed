"""``bench_torch.py``'s legs at toy sizes on the CPU.

Each leg function runs with ``device="cpu"``: its row must carry the keys
the bench line reports, and its iteration count must be that of the same
solve called directly (``minimize_batched``, ``AugmentedLagrangian``).  The
device figures of a CPU run are None, never a number: times on the card
come only from ``python3 bench_torch.py`` there, which with no card prints
nothing on stdout and exits 1.
"""

import numpy as np
import pytest
import torch

import bench_torch
from benchmarks_torch import legs
import cppnumericalsolvers_tpu_torch as cns

torch.set_num_threads(1)

LEG_KEYS = {"solver", "config", "shape", "dtype", "cut", "wall_s",
            "iterations", "evaluations", "host_reads", "reads_per_iteration",
            "launches"}
GRID_KEYS = {"B", "n", "trips", "lane_iters_per_s", "host_ms_per_trip",
             "wall_s", "batched_iterations", "flat_trip_device_ms_per_trip",
             "eval_device_ms_per_trip", "bytes_per_trip", "launches"}
#: Toy widths for each leg of SOLVER_RUNS (pairwise objective: even n).
TOY = (6, 8)


def start(b, n, dtype=torch.float32):
    x0 = np.random.default_rng(bench_torch.SEED).uniform(-2.0, 2.0, (b, n))
    return torch.from_numpy(x0).to(dtype)


def test_main_without_a_card_prints_nothing_and_exits_1(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main() == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "no CUDA device" in out.err


def test_grid_row_on_the_cpu():
    row = bench_torch.grid_row(8, 16, "cpu", reps=1)
    assert GRID_KEYS <= set(row)
    assert row["flat_trip_device_ms_per_trip"] is None
    assert row["eval_device_ms_per_trip"] is None
    assert "bound_ms" not in row  # no device time, no bound
    res = cns.minimize_batched(
        cns.models.pairwise_rosenbrock(), start(8, 16),
        cns.Lbfgs(m=bench_torch.M, max_linesearch_fev=bench_torch.MAX_FEV),
        cns.default_stopping(torch.float32), device="cpu")
    assert row["trips"] == res.trips
    assert row["batched_iterations"] == int(
        res.progress.num_iterations.max())
    assert row["lane_iterations"] == int(res.progress.num_iterations.sum())
    assert row["lane_iters_per_s"] > 0 and row["launches"] == {}


def test_grid_bounds_with_the_inputs_passed_in():
    """The bounds a grid row gets on the card, here from an evaluation
    time and a trip floor passed in: the keys it had keep their values,
    ``trip_bound``'s keys keep their meaning, and the attainable bound of a
    batched iteration is ``roofline.analyze_shape``'s."""
    from benchmarks_torch import roofline

    row = bench_torch.grid_row(8, 16, "cpu", reps=1)
    before = dict(row)
    card = roofline.card_params()
    eval_ms, trip_ms = 0.04, 0.7
    assert bench_torch.grid_bounds(row, card, eval_ms, trip_ms) is row
    assert {k: row[k] for k in before} == before
    bound = roofline.trip_bound(row["trips"], row["bytes_per_trip"], eval_ms,
                                trip_ms)
    assert {k: row[k] for k in bound} == bound
    assert row["bound_share"] == bound["bound_ms"] / (row["wall_s"] * 1e3)
    its = row["batched_iterations"]
    want = roofline.analyze_shape(
        {"batch": 8, "n": 16, "nfev_per_iter": row["trips"] / its,
         "per_batched_iter_ms": row["wall_s"] * 1e3 / its},
        card, eval_ms, trip_ms)
    for key in ("attainable_ms", "pct_of_attainable", "bottleneck"):
        assert row[key] == want[key]
    assert row["bottleneck"] in roofline.LABELS
    # Per trip the attainable time holds at least the two measured floors.
    assert row["attainable_ms"] >= row["trips"] / its * (eval_ms + trip_ms)


@pytest.mark.parametrize("run", legs.SOLVER_RUNS,
                         ids=[r[0] + "_" + str(r[3][0]) for r in
                              legs.SOLVER_RUNS])
def test_solver_leg_on_the_cpu(run):
    label, cls, kw, _, mode, conservative, cut, _ = run
    toy = (label, cls, kw, TOY, mode, conservative, min(cut, 20) if cut
           else 0, run[7])
    row = bench_torch.solver_leg(toy, "cpu")
    assert LEG_KEYS <= set(row)
    assert row["solver"] == label and row["shape"] == list(TOY)
    solver = getattr(cns, cls)(**kw)
    obj = cns.models.pairwise_rosenbrock()
    tobj = obj if mode == "second" else obj.with_mode(mode)
    stop = (cns.conservative_stopping(torch.float32) if conservative
            else solver.default_stopping(torch.float32))
    if toy[6]:
        stop = stop.replace(max_iterations=toy[6])
    res = cns.minimize_batched(tobj, start(*TOY), solver, stop, device="cpu")
    assert row["iterations"] == int(res.progress.num_iterations.max())
    assert row["evaluations"] == res.trips
    assert row["launches"] == {}


@pytest.mark.parametrize("label", sorted({r[0]
                                          for r in legs.LBFGSB_RUNS}))
def test_lbfgsb_leg_on_the_cpu(label):
    row = bench_torch.lbfgsb_leg(label, TOY, "cpu")
    assert LEG_KEYS | {"cauchy_passes_per_iteration"} <= set(row)
    solver = cns.Lbfgsb(m=5, lower=legs.LBFGSB_BOX[0],
                        upper=legs.LBFGSB_BOX[1])
    internals = None
    if label == "lane_boxes":
        b, n = TOY
        half = torch.arange(b)[:, None] < b // 2
        box = legs.LANE_BOXES
        internals = solver.make_internals(
            n, torch.float32,
            torch.where(half, box[0][0], box[1][0]).expand(b, n),
            torch.where(half, box[0][1], box[1][1]).expand(b, n))
    res = cns.minimize_batched(cns.models.pairwise_rosenbrock(), start(*TOY),
                               solver, solver.default_stopping(torch.float32),
                               internals=internals, device="cpu")
    assert row["iterations"] == int(res.progress.num_iterations.max())
    assert row["evaluations"] == res.trips


def test_al_leg_on_the_cpu():
    shape, budget = (4, 16), (2, 5)
    row = bench_torch.al_leg("cpu", shape, budget)
    assert {"batch", "n", "wall_s", "outer_iterations", "inner_iterations",
            "evaluations", "reads_per_inner_iteration", "launches",
            "max_violation"} <= set(row)
    inner = cns.Lbfgs(m=bench_torch.M)
    res = cns.AugmentedLagrangian(inner_solver=inner).minimize_batched(
        legs.al_leg_problem(cns, shape[1]), start(*shape),
        stopping=cns.default_stopping(torch.float32).replace(
            max_iterations=budget[0]),
        inner_stopping=inner.default_stopping(torch.float32).replace(
            max_iterations=budget[1]), device="cpu")
    assert row["outer_iterations"] == int(res.progress.num_iterations.max())
    assert row["inner_iterations"] == res.inner_iterations
    assert row["evaluations"] == res.trips


def test_reliability_sums_the_single_solve(monkeypatch):
    """The reliability leg's figures from ``suite_bench.single_solve``'s
    records (a stand-in with two problems)."""
    import suite_bench

    def fake(device):
        recs = [{"ok": np.array([True, False]), "nfev": np.array([10., 30.])},
                {"ok": np.array([True, True, True]),
                 "nfev": np.array([5., 5., 5.])}]
        return {"records": recs, "float32": [
            {"ok": np.array([True, False])}, {"ok": np.array([True, True,
                                                               False])}],
            "f32_wall_s": 1.0, "f64_wall_s": 0.5}

    monkeypatch.setattr(suite_bench, "single_solve", fake)
    rel = bench_torch.reliability("cpu")
    assert rel["total_instances"] == 5 and rel["converged_single_solve"] == 4
    assert rel["converged_pct_single_solve"] == pytest.approx(80.0)
    assert rel["mean_nfev_single_solve"] == pytest.approx(11.0)
    assert rel["instances_resolved_in_f64"] == 1
    assert rel["instances_attempted_in_f64"] == 2
