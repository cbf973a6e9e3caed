"""The model-sharded path's launch and check on the CPU: four gloo ranks on
a cell at n = 4096 (the look for a card skipped), written with its files
into a root of its own beside the benchmark's cells.  A sound run reaches rank 0's line
with ``correct`` true and nothing on standard output from the other ranks;
a rank that fails or is late ends the run, non-zero, within its limit; the
lower-precision control and each fault the cell can have, planted in the
timed path, come out not correct: a step that leaves its state unchanged,
an answer altered where it is produced (one rank's gradient shard scaled)
and the exchange between the cards left out (the two-loop's dots summed
over each rank's shard alone).  So does a solve whose evaluations the
recorder does not all see.  The batched cells keep the flat loop."""

import argparse
import json
import subprocess
import sys
import time

import pytest
import torch

from perfbench import bench, calibrate, launch
from perfbench.tests.test_perfbench_correct import CELLS as BATCHED

CELL = "rosen4096x4.near_b1"
CONFIG = {
    "name": "mgh21-rosenbrock-n4096-model4",
    "problem": "mgh21_rosenbrock",
    "n": 4096,
    "dtype": "float32",
    "path": "model_sharded",
    "cards": 4,
    "solver": {"name": "Lbfgs", "m": 10, "max_linesearch_fev": 20},
    "reduced": [],
}
TRAFFIC = {
    "batch": 1,
    "start": [{"share": 1.0, "centre": "minimiser", "half_width": 0.25}],
    "check": {"solves": 8, "lanes_per_solve": 1, "trips": 24},
}
LIMITS = {"step_gap": 1e-3, "eval_gap": 1e-2, "f_final": 1e3}
#: Per-layer metrics of the model-sharded path; the cell joins these too.
COMM = ("comm.device_pct", "comm.collectives_per_iter")
SHARED = ("loop.trips_per_solve", "eval.roofline_pct", "step.roofline_pct",
          "device.idle_pct")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A root holding ``BENCHMARK.json`` with the model-sharded cell added
    to the benchmark's own, and that cell's files under ``perfbench/``."""
    root = tmp_path_factory.mktemp("sharded_root")
    spec = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
    conf = f"perfbench/configs/{CONFIG['name']}.json"
    spec["configs"].append({"name": CONFIG["name"], "source": "MGH 21",
                            "file": conf, "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": CELL, "config": CONFIG["name"],
                              "traffic": "near_b1", "chips": 4,
                              "why": "tests"})
    for m in spec["per_layer"]:
        if m["name"] in SHARED:
            m["workloads"].append(CELL)
    for name, unit in zip(COMM, ("%", "launches")):
        spec["per_layer"].append({
            "name": name, "unit": unit, "better": "lower",
            "source": "device_trace", "layer": "comm",
            "moves": "solves_per_s", "workloads": [CELL]})
    for rel, data in ((conf, CONFIG),
                      ("perfbench/traffic/near_b1.json", TRAFFIC),
                      (f"perfbench/limits/{CELL}.json", LIMITS),
                      ("BENCHMARK.json", spec)):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(json.dumps(data))
    return root


def run(capfd, root, trace=0, seconds=0.5, hook=None, limit_s=120.0):
    args = argparse.Namespace(workload=CELL, seed=2**31 + 11,
                              seconds=seconds, trace=trace)
    t0 = time.perf_counter()
    rc = launch.main(args, t0, device="cpu", cell_hook=hook,
                     limit_s=limit_s, root=root)
    out = capfd.readouterr()
    return rc, out, time.perf_counter() - t0


def line_of(rc, out):
    assert rc == 0, out.err[-3000:]
    lines = out.out.strip().splitlines()
    assert len(lines) == 1, out.out
    line = json.loads(lines[0])
    assert list(line)[-1] == "checks"
    assert out.err.strip().splitlines()[-1].startswith("check f_final")
    return line


# The hooks run in every rank, after the cell is built; they are found by
# name in each rank's fresh interpreter.

def control(cell):
    cell.with_evaluation(calibrate.control_fn(cell.base))


def unchanged(cell):
    import cppnumericalsolvers_tpu_torch as cns

    step = cns.Lbfgs.step

    def stays(self, objective, state, internals, stopping, done=None):
        _, internals, trips = step(self, objective, state, internals,
                                   stopping, done)
        return state, internals, trips

    cns.Lbfgs.step = stays


def gradient_scaled(cell):
    from cppnumericalsolvers_tpu_torch.parallel import model_sharded as ms

    if cell.rank != 1:
        return
    evaluate = ms._ShardedObjective.batched_value_and_grad

    def scaled(self, x):
        f, g = evaluate(self, x)
        return f, 1.5 * g

    ms._ShardedObjective.batched_value_and_grad = scaled


def exchange_left_out(cell):
    from cppnumericalsolvers_tpu_torch.core import tree
    from cppnumericalsolvers_tpu_torch.ops import two_loop

    direction = two_loop.two_loop_direction_reference

    def local(*args):
        with tree.model_axis_group(None):
            return direction(*args)

    two_loop.two_loop_direction_reference = local


def recorder_bypassed(cell):
    import cppnumericalsolvers_tpu_torch as cns

    type(cell.solver).step = cns.Lbfgs.step


def fails_on_rank_2(cell):
    if cell.rank == 2:
        raise RuntimeError("a planted failure on rank 2")


def late_on_rank_3(cell):
    if cell.rank == 3:
        time.sleep(300)


def test_sound_run_is_correct_and_only_rank_0_prints(capfd, root):
    line = line_of(*run(capfd, root)[:2])
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"solves_per_s", "setup_s"}
    assert line["device"]["count"] == 4
    for k, v in line["checks"].items():
        assert 0 <= v["value"] <= v["limit"], k


def test_traced_run_reads_per_layer_metrics_only(capfd, root):
    line = line_of(*run(capfd, root, trace=1)[:2])
    assert line["correct"] is True
    # On the CPU there is no device trace; the counter is still read.
    assert set(line["metrics"]) == {"loop.trips_per_solve"}


@pytest.mark.parametrize("fault", [control, unchanged, gradient_scaled,
                                   exchange_left_out])
def test_planted_fault_is_not_correct(capfd, root, fault):
    line = line_of(*run(capfd, root, hook=fault)[:2])
    assert line["correct"] is False
    assert any(v["value"] is None or v["value"] > v["limit"]
               for v in line["checks"].values())


def test_evaluations_the_recorder_misses_are_not_correct(capfd, root):
    """Each step's evaluations taken past the recorder: the trips it would
    have checked go unseen, so the run is not correct, though every number
    it could still read lies within its limit."""
    rc, out, _ = run(capfd, root, hook=recorder_bypassed)
    line = line_of(rc, out)
    assert line["correct"] is False and line["failed"] == 0
    assert all(v["value"] is None for v in line["checks"].values())
    assert "did not see every evaluation" in out.err


def test_a_failing_rank_ends_the_run(capfd, root):
    rc, out, took = run(capfd, root, hook=fails_on_rank_2)
    assert rc != 0 and not out.out.strip()
    assert "a planted failure on rank 2" in out.err
    assert took < 60


def test_a_late_rank_ends_the_run_at_its_limit(capfd, root):
    rc, out, took = run(capfd, root, hook=late_on_rank_3, limit_s=20.0)
    assert rc == launch.LATE and not out.out.strip()
    assert took < 40


def test_the_sharded_reference_is_the_whole_one_split():
    """Four ranks' float64 trips, each on its own coordinates, make the
    trial points of the reference run on whole lanes, to the rounding of
    sums taken in another order."""
    rc, rows = _reference_ranks()
    assert rc == 0 and rows == [True]


@pytest.mark.parametrize("workload", BATCHED)
def test_batched_cells_keep_the_flat_loop(workload):
    import cppnumericalsolvers_tpu_torch as cns

    cell = bench.Cell(workload, "cpu")
    assert not launch.is_sharded(workload)
    assert cell.minimize is cns.minimize_batched
    assert type(cell.solver) is cns.Lbfgs
    assert cell.solver.supports_solve_batched(cell.objective)
    assert type(cell.objective).__mro__[1] is cns.Objective


def test_the_launcher_imports_no_torch(root):
    """The launching process only starts and watches the ranks; torch is
    imported in each rank alone."""
    code = ("import sys; from pathlib import Path; "
            "from perfbench import launch; "
            "assert launch.is_sharded(%r, Path(%r)); "
            "assert 'torch' not in sys.modules" % (CELL, str(root)))
    subprocess.run([sys.executable, "-c", code], cwd=bench.ROOT, check=True,
                   timeout=60)


def test_without_cards_the_run_exits_with_no_result(root):
    """A model-sharded run that asks for CUDA cards where there are none:
    every rank refuses and nothing reaches stdout."""
    import os

    code = ("import argparse, sys, time; from pathlib import Path; "
            "from perfbench import launch; "
            "a = argparse.Namespace(workload=%r, seed=2**31 + 5, "
            "seconds=1.0, trace=0); "
            "sys.exit(launch.main(a, time.perf_counter(), root=Path(%r)))"
            % (CELL, str(root)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=bench.ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and not proc.stdout.strip()
    assert "CUDA cards" in proc.stderr


def test_calibration_rows_of_a_sharded_cell(root):
    """``calibrate.py``'s path for a model-sharded cell: one row a seed,
    from one set of ranks, correct for the program and not for the
    control."""
    for control in (False, True):
        args = argparse.Namespace(workload=CELL, seconds=0.3, seeds="21,22",
                                  control=control)
        rows = launch.calibrate(args, "cpu", root=root)
        assert [r["seed"] for r in rows] == [21, 22]
        assert all(r["correct"] is not control for r in rows)


def test_unknown_cell_is_not_sharded(root):
    assert not launch.is_sharded("no.such_cell")
    assert not launch.is_sharded(CELL)
    assert launch.is_sharded(CELL, root)
    assert not any(launch.is_sharded(c) for c in BATCHED)


# -- the sharded reference against the whole one --------------------------


def _reference_ranks():
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    rows = ctx.SimpleQueue()
    port = launch.free_port()
    procs = [ctx.Process(target=_reference_rank, args=(r, port, rows))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    out = []
    while not rows.empty():
        out.append(rows.get())
    return max(p.exitcode for p in procs), out


def _reference_rank(rank, port, rows):
    import torch.distributed as dist

    from perfbench.reference import lbfgs_trip
    from perfbench.reference import mgh21_rosenbrock as mgh21

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=4, rank=rank)
    gen = torch.Generator().manual_seed(3)
    x = 1.0 + 0.5 * torch.rand(2, 64, generator=gen, dtype=torch.float64) - 0.25
    cut = slice(16 * rank, 16 * rank + 16)
    stop = lbfgs_trip.Stopping()

    def follow(x, total):
        f, g = mgh21.value_and_grad(x)
        st, trial = lbfgs_trip.init_state(x, total(f), g, 10, 20)
        points = [trial]
        for _ in range(30):
            f, g = mgh21.value_and_grad(trial)
            trial = lbfgs_trip.trip(st, total(f), g, trial, stop, 20)
            points.append(trial)
        return torch.stack(points)

    whole = follow(x, lambda f: f)[..., cut]

    def over_ranks(f):
        dist.all_reduce(f)
        return f

    with lbfgs_trip.over_ranks(dist.group.WORLD):
        split = follow(x[:, cut].contiguous(), over_ranks)
    # Sums in another order; 30 trips run free from the start.
    same = torch.allclose(split, whole, rtol=0, atol=1e-10)
    flags = [None] * 4
    dist.all_gather_object(flags, same)
    if rank == 0:
        rows.put(all(flags))
    dist.destroy_process_group()
