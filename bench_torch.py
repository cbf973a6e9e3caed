#!/usr/bin/env python3
"""The PyTorch/CUDA port's bench legs on one GPU, as one JSON line.

    python3 bench_torch.py         # from the repository root; needs one GPU
    python3 bench_torch.py --legs  # the L-BFGS-B and AL legs alone

The port's counterpart of bench.py (which stays the JAX package's): it
builds the kernels, runs the legs below on the card and prints one JSON
object on stdout, keeping bench.py's key wherever a key means the same
(bench.py:515-576); progress goes to stderr.  With no CUDA device it prints
nothing on stdout and exits 1: nothing runs on the CPU.

* Reliability (``metric``, ``value``, ``total_instances``,
  ``mean_nfev_single_solve``): the MGH-376 single solve of
  ``suite_bench.single_solve`` (bench.py's protocol, float32 first, float64
  fallback).
* ``perf_grid``: one row per shape of ``benchmarks_torch.roofline.GRID``, a
  full float32 solve of the pairwise extended Rosenbrock from seed 0 with
  ``Lbfgs(m=10)`` (the flat solve, one ``flat_trip`` launch a trip):
  lane-iterations per second (summed iterations over the host-clock time of
  a solve ending in ``synchronize()``, the median of GRID_REPS after a warm
  solve), trips and host ms a trip, ``flat_trip``'s and the evaluation's
  device ms a trip (``torch.profiler``), the bound with its binding
  term (``roofline.trip_bound``) and its share of the measured time, and
  the attainable time of a batched iteration with its share of the
  measured one and its bottleneck (``roofline.analyze_shape``:
  ``attainable_ms``, ``pct_of_attainable``, ``bottleneck``);
  ``batched_iters_per_s`` is the (1024, 32) row's rate.
* ``solver_legs`` and ``al_leg``: the other solvers, L-BFGS-B and the
  augmented-Lagrangian leg at the shapes and cuts of
  ``benchmarks_torch.legs`` (bench.py:419-512), which ``chip_smoke.py``'s
  ``solvers_main`` and ``constrained_main`` run too, one float32 solve
  each by host clock: wall, iterations, device-to-host reads an iteration,
  launches.  ``--legs`` runs the L-BFGS-B legs and the AL leg alone, after
  one untimed L-BFGS-B solve (one line with ``solver_legs``, ``al_leg``
  and ``device``), to time them against another checkout of the
  package.
* ``calibration``: the trip floor (host and device microseconds a trip)
  and the launch floor (host and CUDA-graph microseconds a launch) of
  ``benchmarks_torch.roofline``.
* ``device``: the card's name and power limit (nvidia-smi), its name from
  torch and the device count.

The line is also written to ``chiprun_out/bench_torch.json``.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
GRID_REPS = 3
#: The flat solve of the grid (chip_smoke.py's main path).
M = 10
MAX_FEV = 20
BASELINE_CONVERGED_PCT = 95.0  # the reference's (its README.md:8-9)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _counters() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from cppnumericalsolvers_tpu_torch.ops import flat_solve as fs
    from cppnumericalsolvers_tpu_torch.ops import floors
    from cppnumericalsolvers_tpu_torch.ops import fused_linesearch as fl
    from cppnumericalsolvers_tpu_torch.ops import fused_step as fstep
    from cppnumericalsolvers_tpu_torch.ops import fused_step_t as ft
    from cppnumericalsolvers_tpu_torch.ops import two_loop as tl

    return {"flat_trip": fs.flat_trip, "mt_trip": fl.mt_trip,
            "lbfgs_prologue": fstep.lbfgs_prologue,
            "lbfgs_epilogue": fstep.lbfgs_epilogue,
            "lbfgs_prologue_t": ft.lbfgs_prologue_t,
            "push_two_loop": tl.lbfgs_push_and_direction,
            "two_loop": tl.two_loop_direction,
            "trip_floor": floors.trip_floor,
            "launch_floor": floors.launch_floor}


def counted(fn, device):
    """``fn()`` on the host clock, ending in ``synchronize()`` on a card,
    with the launch counts and the device-to-host reads set to 0 just
    before and read just after: ``(result, wall seconds, launches by
    kernel (those that launched), reads)``."""
    from cppnumericalsolvers_tpu_torch.core.tree import any_lane

    wrappers = _counters()
    _sync(device)
    for w in wrappers.values():
        w.launches = 0
    reads0 = any_lane.reads
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items() if w.launches}
    return out, wall, launches, any_lane.reads - reads0


def uniform_start(b, n, lo, hi, dtype, device):
    import numpy as np
    import torch

    x0 = np.random.default_rng(SEED).uniform(lo, hi, (b, n))
    return torch.from_numpy(x0).to(device=device, dtype=dtype)


def _kernel_device_ms(prof, key) -> float | None:
    """Summed device ms of the profiled kernels whose name holds ``key``."""
    from torch.autograd import DeviceType

    total = sum(e.device_time_total for e in prof.events()
                if e.device_type == DeviceType.CUDA and key in e.name)
    return total / 1e3 if total else None


def grid_row(b, n, device="cuda", trip_floor_us=None, reps=GRID_REPS
             ) -> dict:
    """One shape of the throughput grid (see the module docstring).  On a
    card the device times come from ``torch.profiler`` and the bounds from
    ``trip_floor_us`` (:func:`grid_bounds`); elsewhere they are None (not
    measured)."""
    import torch

    import cppnumericalsolvers_tpu_torch as cns
    from benchmarks_torch import roofline

    obj = cns.models.pairwise_rosenbrock()
    solver = cns.Lbfgs(m=M, max_linesearch_fev=MAX_FEV)
    stop = cns.default_stopping(torch.float32)
    x0 = uniform_start(b, n, -2.0, 2.0, torch.float32, device)

    def solve():
        return cns.minimize_batched(obj, x0, solver, stop, device=device)

    solve()  # warm
    runs = [counted(solve, device) for _ in range(reps)]
    res, _, launches, reads = runs[-1]
    walls = [r[1] for r in runs]
    wall = statistics.median(walls)
    its = res.progress.num_iterations
    row = {
        "B": b, "n": n, "dtype": "float32", "trips": res.trips,
        "batched_iterations": int(its.max()),
        "lane_iterations": int(its.sum()),
        "wall_s": wall, "wall_s_runs": walls,
        "lane_iters_per_s": float(its.sum()) / wall,
        "host_ms_per_trip": wall / res.trips * 1e3,
        "launches": launches, "host_reads": reads,
        "flat_trip_device_ms_per_trip": None,
        "eval_device_ms_per_trip": None,
    }
    work = roofline.trip_work(obj, x0, stop, m=M, max_fev=MAX_FEV)
    row["bytes_per_trip"] = work["bytes_per_trip"]
    row["kernel_bound_ms_per_trip"] = work["bound_ms"]
    if torch.device(device).type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            solve()
            torch.cuda.synchronize()
        ms = _kernel_device_ms(prof, "flat_trip")
        row["flat_trip_device_ms_per_trip"] = (
            None if ms is None else ms / res.trips)
        row["eval_device_ms_per_trip"] = roofline.measure_eval_standalone(
            b, n, device=device)
    if trip_floor_us is not None and row["eval_device_ms_per_trip"]:
        grid_bounds(row, roofline.card_params(device),
                    row["eval_device_ms_per_trip"], trip_floor_us / 1e3)
    return row


def grid_bounds(row, card, eval_ms, trip_floor_ms) -> dict:
    """Add a grid row's bounds from the evaluation's device ms and the trip
    floor's ms: ``roofline.trip_bound``'s (``bound_ms``, ``bound_by``, its
    terms, ``bound_share`` of the solve's wall) and, for a batched
    iteration (the wall over the batched iterations, the trips over them
    as nfev), ``roofline.analyze_shape``'s ``attainable_ms``,
    ``pct_of_attainable`` and ``bottleneck``."""
    from benchmarks_torch import roofline

    bound = roofline.trip_bound(row["trips"], row["bytes_per_trip"],
                                eval_ms, trip_floor_ms)
    row.update(bound)
    row["bound_share"] = bound["bound_ms"] / (row["wall_s"] * 1e3)
    its = row["batched_iterations"]
    shape = roofline.analyze_shape(
        {"batch": row["B"], "n": row["n"],
         "nfev_per_iter": row["trips"] / its,
         "per_batched_iter_ms": row["wall_s"] * 1e3 / its},
        card, eval_ms, trip_floor_ms)
    for key in ("attainable_ms", "pct_of_attainable", "bottleneck"):
        row[key] = shape[key]
    return row


def solver_leg(run, device="cuda") -> dict:
    """One run of ``legs.SOLVER_RUNS``: its solver on the pairwise extended
    Rosenbrock from starts uniform in [-2, 2] (seed 0), float32, cut where
    the run says."""
    import torch

    import cppnumericalsolvers_tpu_torch as cns

    label, cls, kw, (b, n), mode, conservative, cut, _ = run
    solver = getattr(cns, cls)(**kw)
    obj = cns.models.pairwise_rosenbrock()
    tobj = obj if mode == "second" else obj.with_mode(mode)
    stop = (cns.conservative_stopping(torch.float32) if conservative
            else solver.default_stopping(torch.float32))
    if cut:
        stop = stop.replace(max_iterations=cut)
    x0 = uniform_start(b, n, -2.0, 2.0, torch.float32, device)
    res, wall, launches, reads = counted(
        lambda: cns.minimize_batched(tobj, x0, solver, stop, device=device),
        device)
    return _leg_row(label, f"{cls}({kw})", (b, n), cut, res, wall, launches,
                    reads)


def _leg_row(label, solver, shape, cut, res, wall, launches, reads,
             **extra) -> dict:
    its = int(res.progress.num_iterations.max())
    return {"solver": label, "config": solver, "shape": list(shape),
            "dtype": "float32", "cut": cut, "wall_s": wall,
            "iterations": its, "evaluations": res.trips,
            "host_reads": reads, "reads_per_iteration": reads / max(its, 1),
            "launches": launches, **extra}


def lbfgsb_leg(label, shape, device="cuda") -> dict:
    """One run of ``legs.LBFGSB_RUNS``: ``Lbfgsb(m=5)`` with bench.py's
    box (or, for ``lane_boxes``, a box per lane) from starts uniform in
    [-2, 2], float32, to its end."""
    import torch

    import cppnumericalsolvers_tpu_torch as cns
    from benchmarks_torch import legs
    from cppnumericalsolvers_tpu_torch.solvers import lbfgsb as lbb

    b, n = shape
    solver = cns.Lbfgsb(m=5, lower=legs.LBFGSB_BOX[0],
                        upper=legs.LBFGSB_BOX[1])
    obj = cns.models.pairwise_rosenbrock()
    x0 = uniform_start(b, n, -2.0, 2.0, torch.float32, device)
    internals = None
    if label == "lane_boxes":
        half = torch.arange(b, device=device)[:, None] < b // 2
        lo = torch.where(half, legs.LANE_BOXES[0][0], legs.LANE_BOXES[1][0])
        up = torch.where(half, legs.LANE_BOXES[0][1], legs.LANE_BOXES[1][1])
        internals = solver.make_internals(
            n, torch.float32, lo.expand(b, n), up.expand(b, n),
            device=device)
    stop = solver.default_stopping(torch.float32)
    lbb.generalized_cauchy_point.passes = 0
    res, wall, launches, reads = counted(
        lambda: cns.minimize_batched(obj, x0, solver, stop,
                                     internals=internals, device=device),
        device)
    its = int(res.progress.num_iterations.max())
    return _leg_row(f"lbfgsb_{label}", f"Lbfgsb(m=5) {label}", shape, 0,
                    res, wall, launches, reads,
                    cauchy_passes_per_iteration=(
                        lbb.generalized_cauchy_point.passes / max(its, 1)))


def al_leg(device="cuda", shape=None, budget=None) -> dict:
    """bench.py's AL leg (bench.py:468-512) as ``chip_smoke.py``'s
    ``constrained_main`` runs it: ``AugmentedLagrangian(inner_solver=
    Lbfgs(m=10))`` on f = sum(x) + 0.005 sum(x^2) under sum(x^2) = n, from
    starts uniform in [-2, 2], float32, ``legs.AL_LEG_BUDGET`` outer
    by inner iterations; ``shape`` and ``budget`` default to ``legs``'."""
    import torch

    import cppnumericalsolvers_tpu_torch as cns
    from benchmarks_torch import legs

    b, n = shape or legs.AL_LEG
    outer, inner_cap = budget or legs.AL_LEG_BUDGET
    problem = legs.al_leg_problem(cns, n)
    inner = cns.Lbfgs(m=M)
    al = cns.AugmentedLagrangian(inner_solver=inner)
    x0 = uniform_start(b, n, -2.0, 2.0, torch.float32, device)
    stop = cns.default_stopping(torch.float32).replace(max_iterations=outer)
    istop = inner.default_stopping(torch.float32).replace(
        max_iterations=inner_cap)
    res, wall, launches, reads = counted(
        lambda: al.minimize_batched(problem, x0, stopping=stop,
                                    inner_stopping=istop, device=device),
        device)
    return {"batch": b, "n": n, "dtype": "float32", "wall_s": wall,
            "outer_iterations": int(res.progress.num_iterations.max()),
            "inner_iterations": res.inner_iterations,
            "evaluations": res.trips, "host_reads": reads,
            "reads_per_inner_iteration": reads / max(res.inner_iterations,
                                                     1),
            "launches": launches,
            "max_violation": float(res.state.max_violation.max())}


def reliability(device="cuda") -> dict:
    """bench.py's reliability leg through ``suite_bench.single_solve``."""
    import suite_bench

    t0 = time.perf_counter()
    run = suite_bench.single_solve(device)
    records = run["records"]
    total = sum(r["ok"].size for r in records)
    single = sum(int(r["ok"].sum()) for r in records)
    f32_ok = sum(int(r["ok"].sum()) for r in run["float32"])
    nfev = sum(float(r["nfev"].sum()) for r in records)
    return {"converged_single_solve": single, "total_instances": total,
            "distinct_problems": len(records),
            "converged_pct_single_solve": 100.0 * single / total,
            "mean_nfev_single_solve": nfev / total,
            "solved_in_float32": f32_ok,
            "instances_resolved_in_f64": single - f32_ok,
            "instances_attempted_in_f64": total - f32_ok,
            "reliability_f32_pass_s": run["f32_wall_s"],
            "reliability_f64_pass_s": run["f64_wall_s"],
            "reliability_wall_s": time.perf_counter() - t0}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device is available; nothing was run.",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from benchmarks_torch import legs, roofline
    from cppnumericalsolvers_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    t_all = time.perf_counter()
    card = roofline.card_line()
    name, limit = [part.strip() for part in card.rsplit(",", 1)]
    device = {"name": name, "power_limit": limit,
              "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    log(f"[bench] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[bench] build {time.perf_counter() - t0:.1f} s")

    def constrained_legs():
        rows = []
        for label, shape in legs.LBFGSB_RUNS:
            rows.append(lbfgsb_leg(label, shape, "cuda"))
            log(f"[bench] leg {json.dumps(rows[-1])}")
        al = al_leg("cuda")
        log(f"[bench] al leg {json.dumps(al)}")
        return rows, al

    if sys.argv[1:] == ["--legs"]:
        lbfgsb_leg("box", (64, 32), "cuda")  # warm: the process's first solve
        rows, al = constrained_legs()
        print(json.dumps({"solver_legs": rows, "al_leg": al,
                          "device": device,
                          "wall_s": time.perf_counter() - t_all}),
              flush=True)
        return 0

    trip = roofline.measure_loop_trip_overhead_us(device="cuda")
    launch = roofline.measure_launch_overhead_us(device="cuda")
    calibration = {"trip_floor_host_us": trip["host_us"],
                   "trip_floor_device_us": trip["device_us"],
                   "launch_host_us": launch["host_us"],
                   "launch_graph_us": launch["graph_us"]}
    log(f"[bench] calibration {json.dumps(calibration)}")

    grid = []
    for b, n in roofline.GRID:
        row = grid_row(b, n, "cuda", calibration["trip_floor_host_us"])
        log(f"[bench] grid {json.dumps(row)}")
        grid.append(row)

    rel = reliability("cuda")
    log(f"[bench] reliability {json.dumps(rel)}")

    rows = []
    for run in legs.SOLVER_RUNS:
        rows.append(solver_leg(run, "cuda"))
        log(f"[bench] leg {json.dumps(rows[-1])}")
    constrained, al = constrained_legs()
    rows += constrained

    head = next(r for r in grid if (r["B"], r["n"]) == (1024, 32))
    out = {
        "metric": "mgh376_converged_pct_single_solve",
        "value": rel["converged_pct_single_solve"],
        "unit": "%",
        "vs_baseline": rel["converged_pct_single_solve"]
        / BASELINE_CONVERGED_PCT,
        **rel,
        "stopping_preset": "conservative+x_delta_violations=2",
        "batched_iters_per_s": head["lane_iters_per_s"],
        "peak_hbm_gbps": roofline.HBM_BYTES_PER_S / 1e9,
        "perf_grid": grid,
        "solver_legs": rows,
        "al_leg": al,
        "calibration": calibration,
        "calibration_runs": {"trip": trip, "launch": launch},
        "device": device,
        "backend": "cuda",
        "wall_s": time.perf_counter() - t_all,
    }
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "bench_torch.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
