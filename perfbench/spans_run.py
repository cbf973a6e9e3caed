"""A traced run of one cell with the program's host spans recorded, and the
cost of recording them:

    python3 perfbench/spans_run.py --workload <name> --seed <n> --seconds <s> \\
        [--recorder 0|1]
    python3 perfbench/spans_run.py --cost --seed <n> [--rounds 12]

The first is ``run.py --trace 1``'s run with
``cppnumericalsolvers_tpu_torch.record_spans()`` installed before the
warm-up and kept through the window (``--recorder 0``: without it, for the
comparison): the set-up, the profiled window, the check, the per-layer
metrics the cell already has, and those ``host_spans.split`` gives
(``metrics/eval.idle_ms_per_trip.py``, ``loop.idle_ms_per_trip``,
``step.per_solve_ms``, ``eval.first_call_s``).  One JSON line on stdout;
the split on stderr.

``--cost`` times, in one process, whole solves at a size where the host
sets the pace (n = 32, B = 1024: the card's work a trip is far below the
host's), with and without the recorder, each untraced and under the
device-only capture, in alternating rounds: wall microseconds a trip.  It
also times the recorder's own work a trip (three clock reads and three
records) alone.
"""

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

T_PROCESS = time.perf_counter()

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from perfbench import bench, check, host_spans, trace  # noqa: E402

NEW_METRICS = ("eval.idle_ms_per_trip", "loop.idle_ms_per_trip",
               "step.per_solve_ms", "eval.first_call_s")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    p.add_argument("--cost", action="store_true")
    p.add_argument("--rounds", type=int, default=12)
    return p.parse_args(argv)


def capture(device):
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA if device.type == "cuda"
                               else ProfilerActivity.CPU])


def cell_run(args, device="cuda:0", overrides=None) -> dict:
    from cppnumericalsolvers_tpu_torch import record_spans

    cell = bench.Cell(args.workload, device, overrides=overrides)
    if cell.device.type == "cuda":
        torch.cuda.set_device(cell.device)
        torch.cuda.reset_peak_memory_stats(cell.device)
    cell.seed(args.seed)
    cell._sync()
    with (record_spans() if args.recorder
          else contextlib.nullcontext()) as rec:
        cell.warm_up()
        setup_s = time.perf_counter() - T_PROCESS
        with capture(cell.device) as prof:
            run, samples = cell.window(args.seconds, traced=True)
        events = prof.profiler.kineto_results.events()
        run.summary = trace.reduce(events, cell.rec.spans)
        run.host_split = (host_spans.split(events, cell.rec.spans, rec.spans)
                          if rec is not None else None)
    run.setup_s = setup_s
    cell.rec.spans = None
    metrics = bench.read_metrics(cell, run, traced=True)
    for name in NEW_METRICS:
        reader = bench._load(bench.HERE / "metrics" / f"{name}.py",
                             f"perfbench_metric_{name}")
        value = reader.read(run)
        if value is not None:
            metrics[name] = value
    if run.host_split is not None:
        print(run.host_split.line(), file=sys.stderr)
    s = run.summary
    line = {
        "workload": args.workload, "seed": args.seed,
        "recorder": args.recorder, "setup_s": setup_s,
        "solves_per_s": run.converged / run.window_s,
        "solves": len(run.trips), "trips": sum(run.trips),
        "wall_ms_per_trip": 1e3 * run.window_s / max(sum(run.trips), 1),
        "metrics": {k: v["value"] if isinstance(v, dict) else v
                    for k, v in metrics.items()},
        "device": bench.device_block(cell.device, s),
        "program_spans": 0 if rec is None else len(rec.spans),
    }
    if run.host_split is not None:
        h = run.host_split
        line["idle_by_span_s"] = h.idle_s
        line["window_idle_s"] = h.window_idle_s
    if s is not None:
        line["idle_gaps"] = [list(x) for x in s.gaps]
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    line["correct"] = check.verdict(cell.check(samples), cell.limits)
    return line


def cost(args, device="cuda:0", batch=1024, n=32) -> dict:
    import cppnumericalsolvers_tpu_torch as cns
    from cppnumericalsolvers_tpu_torch.core import spans

    dev = torch.device(device)
    obj = cns.models.pairwise_rosenbrock()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    solver = cns.Lbfgs(m=10, max_linesearch_fev=20)
    stop = cns.default_stopping(torch.float32)

    def solve():
        x0 = torch.empty((batch, n), device=dev).uniform_(-2, 2,
                                                          generator=gen)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = cns.minimize_batched(obj, x0, solver, stop, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0, res.trips

    solve()
    times = {(r, t): [] for r in (0, 1) for t in (0, 1)}
    for k in range(args.rounds):
        for r, t in (((0, 0), (1, 0), (0, 1), (1, 1)) if k % 2 == 0
                     else ((1, 1), (0, 1), (1, 0), (0, 0))):
            with contextlib.ExitStack() as stack:
                if t:
                    stack.enter_context(capture(dev))
                if r:
                    stack.enter_context(spans.record_spans())
                wall, trips = solve()
            times[(r, t)].append(1e6 * wall / trips)
    rec = spans.SpanRecorder()
    reps = 200_000
    clock = spans.clock_ns
    t0 = time.perf_counter()
    for _ in range(reps):
        t = rec.add(spans.READ, 0, clock())
        t = rec.add(spans.EVAL, t, clock())
        rec.add(spans.TRIP, t, clock())
    alone = 1e6 * (time.perf_counter() - t0) / reps
    label = {(0, 0): "untraced", (1, 0): "untraced_recorder",
             (0, 1): "traced", (1, 1): "traced_recorder"}
    return {"cost": True, "batch": batch, "n": n, "rounds": args.rounds,
            "recorder_alone_us_per_trip": alone,
            **{f"{label[k]}_us_per_trip_median": statistics.median(v)
               for k, v in times.items()},
            **{f"{label[k]}_us_per_trip": v for k, v in times.items()}}


def main(argv=None, device=None, overrides=None) -> int:
    args = parse(argv)
    if device is None:
        if not torch.cuda.is_available():
            print("perfbench: no CUDA device; nothing measured",
                  file=sys.stderr)
            return 2
        device = "cuda:0"
    if args.cost:
        line = cost(args, device, **(overrides or {}))
    else:
        line = cell_run(args, device, overrides)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
