"""Readings for the limits of the check: the compared numbers of the
program's own runs and of the lower-precision control, seed by seed, in one
process (the set-up paid once):

    python3 perfbench/calibrate.py --workload <name> --seconds <s> \\
        --seeds 1,2,3 [--control]

The control is the solver with its evaluation computed in bfloat16 (the
precision below the configuration's float32) and handed back in float32, as
the loop casts it.  One JSON line per seed on stdout.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from perfbench import bench, check, launch  # noqa: E402


def control_fn(base):
    def fn(x):
        return base.fn(x.to(torch.bfloat16)).to(torch.float32)

    return fn


def main(argv=None, device="cuda:0", overrides=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    if launch.is_sharded(args.workload):
        return launch.calibrate(args, device.split(":")[0], overrides,
                                bench.GRACE_S)
    cell = bench.Cell(args.workload, device, overrides=overrides)
    if args.control:
        cell.with_evaluation(control_fn(cell.base))
    warm = False
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell.seed(seed)
        # As in a run, the warm-up takes the seed's first batch of starts.
        if not warm:
            cell.warm_up()
            warm = True
        else:
            cell.draw()
        try:
            run, samples = cell.window(args.seconds, traced=False)
        except bench.Overdue as exc:
            row = {"seed": seed, "control": args.control, "overdue": str(exc)}
        else:
            numbers = cell.check(samples)
            row = {"seed": seed, "control": args.control, **numbers,
                   "correct": check.verdict(numbers, cell.limits),
                   "solves": len(run.trips), "trips": sum(run.trips),
                   "attempted": run.lanes, "failed": run.lanes - run.converged,
                   "solves_per_s": run.converged / run.window_s,
                   "wall_s": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
