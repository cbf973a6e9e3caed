#!/usr/bin/env python3
"""Trace-derived device-time table of a ``torch.profiler`` capture.

    python3 benchmarks_torch/trace_table.py TRACE [--iters N] [--top K]
    python3 benchmarks_torch/trace_table.py --record B N [--device cpu]

The PyTorch/CUDA port's counterpart of ``benchmarks/trace_table.py``, which
reads the JAX profiler's captures.  TRACE is a Chrome trace as
``torch.profiler.profile.export_chrome_trace`` writes it (``.json`` or
``.json.gz``), or a directory holding such files (the newest is read).  The
device events (CUDA kernels, copies and sets) are grouped into the JAX
table's phases by the port's kernel names, every other device event into
"driver residue" (the evaluations' PyTorch kernels, the loops' copies);
then the ops with the most device time are listed.  ``--iters`` adds a
column of microseconds per outer iteration.

``--record B N`` first writes a capture: a flat float32 solve of the
pairwise extended Rosenbrock at (B, N) from seed 0 (one untimed solve
first, so the kernels are built), under ``torch.profiler`` with CUDA
activity, to ``chiprun_out/trace_b{B}_n{N}.json``; the table then reads it
with the solve's iterations.  A capture with no device event (one taken on
the CPU) gives no table: the script says so and exits 1.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Device-event categories of torch.profiler's Chrome trace.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

#: Kernel-name fragments of the port's kernels and the phase each belongs
#: to, most specific first (``two_loop_kernel`` is inside
#: ``push_two_loop_kernel``).  Anything unmatched is "driver residue".
PHASES = [
    ("flat_trip_kernel", "flat trip kernel (search trip + iteration "
                         "boundary)"),
    ("prologue_t_kernel", "batch-minor prologue kernel (push + two-loop + "
                          "LS setup)"),
    ("prologue_kernel", "prologue kernel (push + two-loop + LS setup)"),
    ("epilogue_kernel", "epilogue kernel (accept + progress ladder)"),
    ("mt_trip_kernel", "line-search kernel"),
    ("push_two_loop", "push + two-loop kernel"),
    ("two_loop", "two-loop kernel"),
    ("trip_floor_kernel", "trip-floor calibration kernel"),
    ("launch_floor_kernel", "launch-floor calibration kernel"),
]
RESIDUE = "driver residue"


def _trace_path(path: str) -> str:
    if not os.path.isdir(path):
        return path
    found = sorted(
        glob.glob(os.path.join(path, "**", "*.json"), recursive=True)
        + glob.glob(os.path.join(path, "**", "*.json.gz"), recursive=True),
        key=os.path.getmtime)
    if not found:
        raise SystemExit(f"no Chrome trace (.json, .json.gz) under {path}")
    return found[-1]


def load_device_events(path: str) -> list:
    """The complete ("X") device events of the trace at ``path``."""
    path = _trace_path(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def phase_of(name: str) -> str:
    return next((label for key, label in PHASES if key in name), RESIDUE)


def format_table(path: str, top: int = 14, iters: int = 0) -> str:
    """Markdown tables of one capture: device time by phase, then the
    ``top`` ops.  Raises SystemExit where the capture has no device
    event."""
    events = load_device_events(path)
    if not events:
        raise SystemExit(f"no device event in {_trace_path(path)}: a capture "
                         "taken without a CUDA device has none")
    agg, cnt = collections.Counter(), collections.Counter()
    for e in events:
        agg[e["name"]] += e.get("dur", 0)
        cnt[e["name"]] += 1
    phases, phase_cnt = collections.Counter(), collections.Counter()
    for name, dur in agg.items():
        phases[phase_of(name)] += dur
        phase_cnt[phase_of(name)] += cnt[name]
    total = sum(agg.values())
    extra = " us/outer-iter |" if iters else ""
    sep = "---|" if iters else ""

    def row(label, dur, count):
        out = (f"| {label[:60]} | {dur / 1e3:.3f} | "
               f"{100 * dur / total:.1f}% | {count} |")
        return out + (f" {dur / iters:.1f} |" if iters else "")

    lines = ["| phase | total ms | % of device | count |" + extra,
             "|---|---|---|---|" + sep]
    lines += [row(label, dur, phase_cnt[label])
              for label, dur in phases.most_common()]
    lines += ["", "| op | total ms | % of device | count |" + extra,
              "|---|---|---|---|" + sep]
    lines += [row(name, dur, cnt[name])
              for name, dur in agg.most_common(top)]
    lines.append(f"\n(total device time across {len(events)} events: "
                 f"{total / 1e3:.3f} ms)")
    return "\n".join(lines)


def record(b: int, n: int, path: str, device: str = "cuda") -> int:
    """Write a Chrome trace of a flat float32 solve of the pairwise
    extended Rosenbrock at ``(b, n)`` from seed 0 to ``path``; returns the
    solve's largest iteration count."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, ROOT)
    import cppnumericalsolvers_tpu_torch as cns

    x0 = torch.from_numpy(np.random.default_rng(0).uniform(
        -2.0, 2.0, (b, n))).to(device=device, dtype=torch.float32)
    obj = cns.models.pairwise_rosenbrock()
    solver = cns.Lbfgs(m=10)
    stop = cns.default_stopping(torch.float32)
    cns.minimize_batched(obj, x0, solver, stop, device=device)
    activities = [ProfilerActivity.CPU]
    if device != "cpu":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        res = cns.minimize_batched(obj, x0, solver, stop, device=device)
        if device != "cpu":
            torch.cuda.synchronize()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)
    return int(res.progress.num_iterations.max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", nargs="?",
                    help="a Chrome trace file, or a directory of them")
    ap.add_argument("--iters", type=int, default=0,
                    help="outer iterations in the traced run (per-iteration "
                         "column); 0 = none")
    ap.add_argument("--top", type=int, default=14)
    ap.add_argument("--record", type=int, nargs=2, metavar=("B", "N"),
                    help="first capture a flat solve at (B, N)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    path, iters = args.trace, args.iters
    if args.record:
        import torch

        if args.device != "cpu" and not torch.cuda.is_available():
            print("trace_table: no CUDA device is available; nothing was "
                  "recorded.", file=sys.stderr)
            return 1
        b, n = args.record
        path = path or os.path.join(ROOT, "chiprun_out",
                                    f"trace_b{b}_n{n}.json")
        iters = iters or record(b, n, path, args.device)
    if path is None:
        ap.error("give a TRACE or --record B N")
    try:
        print(format_table(path, top=args.top, iters=iters))
    except SystemExit as e:
        print(f"trace_table: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
