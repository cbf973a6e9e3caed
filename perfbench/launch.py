"""Start a model-sharded cell's ranks, one process a card, and watch them.

A configuration with ``"path": "model_sharded"`` names such a cell; its
``"cards"`` are the cell's ``chips``.  This module imports nothing but the
standard library: the launching process only starts the ranks (``spawn``:
a fresh interpreter each) and waits, so the ranks' own imports of torch and
the port are the only ones a run pays before its set-up ends.  Each rank
(``sharded._rank``) checks for its card, joins the process group, builds
the cell and runs it; rank 0 alone prints the result line.  If any rank
fails, or the run outlives :data:`LIMIT_S`, every rank is ended and the run
exits non-zero: it never waits on a collective for good.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import socket
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: Seconds from the launcher's start after which it ends every rank: inside
#: the 360 s a run may take.
LIMIT_S = 340.0
#: Exit code of a run whose ranks outlived their limit.
LATE = 4


def _cell(workload: str, root=ROOT):
    """The cell's entry of ``BENCHMARK.json`` and its configuration file, or
    ``(None, None)`` for a name the benchmark does not have."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        return None, None
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return cell, json.loads((root / conf["file"]).read_text())


def is_sharded(workload: str, root=ROOT) -> bool:
    """Whether the cell's configuration names the model-sharded path (a
    configuration without ``path`` takes the batched one)."""
    _, config = _cell(workload, root)
    return config is not None and config.get(
        "path", "batched") == "model_sharded"


@dataclasses.dataclass
class Job:
    """What every rank is given."""

    workload: str
    seeds: list
    seconds: float
    trace: bool
    t_process: float
    device: str               # "cuda", or "cpu" for the tests
    overrides: dict | None = None
    cell_hook: object = None  # a module-level function, called with the cell
    control: bool = False
    calibrate: bool = False   # one row per seed to the queue, no line
    root: Path = ROOT         # where BENCHMARK.json and the cell's files lie


def main(args, t_process: float, device=None, overrides=None,
         cell_hook=None, limit_s=LIMIT_S, root=ROOT) -> int:
    """One run of a model-sharded cell; rank 0 prints the result line.
    ``device``, ``overrides``, ``cell_hook``, ``limit_s`` and ``root`` serve
    the tests on the CPU."""
    job = Job(args.workload, [args.seed], args.seconds, bool(args.trace),
              t_process, device or "cuda", overrides, cell_hook, root=root)
    return launch(job, limit_s)[0]


def calibrate(args, device=None, overrides=None, grace_s=60.0,
              root=ROOT) -> list:
    """``calibrate.py``'s rows of a model-sharded cell, seed by seed in one
    set of ranks."""
    job = Job(args.workload, [int(s) for s in args.seeds.split(",")],
              args.seconds, False, time.perf_counter(), device or "cuda",
              overrides, control=args.control, calibrate=True, root=root)
    limit = len(job.seeds) * (job.seconds + grace_s + 120) + 600
    code, rows = launch(job, limit)
    if code:
        print(f"perfbench: the ranks ended with code {code} after "
              f"{len(rows)} of {len(job.seeds)} seeds", file=sys.stderr)
    return rows


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, job: Job, rows) -> None:
    from perfbench import sharded

    sharded.rank_main(rank, world, port, job, rows)


def launch(job: Job, limit_s: float):
    """Start the cell's ranks and wait for them: ``(exit code, rows)``.  The
    first rank to fail, or the limit, ends every other; the code is then
    that rank's (:data:`LATE` at the limit)."""
    cell, _ = _cell(job.workload, job.root)
    world = cell["chips"]
    ctx = multiprocessing.get_context("spawn")
    rows = ctx.SimpleQueue()
    port = free_port()
    procs = [ctx.Process(target=_rank, args=(r, world, port, job, rows))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = job.t_process + limit_s
    code = None
    out = []
    while code is None:
        while not rows.empty():
            out.append(rows.get())
        codes = [p.exitcode for p in procs]
        failed = [c for c in codes if c not in (None, 0)]
        if failed:
            code = failed[0]
        elif None not in codes:
            code = 0
        elif time.perf_counter() > deadline:
            print(f"perfbench: the ranks outlived the run's {limit_s} s",
                  file=sys.stderr)
            code = LATE
        else:
            time.sleep(0.05)
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()
    while not rows.empty():
        out.append(rows.get())
    return code, out
