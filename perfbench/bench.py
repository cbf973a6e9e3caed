"""The benchmark of cppnumericalsolvers_tpu_torch: one cell, one run.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<name>.json``: the problem, its width, the solver's settings) and
a traffic mix (``traffic/<name>.json``: the batch, where its starts lie as
a list of components, each a share of the lanes drawn uniformly from a box,
and what the check samples).  Problems live in
``problems/<name>.py``, metric readers in ``metrics/<name>.py`` and the
limits of the check in ``limits/<cell>.json``; everything is found by name.

A run: set-up (imports, the card, one short solve at the cell's shape that
loads the kernel), then the window: whole batched solves back to back from
one client (a closed loop) for ``--seconds``, each on a new batch of starts
drawn on the card from the seed just before it and timed from
``minimize_batched`` to its synchronised result; then the check against the
plain reference, and one JSON line.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from perfbench import check, trace, work

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
#: Frozen copy of the solver's ``CONVERGED_STATUSES`` (x delta, f delta,
#: gradient norm, finished).
CONVERGED = (2, 3, 4, 6)
#: Top-level modules the process must not hold once the window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "cppnumericalsolvers_tpu", "benchmarks",
             "benchmarks_torch")
#: Seconds a solve may run past the window's close before it counts as
#: never having come.
GRACE_S = 60.0
#: Seconds the warm-up may spend building the kernel on a fresh checkout.
BUILD_S = 600.0


class Overdue(RuntimeError):
    """A solve still running a grace period past the window's close."""


class Recorder:
    """What the benchmark's objective wrapper does at each batched
    evaluation: check the deadline, keep the sampled lanes' points, values
    and gradients of the first ``trips`` trips (call 0 is the start), and,
    when traced, stamp the evaluation's span on the profiler's clock
    (``spans``: span name -> [(start ns, end ns)])."""

    def __init__(self, trips: int):
        self.trips = trips
        self.spans = None
        self.deadline = math.inf
        self.calls = 0
        self.total_calls = 0
        self.rows = None
        self.bufs = None

    def start_solve(self, rows, bufs):
        """``bufs``: ``(x, f, g)`` of ``trips + 1`` calls each, or None."""
        self.calls, self.rows, self.bufs = 0, rows, bufs

    def keeps(self) -> bool:
        return self.rows is not None and self.calls <= self.trips

    def before(self, x):
        if time.monotonic() > self.deadline:
            raise Overdue("a solve ran past the window's close and its grace")
        if self.keeps():
            torch.index_select(x, 0, self.rows, out=self.bufs[0][self.calls])

    def after(self, f, g):
        if self.keeps():
            torch.index_select(f, 0, self.rows, out=self.bufs[1][self.calls])
            torch.index_select(g, 0, self.rows, out=self.bufs[2][self.calls])
        self.calls += 1
        self.total_calls += 1


def wrap_objective(base, rec: Recorder):
    """The solver's objective with the recorder in front of every batched
    evaluation; otherwise the same object (its class, function, mode and
    any further fields)."""
    fields = {f.name: getattr(base, f.name)
              for f in dataclasses.fields(base) if f.init}
    return _recording(type(base))(**fields, rec=rec)


@functools.cache
def _recording(cls):
    """``cls``, an ``Objective`` class, with the recorder in front of its
    batched evaluation."""

    @dataclasses.dataclass(frozen=True, eq=False)
    class BenchObjective(cls):
        rec: Recorder = None

        def batched_value_and_grad(self, x):
            self.rec.before(x)
            if self.rec.spans is None:
                f, g = super().batched_value_and_grad(x)
            else:
                t0 = time.time_ns()
                f, g = super().batched_value_and_grad(x)
                self.rec.spans[trace.EVAL].append((t0, time.time_ns()))
            self.rec.after(f, g)
            return f, g

    return BenchObjective


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers read it."""

    setup_s: float
    window_s: float
    solve_s: list
    trips: list
    lanes: int
    converged: int
    eval_calls: int
    step_bytes: float
    step_ops: float
    eval_bytes: float
    eval_ops: float
    itemsize: int
    summary: trace.Summary | None = None


class Cell:
    """One cell of ``BENCHMARK.json``, built from its files.  ``root`` holds
    that file and the cell's files under ``perfbench/``; ``overrides``
    (``batch``, ``n``) shrink the cell for the tests on the CPU."""

    def __init__(self, workload: str, device, root: Path = ROOT,
                 overrides: dict | None = None):
        spec = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}")
        self.name = workload
        self.cell = cells[workload]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = json.loads(
            (root / configs[self.cell["config"]]["file"]).read_text())
        self.traffic = json.loads((root / "perfbench" / "traffic" / (
            f"{self.cell['traffic']}.json")).read_text())
        self.limits = json.loads(
            (root / "perfbench" / "limits" / f"{workload}.json").read_text())
        self.metrics = [
            m for m in spec["end_to_end"] + spec["per_layer"]
            if workload in m.get("workloads", [workload])]
        self.problem = importlib.import_module(
            f"perfbench.problems.{self.config['problem']}")
        o = overrides or {}
        self.n = o.get("n", self.config["n"])
        self.batch = o.get("batch", self.traffic["batch"])
        self.parts = start_parts(self.traffic["start"], self.batch,
                                 self.problem.X_STAR)
        self.device = torch.device(device)
        self.dtype = getattr(torch, self.config["dtype"])
        self.grace_s = GRACE_S

        import cppnumericalsolvers_tpu_torch as cns

        sv = self.config["solver"]
        self.solver = cns.Lbfgs(m=sv["m"],
                                max_linesearch_fev=sv["max_linesearch_fev"])
        self.stopping = cns.default_stopping(self.dtype)
        self.minimize = cns.minimize_batched
        self.rec = Recorder(self.traffic["check"]["trips"])
        self.base = self.problem.objective()
        self.objective = wrap_objective(self.base, self.rec)

    def with_evaluation(self, fn):
        """The cell with another evaluation function in the solver's place
        (the lower-precision control)."""
        from cppnumericalsolvers_tpu_torch import Objective

        self.objective = wrap_objective(Objective(fn, self.base.mode),
                                        self.rec)
        return self

    # -- set-up -----------------------------------------------------------

    def seed(self, seed: int):
        """Seed the starts' generator on the device and draw the sampled
        lanes of the first ``check.solves`` solves on the host."""
        chk = self.traffic["check"]
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        cpu = torch.Generator().manual_seed(seed)
        lanes = min(chk["lanes_per_solve"], self.batch)
        self.rows = torch.randint(self.batch, (chk["solves"], lanes),
                                  generator=cpu).to(self.device)

    def draw(self):
        """The next batch of starts, ``(B, n)``, drawn on the device: each
        component of the traffic's ``start`` fills its share of the lanes
        uniformly from its box."""
        x = torch.empty((self.batch, self.n), device=self.device,
                        dtype=self.dtype)
        for lo, hi, centre, half in self.parts:
            x[lo:hi].uniform_(centre - half, centre + half,
                              generator=self.gen)
        return x

    def warm_up(self):
        """One short solve at the cell's shape on the first batch of starts:
        loads (and on a fresh checkout builds) the kernel and fills the
        allocator's caches.  It too must end within the grace period past a
        build's allowance."""
        self.rec.deadline = time.monotonic() + BUILD_S + self.grace_s
        self.minimize(self.objective, self.draw(), self.solver,
                      self.stopping.replace(max_iterations=3),
                      device=self.device)
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window -------------------------------------------------------

    def window(self, seconds: float, traced: bool):
        """Whole solves back to back until ``seconds`` have passed; returns
        the measured :class:`Run` parts and the check's samples."""
        rec, trips_k = self.rec, self.traffic["check"]["trips"]
        rec.spans = {trace.EVAL: [], trace.SOLVE: [], trace.BETWEEN: []} \
            if traced else None
        lanes = self.rows.shape[1]
        dev = self.device
        converged = torch.zeros((), dtype=torch.int64, device=dev)
        step_b = torch.zeros((), dtype=torch.float64, device=dev)
        step_o = torch.zeros((), dtype=torch.float64, device=dev)
        conv = torch.tensor(CONVERGED, dtype=torch.int32, device=dev)
        m = self.solver.m
        itemsize = torch.finfo(self.dtype).bits // 8
        solve_s, trips, samples = [], [], []
        calls0 = rec.total_calls
        t_start = time.perf_counter()
        rec.deadline = time.monotonic() + seconds + self.grace_s
        i = 0
        while True:
            x0 = self.draw()
            sampled = i < self.rows.shape[0]
            if sampled:
                rows = self.rows[i]
                bufs = tuple(torch.empty((trips_k + 1, lanes) + tail,
                                         dtype=self.dtype, device=dev)
                             for tail in ((self.n,), (), (self.n,)))
                rec.start_solve(rows, bufs)
            else:
                rec.start_solve(None, None)
            ns0 = time.time_ns()
            t0 = time.perf_counter()
            res = self.minimize(self.objective, x0, self.solver,
                                self.stopping, device=dev)
            self._sync()
            t1 = time.perf_counter()
            ns1 = time.time_ns()
            solve_s.append(t1 - t0)
            trips.append(res.trips)
            st, f = res.progress.status, res.state.value
            converged += (torch.isin(st, conv)
                          & torch.isfinite(f)).sum()
            sb, so = work.step_work(
                res.trips, res.state.nfev, res.progress.num_iterations,
                res.internals.mem_count, self.n, m, itemsize)
            step_b += sb
            step_o += so
            if sampled:
                worst = torch.argmax(res.state.nfev).view(1)
                keep = torch.cat((rows, worst))
                kept = min(rec.calls, trips_k + 1)
                samples.append(check.Sample(
                    x0=x0.index_select(0, rows), trials=bufs[0][:kept],
                    f_trials=bufs[1][:kept], g_trials=bufs[2][:kept],
                    x=res.state.x.index_select(0, keep),
                    f=res.state.value.index_select(0, keep),
                    g=res.state.gradient.index_select(0, keep)))
            del res, x0
            if traced:
                rec.spans[trace.SOLVE].append((ns0, ns1))
                rec.spans[trace.BETWEEN].append((ns1, time.time_ns()))
            i += 1
            if t1 - t_start >= seconds:
                break
        self._sync()
        calls = rec.total_calls - calls0
        rec.start_solve(None, None)
        eb = calls * self.problem.eval_bytes(self.batch, self.n, itemsize)
        eo = calls * self.problem.eval_ops(self.batch, self.n)
        run = Run(setup_s=math.nan, window_s=t1 - t_start, solve_s=solve_s,
                  trips=trips, lanes=self.batch * i,
                  converged=int(converged), eval_calls=calls,
                  step_bytes=float(step_b), step_ops=float(step_o),
                  eval_bytes=float(eb), eval_ops=float(eo), itemsize=itemsize)
        return run, samples

    def check(self, samples) -> dict:
        sv = self.config["solver"]
        return check.compare(samples, self.problem, sv["m"],
                             sv["max_linesearch_fev"])


def start_parts(components, batch: int, x_star: float) -> list:
    """The traffic's start components as ``(first lane, end lane, centre,
    half-width)``: each takes ``share`` of the batch in the listed order,
    the last the rest; ``centre`` is a number or ``"minimiser"``."""
    if abs(sum(c["share"] for c in components) - 1.0) > 1e-9:
        raise SystemExit("the start components' shares do not sum to 1")
    parts, lo = [], 0
    for k, c in enumerate(components):
        hi = batch if k == len(components) - 1 else lo + round(
            c["share"] * batch)
        centre = x_star if c["centre"] == "minimiser" else float(c["centre"])
        parts.append((lo, hi, centre, float(c["half_width"])))
        lo = hi
    return parts


def read_metrics(cell: Cell, run: Run, traced: bool) -> dict:
    """Each of the cell's metrics of this kind of run, by its reader
    ``metrics/<name>.py``; a reader that finds nothing returns None and the
    metric is left out."""
    out = {}
    for m in cell.metrics:
        if (m["source"] == "host_clock") == traced:
            continue
        reader = _load(HERE / "metrics" / f"{m['name']}.py",
                       f"perfbench_metric_{m['name']}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (the modules this
    process holds), each compared whole."""
    return sorted({k.split(".")[0] for k in (names or list(sys.modules))}
                  & set(FORBIDDEN))


def device_block(device, summary) -> dict:
    """The result's ``device``: what ran, its peak memory so far, and with a
    trace the busy and traced seconds."""
    if device.type == "cuda":
        block = {"platform": "gpu",
                 "kind": torch.cuda.get_device_name(device),
                 "count": 1,
                 "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}
    else:
        block = {"platform": "cpu", "kind": "cpu", "count": 1,
                 "memory_peak_bytes": 0}
    if summary is not None:
        block["busy_s"] = summary.busy_s
        block["window_s"] = summary.window_s
    return block


def profile_window(cell: Cell, seconds: float):
    """The window under ``torch.profiler``, the capture reduced.  Only the
    device's activity is captured (kernels, copies and the runtime calls
    that launched them): tracing every host operator as well slowed the
    host enough to idle the card half the window.  The benchmark's spans
    are its own stamps on the profiler's clock."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA if cell.device.type == "cuda"
            else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        run, samples = cell.window(seconds, traced=True)
    run.summary = trace.reduce(prof.profiler.kineto_results.events(),
                               cell.rec.spans)
    cell.rec.spans = None
    return run, samples


def main(args, t_process: float, device=None, overrides=None,
         cell_hook=None) -> int:
    """One run; prints the result line.  ``device``, ``overrides`` and
    ``cell_hook`` (called with the built cell) serve the tests on the CPU;
    a run from the command line takes the card and refuses without one."""
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
            print("perfbench: no CUDA device; nothing measured",
                  file=sys.stderr)
            return 2
        device = "cuda:0"
    # Each mark: its name, the wall clock and the process's CPU time so far.
    marks = [("start", t_process, 0.0)]

    def mark(name):
        marks.append((name, time.perf_counter(), time.process_time()))

    cell = Cell(args.workload, device, overrides=overrides)
    mark("imports")
    if cell.device.type == "cuda":
        if torch.cuda.device_count() < cell.cell["chips"]:
            print(f"perfbench: the cell needs {cell.cell['chips']} cards",
                  file=sys.stderr)
            return 2
        torch.cuda.set_device(cell.device)
        torch.cuda.reset_peak_memory_stats(cell.device)
    if cell_hook is not None:
        cell_hook(cell)
    cell.seed(args.seed)
    cell._sync()
    mark("card")
    traced = bool(args.trace)
    try:
        cell.warm_up()
        mark("warm_up")
        setup_s = marks[-1][1] - t_process
        print("perfbench: set-up " + ", ".join(
            f"{k} {b - a:.3f} s (cpu {d - c:.3f} s)"
            for (_, a, c), (k, b, d) in zip(marks, marks[1:])),
            file=sys.stderr)
        if traced:
            run, samples = profile_window(cell, args.seconds)
        else:
            run, samples = cell.window(args.seconds, traced=False)
    except Overdue as exc:
        print(f"perfbench: not correct: {exc}", file=sys.stderr)
        return finish(cell, {"correct": False, "attempted": 0, "failed": 0,
                             "metrics": {},
                             "device": device_block(cell.device, None)},
                      {k: math.nan for k in check.NAMES})
    run.setup_s = setup_s
    dev = device_block(cell.device, run.summary)
    # The peak is read; the solver's caches are freed before the reference.
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = cell.check(samples)
    line = {"correct": check.verdict(numbers, cell.limits),
            "attempted": run.lanes, "failed": run.lanes - run.converged,
            "metrics": read_metrics(cell, run, traced), "device": dev}
    s = run.summary
    if s is not None:
        line["breakdown"] = {"device_ops": [list(x) for x in s.ops],
                             "idle_gaps": [list(x) for x in s.gaps]}
    print(f"perfbench: {len(run.solve_s)} solves, {sum(run.trips)} trips, "
          f"{run.eval_calls} evaluations, window {run.window_s:.4f} s; "
          f"trips a solve {run.trips}", file=sys.stderr)
    if s is not None:
        print(f"perfbench: device eval {s.eval_s:.6f} s, step {s.step_s:.6f}"
              f" s, between {s.other_s:.6f} s, unattributed "
              f"{s.unattributed_s:.6f} s", file=sys.stderr)
    return finish(cell, line, numbers)


def finish(cell: Cell, line: dict, numbers: dict) -> int:
    """Refuse a process that holds a forbidden module; else print each
    compared number beside its limit, last on stderr and last in the line,
    and the line last on stdout."""
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process holds {found}; no result",
              file=sys.stderr)
        return 3
    line["checks"] = {
        k: {"value": numbers[k] if math.isfinite(numbers[k]) else None,
            "limit": cell.limits[k]} for k in check.NAMES}
    for k in check.NAMES:
        print(f"check {k} {numbers[k]!r} limit {cell.limits[k]!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
