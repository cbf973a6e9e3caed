"""The benchmark's model-sharded cells: one problem whose n is split over
the cards of one host and solved by the port's
``parallel.minimize_model_sharded``.

``launch.py`` starts one rank a card; each runs :func:`rank_main`
(``RANK``, ``LOCAL_RANK`` and ``WORLD_SIZE`` set, NCCL over a free local
port, gloo on the CPU for the tests), builds the cell, draws the same global
start from the seed on its own card and calls the port's public entry.  The
ranks run the same trips; rank 0 decides when the window has closed and
alone prints the result line.

The solver the cell hands the port is ``Lbfgs`` with two hooks and no other
change (:class:`RecordingLbfgs`): it keeps the start's evaluation from the
internals' set-up and wraps the sharded objective it is given at each step
in the benchmark's recorder, so every batched evaluation is seen, as on the
batched path.

The check (:func:`compare`) holds the window's own solves to the plain
reference sharded as the solve is: each rank follows its own coordinates of
``reference/lbfgs_trip.py``'s trip in float64 from the first solve's kept
evaluations, every sum and largest magnitude over n all-reduced over the
ranks (``lbfgs_trip.over_ranks``); ``eval_gap`` and ``f_final`` take the
reference's value as the ranks' partial sums summed.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import json
import math
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from perfbench import bench, check, trace, work
from perfbench.reference import lbfgs_trip

#: Seconds a collective may wait for the other ranks before the process
#: group gives up on it and the rank ends.
COLLECTIVE_S = 150.0


# -- a rank -------------------------------------------------------------------


def rank_main(rank: int, world: int, port: int, job, rows) -> None:
    """Rank ``rank`` of ``world`` (``launch._rank`` in a fresh
    interpreter): its card, the process group, the run; ends the process
    with the run's exit code."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    if rank:
        # Only rank 0 writes to standard output: its last line is the run's.
        os.dup2(2, 1)
        sys.stdout = sys.stderr
    cuda = job.device == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < world):
        print(f"perfbench: rank {rank}: the cell needs {world} CUDA cards; "
              "nothing measured", file=sys.stderr)
        os._exit(2)
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=f"tcp://127.0.0.1:{port}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_S))
    try:
        code = _run(job, device, rows)
    except bench.Overdue as exc:
        print(f"perfbench: rank {rank}: not correct: {exc}", file=sys.stderr)
        code = 5
    except Exception:
        traceback.print_exc()
        code = 1
    else:
        dist.destroy_process_group()
    sys.stderr.flush()
    sys.stdout.flush()
    os._exit(code)


def _run(job, device, rows) -> int:
    """One rank's run, or with ``job.calibrate`` its rows seed by seed; the
    exit code."""
    rank = dist.get_rank()
    marks = [("start", job.t_process, 0.0)]

    def mark(name):
        marks.append((name, time.perf_counter(), time.process_time()))

    cell = ShardedCell(job.workload, device, root=job.root,
                       overrides=job.overrides)
    if job.control:
        from perfbench import calibrate

        cell.with_evaluation(calibrate.control_fn(cell.base))
    mark("imports")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if job.cell_hook is not None:
        job.cell_hook(cell)
    if job.calibrate:
        return _calibrate_rows(cell, job, rows)
    cell.seed(job.seeds[0])
    cell._sync()
    mark("card")
    cell.warm_up()
    mark("warm_up")
    setup_s = marks[-1][1] - job.t_process
    if rank == 0:
        print("perfbench: set-up " + ", ".join(
            f"{k} {b - a:.3f} s (cpu {d - c:.3f} s)"
            for (_, a, c), (k, b, d) in zip(marks, marks[1:])),
            file=sys.stderr)
    if job.trace:
        run, samples = cell.profile_window(job.seconds)
    else:
        run, samples = cell.window(job.seconds, traced=False)
    run.setup_s = setup_s
    dev = cell.device_block(run.summary)
    # The peak is read; the solver's caches are freed before the reference.
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = cell.check(samples)
    del samples
    found = bench.forbidden_modules()
    if found:
        print(f"perfbench: rank {rank} holds {found}", file=sys.stderr)
    if cell.agree(bool(found), dist.ReduceOp.MAX):
        if rank == 0:
            print("perfbench: a rank holds a forbidden module; no result",
                  file=sys.stderr)
        return 3
    if rank:
        return 0
    line = {"correct": check.verdict(numbers, cell.limits),
            "attempted": run.lanes, "failed": run.lanes - run.converged,
            "metrics": bench.read_metrics(cell, run, job.trace),
            "device": dev}
    s = run.summary
    if s is not None:
        line["breakdown"] = {"device_ops": [list(x) for x in s.ops],
                             "idle_gaps": [list(x) for x in s.gaps]}
    print(f"perfbench: {len(run.solve_s)} solves, {sum(run.trips)} trips, "
          f"{run.iterations} iterations, window {run.window_s:.4f} s; "
          f"trips a solve {run.trips}; s a solve "
          f"{[round(t, 4) for t in run.solve_s]}", file=sys.stderr)
    if s is not None:
        print(f"perfbench: rank 0 device eval {s.eval_s:.6f} s, step "
              f"{s.step_s:.6f} s, between {s.other_s:.6f} s, unattributed "
              f"{s.unattributed_s:.6f} s; collectives {run.comm[1]} "
              f"launches, {run.comm[0]:.6f} s", file=sys.stderr)
    return bench.finish(cell, line, numbers)


def _calibrate_rows(cell, job, rows) -> int:
    """The compared numbers of one window a seed; rank 0 puts each row."""
    warm = False
    for seed in job.seeds:
        t0 = time.perf_counter()
        cell.seed(seed)
        # As in a run, the warm-up takes the seed's first start.
        if not warm:
            cell.warm_up()
            warm = True
        else:
            cell.draw()
        run, samples = cell.window(job.seconds, traced=False)
        numbers = cell.check(samples)
        del samples
        if dist.get_rank() == 0:
            row = {"seed": seed, "control": job.control, **numbers,
                   "correct": check.verdict(numbers, cell.limits),
                   "solves": len(run.trips), "trips": sum(run.trips),
                   "iterations": run.iterations, "attempted": run.lanes,
                   "failed": run.lanes - run.converged,
                   "solves_per_s": run.converged / run.window_s,
                   "wall_s": time.perf_counter() - t0}
            print(json.dumps(row), flush=True)
            rows.put(row)
    return 0


# -- the cell -----------------------------------------------------------------


@functools.cache
def _recording_lbfgs():
    """``Lbfgs`` with the benchmark's recorder at each batched evaluation:
    the start's, which ``core/driver.py`` makes before the solver's
    internals, from ``init_batched``'s state; each step's, from the
    objective it is given, wrapped as on the batched path."""
    import cppnumericalsolvers_tpu_torch as cns

    @dataclasses.dataclass(frozen=True)
    class RecordingLbfgs(cns.Lbfgs):
        rec: bench.Recorder = None

        def init_batched(self, objective, state, batch_minor=False):
            self.rec.before(state.x)
            self.rec.after(state.value, state.gradient)
            return super().init_batched(objective, state, batch_minor)

        def step(self, objective, state, internals, stopping, done=None):
            return super().step(bench.wrap_objective(objective, self.rec),
                                state, internals, stopping, done)

    return RecordingLbfgs


class ShardedCell(bench.Cell):
    """A model-sharded cell on this rank, which holds coordinates ``start``
    to ``start + n_local`` of every vector.  The traffic's ``batch`` is 1:
    one problem a solve."""

    def __init__(self, workload: str, device, root=bench.ROOT,
                 overrides: dict | None = None):
        super().__init__(workload, device, root=root, overrides=overrides)
        import cppnumericalsolvers_tpu_torch as cns

        self.world, self.rank = dist.get_world_size(), dist.get_rank()
        if (not self.config["cards"] == self.cell["chips"] == self.world
                or self.batch != 1 or self.n % (2 * self.world)):
            raise SystemExit("a model-sharded cell takes one problem a "
                             "solve, split in whole pairs over its cards")
        self.n_local = self.n // self.world
        self.start = self.rank * self.n_local
        sv = self.config["solver"]
        self.solver = _recording_lbfgs()(
            m=sv["m"], max_linesearch_fev=sv["max_linesearch_fev"],
            rec=self.rec)
        # The port builds the sharded objective from the function; the
        # solver above records its evaluations.
        self.objective = self.base
        self.minimize = functools.partial(
            cns.parallel.minimize_model_sharded,
            mesh=cns.parallel.make_mesh(axis="model", device=self.device))

    def with_evaluation(self, fn):
        from cppnumericalsolvers_tpu_torch import Objective

        self.objective = Objective(fn, self.base.mode)
        return self

    def agree(self, value, op) -> float:
        """``value`` reduced over the ranks by ``op``: one collective."""
        t = torch.tensor([float(value)], dtype=torch.float64,
                         device=self.device)
        dist.all_reduce(t, op=op)
        return float(t)

    def seed(self, seed: int):
        """Seed the starts' generator on the device: every rank draws the
        same global starts."""
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def warm_up(self):
        """One short solve at the cell's shape from the first start: the
        process group's communicators, ``torch.func`` and DTensor's first
        calls, the allocator's caches; it ends when every rank has."""
        self.rec.deadline = time.monotonic() + bench.BUILD_S + self.grace_s
        self.minimize(self.objective, self.draw()[0], self.solver,
                      self.stopping.replace(max_iterations=3),
                      device=self.device)
        self._sync()
        self.agree(0, dist.ReduceOp.MAX)

    def window(self, seconds: float, traced: bool):
        """Whole solves back to back until rank 0 has seen ``seconds`` pass;
        returns the :class:`~bench.Run` and the check's samples: the first
        solve's kept evaluations and the first solves' results, this
        rank's coordinates of each, and the solves in which the recorder
        did not see every evaluation (the start's and one a trip)."""
        rec, trips_k = self.rec, self.traffic["check"]["trips"]
        rec.spans = {trace.EVAL: [], trace.SOLVE: [], trace.BETWEEN: []} \
            if traced else None
        dev, cut = self.device, slice(self.start, self.start + self.n_local)
        row = torch.zeros(1, dtype=torch.long, device=dev)
        m, itemsize = self.solver.m, torch.finfo(self.dtype).bits // 8
        solve_s, trips, iterations, results = [], [], [], []
        first, converged, unseen = None, 0, 0
        step_b = step_o = 0.0
        t_start = time.perf_counter()
        rec.deadline = time.monotonic() + seconds + self.grace_s
        while True:
            x0 = self.draw()[0]
            bufs = None
            if first is None:
                bufs = tuple(torch.empty((trips_k + 1, 1) + tail,
                                         dtype=self.dtype, device=dev)
                             for tail in ((self.n_local,), (),
                                          (self.n_local,)))
            rec.start_solve(None if bufs is None else row, bufs)
            ns0 = time.time_ns()
            t0 = time.perf_counter()
            res = self.minimize(self.objective, x0, self.solver,
                                self.stopping, device=dev)
            self._sync()
            t1 = time.perf_counter()
            ns1 = time.time_ns()
            solve_s.append(t1 - t0)
            trips.append(res.trips)
            iterations.append(int(res.progress.num_iterations))
            converged += (int(res.progress.status) in bench.CONVERGED
                          and bool(torch.isfinite(res.state.value)))
            unseen += rec.calls != res.trips + 1
            # The step's least work on this rank's coordinates: the flat
            # trip's rule holds here, a trip being one batched evaluation.
            sb, so = work.step_work(
                res.trips, res.state.nfev, res.progress.num_iterations,
                res.internals.mem_count, self.n_local, m, itemsize)
            step_b += float(sb)
            step_o += float(so)
            if len(results) < self.traffic["check"]["solves"]:
                results.append((res.state.x[cut].clone(),
                                res.state.value.clone(),
                                res.state.gradient[cut].clone()))
            if bufs is not None:
                kept = min(rec.calls, trips_k + 1)
                first = (x0[cut].clone(),) + tuple(b[:kept] for b in bufs)
            del res, x0
            # Rank 0's clock closes the window for every rank.
            closed = torch.tensor([float(t1 - t_start >= seconds)],
                                  device=dev)
            dist.broadcast(closed, src=0)
            if traced:
                rec.spans[trace.SOLVE].append((ns0, ns1))
                rec.spans[trace.BETWEEN].append((ns1, time.time_ns()))
            if bool(closed):
                break
        rec.start_solve(None, None)
        calls = sum(trips)  # the loop's evaluations, each in an eval span
        run = bench.Run(
            setup_s=math.nan, window_s=t1 - t_start, solve_s=solve_s,
            trips=trips, lanes=len(trips), converged=converged,
            eval_calls=calls, step_bytes=step_b, step_ops=step_o,
            eval_bytes=float(calls * self.problem.eval_bytes(
                1, self.n_local, itemsize)),
            eval_ops=float(calls * self.problem.eval_ops(1, self.n_local)),
            itemsize=itemsize)
        run.iterations = sum(iterations)
        run.comm = None
        return run, (first, results, unseen)

    def profile_window(self, seconds: float):
        """The window under ``torch.profiler`` (the device's activity only,
        as :func:`bench.profile_window`), the capture reduced, with the
        collectives' device time and launches."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA if self.device.type == "cuda"
                else ProfilerActivity.CPU]
        with profile(activities=acts) as prof:
            run, samples = self.window(seconds, traced=True)
        events = prof.profiler.kineto_results.events()
        run.summary = trace.reduce(events, self.rec.spans)
        run.comm = collectives(events, self.rec.spans[trace.SOLVE])
        self.rec.spans = None
        return run, samples

    def device_block(self, summary) -> dict:
        """The result's ``device``: the fullest card's peak, and with a
        trace the busy seconds averaged over the cards and rank 0's traced
        window.  Every rank's peak goes to standard error."""
        if self.device.type == "cuda":
            block = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(self.device),
                     "count": self.world,
                     "memory_peak_bytes":
                         torch.cuda.max_memory_allocated(self.device)}
        else:
            block = {"platform": "cpu", "kind": "cpu", "count": self.world,
                     "memory_peak_bytes": 0}
        peaks = torch.zeros(self.world, dtype=torch.float64,
                            device=self.device)
        peaks[self.rank] = block["memory_peak_bytes"]
        dist.all_reduce(peaks)
        block["memory_peak_bytes"] = int(peaks.max())
        if self.rank == 0:
            print(f"perfbench: peak bytes by card {peaks.long().tolist()}",
                  file=sys.stderr)
        busy = self.agree(0.0 if summary is None else summary.busy_s,
                          dist.ReduceOp.SUM) / self.world
        if summary is not None:
            block["busy_s"] = busy
            block["window_s"] = summary.window_s
        return block

    def check(self, samples) -> dict:
        """``compare``'s numbers; NaN, so not correct, where on any rank the
        recorder missed an evaluation of a solve: the trajectory it keeps
        would then leave trips unchecked."""
        sv = self.config["solver"]
        first, results, unseen = samples
        if self.agree(unseen, dist.ReduceOp.MAX):
            if self.rank == 0:
                print("perfbench: not correct: the recorder did not see "
                      "every evaluation of a solve", file=sys.stderr)
            return {name: math.nan for name in check.NAMES}
        return compare(first, results, self.problem, sv["m"],
                       sv["max_linesearch_fev"])


def collectives(events, solves) -> tuple:
    """``(device seconds, launches)`` of the NCCL kernels that ran inside a
    solve (``solves``: [(start ns, end ns)]).  A solve ends with the card
    synchronised, so its kernels run inside its span; the window's own
    broadcast between solves is left out.  ``(0.0, 0)`` where the capture
    holds none."""
    from torch.autograd import DeviceType

    inside = trace._Spans(solves)
    ns = count = 0
    for e in events:
        if (e.device_type() != DeviceType.CPU and "nccl" in e.name().lower()
                and inside.holds(e.start_ns())):
            ns += e.end_ns() - e.start_ns()
            count += 1
    return ns * 1e-9, count


# -- the check ----------------------------------------------------------------


def compare(first, results, problem, m, max_fev) -> dict:
    """``check.compare``'s three numbers of a model-sharded window, each rank
    holding its coordinates: ``first`` is the first solve's start and its
    kept evaluations (points ``(calls, 1, n_local)``, values, gradients),
    ``results`` the first solves' returned points, values and gradients.
    ``check``'s own gaps run inside ``lbfgs_trip.over_ranks``, so each sum
    and largest magnitude over n takes in every rank's coordinates and every
    rank returns the same numbers."""
    f64 = torch.float64
    out = {name: 0.0 for name in check.NAMES}
    x0, xs, fs, gs = first
    with lbfgs_trip.over_ranks(dist.group.WORLD):
        by_trip = check.step_gaps(xs, fs, gs, x0[None], m, max_fev).tolist()
        for k in range(xs.shape[0]):
            out["eval_gap"] = check._worst(out["eval_gap"], check._eval_gap(
                xs[k].to(f64), fs[k].to(f64), gs[k].to(f64), problem))
        for x, f, g in results:
            x = x[None].to(f64)
            out["eval_gap"] = check._worst(out["eval_gap"], check._eval_gap(
                x, f.reshape(1).to(f64), g[None].to(f64), problem))
            out["f_final"] = check._worst(out["f_final"], float(
                (check._reference(problem, x)[0] - problem.F_STAR).max()))
    for v in by_trip:
        out["step_gap"] = check._worst(out["step_gap"], v)
    out["step_gap_by_trip"] = by_trip
    return out
