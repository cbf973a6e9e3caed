#!/usr/bin/env python3
"""Roofline of the port's batched L-BFGS step on an NVIDIA H100.

    python3 benchmarks_torch/roofline.py             # GRID, JSON, report
    python3 benchmarks_torch/roofline.py --profile   # and traces, profiles/
    python3 benchmarks_torch/roofline.py --shapes 1024x32,256x4096

The PyTorch/CUDA port's counterpart of ``benchmarks/roofline.py`` (which
stays the JAX package's and writes ``ROOFLINE.md``), under the same names
where the meaning is the same.  For a (B, n) grid of float32 solves of the
pairwise extended Rosenbrock with a fixed iteration budget inside the
descent phase, it measures the time of a batched iteration, derives the
achieved bandwidth from an itemized traffic model, and holds the time
against an attainable bound derived from the card's parameters.  It prints
one JSON line on stdout and writes ``ROOFLINE_TORCH.md`` at the root.

**The attainable bound** of a batched iteration (:func:`attainable_bound_ms`,
the JAX module's combination)::

    attainable = max(light, kernel + nfev x (eval + linesearch + trip floor)
                            + epilogue)

* ``kernel``, ``linesearch``, ``epilogue``: models of the flat trip's
  three phases (the direction step at the iteration boundary, a
  More-Thuente trip, the accept and progress step), each the larger of its
  operations at the card's peak rate and, for the direction step, its chain
  of 2m dependent reductions (:func:`chain_ms`).  Every fresh solve takes
  the flat loop, whose carry stays on the card between trips, so their
  bytes are left to ``light``.
* ``light``: the flat carry's bytes (:func:`flat_working_set`) in the L2
  regime: nothing where the carry fits the card's L2; else its excess over
  the L2, read once an iteration (:func:`bound_terms`).
* ``eval``: the evaluation's device time, measured
  (:func:`measure_eval_standalone`); ``trip floor``: the host-clock cost of
  an eager trip with trivial content (:func:`measure_loop_trip_overhead_us`).

Its inputs are the card's parameters (:class:`Card`), counts, the measured
evaluation and the measured trip floor, never a solver kernel's measured
time, so "% of attainable" moves when a kernel improves.  The direction
step's kernel timed alone (:func:`measure_kernel_standalone`) is a
diagnostic column.  The bottleneck label names the binding term.

**Where the port differs from the JAX module.**

* The time of a batched iteration is the host clock of the solves ending
  in a read on the host: the eager loop is host-bound (the card is busy a
  few per cent of a trip).  The card's busy time from ``torch.profiler``,
  from a traced run of its own, stands beside it.
* The TPU's VMEM regime becomes the L2's.  JAX charges the excess twice a
  trip (read and written), which holds only where each trip touches each
  byte; a mid-search trip of the port reads 5n a lane and never the
  history, so the excess is charged once an iteration, as reads: each
  iteration's boundary trip reads the whole history, and at most the L2's
  bytes can survive from the last.  Any L2 the evaluation's tensors or the
  split into two partitions take only adds traffic, so the charge stays a
  lower bound; dropping it where the carry fits is always valid.
* No batch-minor transposes: the port routes no solve there.
* ``xla_cost_analysis`` has no counterpart (the port has no XLA); its role,
  an independent check of the traffic model, goes to ``trip_work``'s
  counted bytes of one real solve (:func:`trip_work_cross_check`).
* The model-sharded point is one NCCL rank (:func:`measure_model_sharded`).

The bench legs' pieces live here too: :data:`GRID`, :func:`trip_work`,
:func:`trip_bound`, the two calibrations over ``ops/floors.py``'s kernels.
The measurements need a CUDA device and raise without one; nothing falls
back to the CPU.  Without a card the script prints nothing on stdout and
exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

__all__ = [
    "Card",
    "GRID",
    "HBM_BYTES_PER_S",
    "PEAK_OPS_PER_S",
    "analyze_shape",
    "attainable_bound_ms",
    "bound_terms",
    "card_line",
    "card_params",
    "chain_ms",
    "device_busy_us",
    "epilogue_model_ms",
    "fixed_iteration_stopping",
    "flat_working_set",
    "kernel_attainable_ms",
    "kernel_model_ms",
    "launch_chain",
    "linesearch_model_ms",
    "measure_eval_standalone",
    "measure_kernel_standalone",
    "measure_launch_overhead_us",
    "measure_loop_trip_overhead_us",
    "measure_model_sharded",
    "measure_shape",
    "measure_solver_shape",
    "phase_model_ms",
    "phase_work",
    "traffic_model_bytes",
    "trip_bound",
    "trip_floor_loop",
    "trip_work",
    "trip_work_cross_check",
    "write_markdown",
]

GRID = [(1024, 32), (8192, 32), (1024, 256), (1024, 1024), (256, 4096)]
#: NVIDIA H100 SXM (data sheet): HBM3 rate, and the peak rates outside the
#: tensor cores.  An FMA counts two there and one in the models' operation
#: counts, so the operations term stays a lower bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
#: The same data sheet's L2 cache and streaming multiprocessors; on a card
#: :func:`card_params` reads both from the device.
L2_BYTES = 50 * 1024 * 1024
SMS = 132
#: One dependent step of a reduction: a warp shuffle and the add that
#: consumes it.  An engineering estimate, as the JAX module's
#: ``SERIAL_DEP_NS`` is: a shuffle's result is of the order of 20 cycles
#: away and a dependent float add 4 (NVIDIA's latency guidance for Volta to
#: Hopper and published microbenchmarks); the low end, at the card's
#: highest boost clock (1,980 MHz), keeps the term a lower bound.  It is
#: fitted to no time the port measures.
DEP_STEP_CYCLES = 24
BOOST_CLOCK_HZ = 1.98e9
DEP_STEP_NS = DEP_STEP_CYCLES / BOOST_CLOCK_HZ * 1e9
#: What one SM holds at once (compute capability 9.0): blocks, threads,
#: shared memory, and the shared memory reserved for each block.  Registers
#: are left out: more blocks in flight than the card runs only lowers the
#: chain term.
SM_BLOCKS, SM_THREADS, SM_SMEM, SMEM_RESERVED = 32, 2048, 228 * 1024, 1024
#: The flat solve's history and search budget on the grid (chip_smoke.py's
#: main path: ``Lbfgs(m=10, max_linesearch_fev=20)``).
M = 10
MAX_FEV = 20
#: The calibration kernels' buffers (benchmarks/roofline.py's (8, 128)).
FLOOR_SHAPE = (8, 128)
#: The repeats of each calibration; the median slope is kept.
CALIBRATION_REPEATS = 3
#: Starting batches a fixed-budget measurement solves one after another
#: (benchmarks/roofline.py:192's pipeline).
PIPELINE = 4
#: measure_kernel_standalone's two chain lengths and its untimed warm-up
#: chain; the cycles the card spins ahead of each timed chain, so that the
#: host's launches queue up behind it.
KERNEL_CHAIN = (20, 220)
KERNEL_WARM = 20
KERNEL_PAD_CYCLES = 100_000_000
#: Evaluations whose device time measure_eval_standalone averages.
EVAL_CALLS = 20
#: The model-sharded point (benchmarks/roofline.py:810): n, the budgets
#: contrasted, the instances solved at each.
SHARDED_N = 4096
SHARDED_ITERS = (50, 400)
SHARDED_REPS = 8
#: Where the traffic model is checked against counted bytes (the shape of
#: benchmarks/roofline.py:1050's cost analysis).
CROSS_CHECK_SHAPE = (1024, 256)
#: The kernels whose two-loop is a chain of 2m dependent sums.
HISTORY_KERNELS = ("flat_trip", "lbfgs_prologue", "lbfgs_prologue_t",
                   "push_two_loop", "two_loop")
#: The bottleneck labels, the JAX module's, by binding term.
LABELS = ("HBM bandwidth", "direction-step kernel",
          "line-search trips (eval + loop floor)")
MARKDOWN = "ROOFLINE_TORCH.md"


def _cuda(device):
    import torch

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"this measurement needs a CUDA device, not "
                           f"{dev}")
    return dev


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# -- the card -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Card:
    """The parameters of the card that the bound reads."""

    kind: str
    l2_bytes: int
    sms: int
    hbm_bytes_per_s: float = HBM_BYTES_PER_S
    dep_step_ns: float = DEP_STEP_NS

    def ops_per_s(self, itemsize: int) -> float:
        return PEAK_OPS_PER_S["float32" if itemsize == 4 else "float64"]


def card_params(device=None) -> Card:
    """The card of ``device``, a CUDA device: its name, L2 size and SM count
    from ``torch.cuda.get_device_properties``.  With None, an H100 SXM by
    its data sheet (the CPU tests' card)."""
    if device is None:
        return Card("NVIDIA H100 SXM (data sheet)", L2_BYTES, SMS)
    import torch

    props = torch.cuda.get_device_properties(_cuda(device))
    return Card(props.name, int(props.L2_cache_size),
                int(props.multi_processor_count))


# -- counts and models --------------------------------------------------------


def fixed_iteration_stopping(iters, dtype=None):
    """Convergence tests off, to measure the step rate: ``x_delta``,
    ``f_delta``, ``gradient_norm`` and ``past`` 0 and ``max_iterations``
    ``iters`` on ``default_stopping(dtype)`` (float32 by default)."""
    import torch

    from benchmarks_torch.scaling import fixed_iter_stopping

    return fixed_iter_stopping(dtype or torch.float32, iters)


def fixed_budget(n: int) -> int:
    """The iterations of a fixed-budget solve at width n, inside the
    descent phase (benchmarks/roofline.py:209-214)."""
    return 50 if n <= 64 else 80 if n <= 1024 else 60


def traffic_model_bytes(batch, n, nfev_per_iter, m=M, itemsize=4):
    """Modelled device-memory bytes of one batched iteration (all lanes),
    itemized as the JAX module's: history 4mn, kernel i/o 5n, line search
    5n an evaluation, driver 12n a lane.  ``transposes`` is 0: the port
    routes no solve through the batch-minor history (``solvers/lbfgs.py``,
    ``_TRANSPOSED_N_MAX = 0``)."""
    history = 4 * m * n
    kernel_io = 5 * n
    transposes = 0
    linesearch = 5.0 * n * nfev_per_iter
    driver = 12 * n
    per_lane = itemsize * (
        history + kernel_io + transposes + linesearch + driver)
    return batch * per_lane, {
        "history": batch * itemsize * history,
        "kernel_io": batch * itemsize * kernel_io,
        "transposes": batch * itemsize * transposes,
        "linesearch": batch * itemsize * linesearch,
        "driver": batch * itemsize * driver,
    }


#: Elements a lane moves and operations it does in each phase of a flat
#: trip: the JAX module's counts (:470-530) without the TPU's 8- and
#: 128-padding.
_PHASE_WORK = {
    "direction": lambda m, n: (4 * m * n + 5 * n, 16 * m * n + 24 * n),
    "search": lambda m, n: (6 * n + 40, 8 * n),
    "epilogue": lambda m, n: (8 * n + 30, 12 * n),
}


def phase_work(phase, batch, n, m=M, itemsize=4):
    """``(bytes, operations)`` of one call of a phase over ``batch`` lanes:
    the direction step ("direction", push and two-loop), a More-Thuente
    trip ("search"), the accept and progress step ("epilogue")."""
    elems, ops = _PHASE_WORK[phase](m, n)
    return elems * batch * itemsize, ops * batch


def phase_model_ms(bytes_, ops, ops_rate, chain=0.0, bytes_rate=None):
    """The least time of one phase: the larger of its bytes at
    ``bytes_rate``, its operations at ``ops_rate`` and its dependent chain
    (ms).  ``bytes_rate=None`` drops the bytes term; dropping a term of a
    lower bound keeps it one."""
    bytes_term = bytes_ / bytes_rate * 1e3 if bytes_rate else 0.0
    return max(bytes_term, ops / ops_rate * 1e3, chain)


def reduction_depth(threads_per_lane: int) -> int:
    """Dependent steps of one sum over a lane's threads: five shuffles in a
    warp and, where the lane spans warps, one step through shared memory
    and the shuffles over the warps' partial sums."""
    warps = max(1, threads_per_lane // 32)
    if warps == 1:
        return 5
    return 5 + 1 + math.ceil(math.log2(warps))


def waves(mapping, card: Card) -> int:
    """The rounds of blocks the card runs one after another under
    ``mapping`` (an ``ops._kernel.LaneMapping``): its blocks over the SMs
    times the blocks an SM holds at once by threads and shared memory."""
    threads = mapping.lanes_per_block * mapping.threads_per_lane
    threads //= mapping.cluster
    fit = min(SM_BLOCKS, SM_THREADS // threads,
              SM_SMEM // (mapping.smem_bytes + SMEM_RESERVED))
    return -(-mapping.blocks // (card.sms * max(1, fit)))


def chain_ms(op, batch, n, card: Card, m=M, itemsize=4) -> float:
    """The dependent chain of a history kernel's two-loop: 2m sums, each
    as deep as the reduction tree that ``ops/_kernel.py::lane_mapping``
    gives ``op`` at this shape, in each wave of lanes, one dependent step
    at ``card.dep_step_ns``."""
    from cppnumericalsolvers_tpu_torch.ops._kernel import lane_mapping

    mp = lane_mapping(op, batch, n, m, itemsize)
    steps = 2 * m * reduction_depth(mp.threads_per_lane) * waves(mp, card)
    return steps * card.dep_step_ns * 1e-6


def kernel_model_ms(op, batch, n, card: Card, m=M, itemsize=4,
                    bytes_rate=None) -> float:
    """The least time of the direction step (push and two-loop) in the
    kernel ``op`` ("flat_trip" or "lbfgs_prologue"): its operations, its
    chain, and its bytes at ``bytes_rate`` where given."""
    byts, ops = phase_work("direction", batch, n, m, itemsize)
    return phase_model_ms(byts, ops, card.ops_per_s(itemsize),
                          chain_ms(op, batch, n, card, m, itemsize),
                          bytes_rate)


def linesearch_model_ms(batch, n, card: Card, itemsize=4,
                        bytes_rate=None) -> float:
    """The least time of one More-Thuente trip (``mt_trip``'s work)."""
    byts, ops = phase_work("search", batch, n, itemsize=itemsize)
    return phase_model_ms(byts, ops, card.ops_per_s(itemsize),
                          bytes_rate=bytes_rate)


def epilogue_model_ms(batch, n, card: Card, itemsize=4,
                      bytes_rate=None) -> float:
    """The least time of the accept and progress step
    (``lbfgs_epilogue``'s work)."""
    byts, ops = phase_work("epilogue", batch, n, itemsize=itemsize)
    return phase_model_ms(byts, ops, card.ops_per_s(itemsize),
                          bytes_rate=bytes_rate)


def flat_working_set(batch, n, m=M, itemsize=4) -> int:
    """Bytes of the flat loop's carry, the fields of ``ops/flat_solve.py``'s
    ``FlatState`` at their real widths: x0, g0, the direction and the
    accepted gradient (n each), the history s and y (m n each), the plateau
    ring, the float scalars and the int32 scalars, a lane."""
    from cppnumericalsolvers_tpu_torch.core.progress import PAST_RING_SIZE
    from cppnumericalsolvers_tpu_torch.ops import flat_solve as fs

    floats = 2 * m * n + 4 * n + PAST_RING_SIZE + fs._NF
    return batch * (floats * itemsize + fs._NI * 4)


def bound_terms(batch, n, card: Card, m=M, itemsize=4) -> dict:
    """The hardware-derived terms of a flat solve's batched iteration: the
    carry's working set and whether it fits the card's L2; ``light_ms``,
    the excess over the L2 read once an iteration at the card's memory rate
    (0 where it fits); and the three phase models (no bytes: the carry is
    ``light_ms``'s)."""
    ws = flat_working_set(batch, n, m, itemsize)
    excess = max(0, ws - card.l2_bytes)
    return {
        "working_set_bytes": ws,
        "l2_resident": excess == 0,
        "light_ms": excess / card.hbm_bytes_per_s * 1e3,
        "kernel_model_ms": kernel_model_ms("flat_trip", batch, n, card, m,
                                           itemsize),
        "linesearch_model_ms_per_trip": linesearch_model_ms(
            batch, n, card, itemsize),
        "epilogue_model_ms": epilogue_model_ms(batch, n, card, itemsize),
    }


def attainable_bound_ms(row, card: Card, eval_ms, trip_ms):
    """The attainable time of one batched iteration of ``row`` (its
    ``batch``, ``n`` and ``nfev_per_iter``): ``max(light, kernel + nfev x
    (eval + linesearch + trip floor) + epilogue)``, the JAX module's
    combination (``attainable_bound_us``), with ``eval_ms`` the evaluation's
    measured device time and ``trip_ms`` the measured trip floor.  Returns
    ``(attainable, light, serial, terms)``."""
    terms = bound_terms(row["batch"], row["n"], card)
    serial = (terms["kernel_model_ms"] + row["nfev_per_iter"] * (
        eval_ms + terms["linesearch_model_ms_per_trip"] + trip_ms)
        + terms["epilogue_model_ms"])
    light = terms["light_ms"]
    return (max(light, serial), light, serial,
            {**terms, "loop_trip_floor_ms": trip_ms})


def analyze_shape(row, card: Card, eval_ms, trip_ms):
    """Annotate a measured row (``batch``, ``n``, ``nfev_per_iter``,
    ``per_batched_iter_ms``) with the traffic model
    (``model_bytes_per_iter``, ``achieved_gbps``, ``hbm_utilization_pct``),
    the attainable bound's terms, ``attainable_ms``, ``pct_of_attainable``
    and the ``bottleneck`` its binding term names.  ``bench_torch.py``'s grid
    and ``ROOFLINE_TORCH.md`` take their labels from here."""
    nfev = row["nfev_per_iter"]
    bytes_total, _ = traffic_model_bytes(row["batch"], row["n"], nfev)
    t_ms = row["per_batched_iter_ms"]
    row["model_bytes_per_iter"] = bytes_total
    row["achieved_gbps"] = bytes_total / (t_ms * 1e-3) / 1e9
    row["hbm_utilization_pct"] = (
        100.0 * bytes_total / card.hbm_bytes_per_s * 1e3 / t_ms)
    row["eval_ms"] = eval_ms
    attainable, light, serial, terms = attainable_bound_ms(
        row, card, eval_ms, trip_ms)
    row.update(terms)
    row["serial_ms"] = serial
    row["attainable_ms"] = attainable
    row["pct_of_attainable"] = 100.0 * attainable / t_ms
    # The label names the binding term.
    if light >= serial:
        row["bottleneck"] = LABELS[0]
    elif terms["kernel_model_ms"] >= nfev * (
            eval_ms + terms["linesearch_model_ms_per_trip"] + trip_ms):
        row["bottleneck"] = LABELS[1]
    else:
        row["bottleneck"] = LABELS[2]
    return row


def kernel_attainable_ms(name, batch, n, bound_ms, bound_by, card: Card,
                         ops_ms=0.0, m=M, itemsize=4):
    """The attainable time of one launch of the kernel ``name`` at
    (batch, n) from the bound of its data, ``bound_ms`` by ``bound_by``
    (each input read once and each output written once at the memory rate,
    "bytes", or its operations at the peak rate, "operations"; ``ops_ms``,
    the operations' time where the bytes bind), and its regime: an
    operations bound stands; a bytes bound stands only for the bytes beyond
    the card's L2 ("bytes beyond L2"; where they fit, "fits L2", they may
    all come from it); a history kernel's chain
    (:func:`chain_ms`; ``lbfgs_prologue_t``, whose sums are
    ``lbfgs_prologue``'s, in one wave) is a floor beside either ("chain
    binds").  Returns ``(ms, regime)``."""
    from cppnumericalsolvers_tpu_torch.ops._kernel import lane_threads

    if bound_by == "operations":
        base, regime = bound_ms, "operations"
    else:
        beyond = max(0.0, bound_ms * 1e-3 * card.hbm_bytes_per_s
                     - card.l2_bytes)
        base = max(beyond / card.hbm_bytes_per_s * 1e3, ops_ms)
        regime = "bytes beyond L2" if beyond else "fits L2"
    chain = 0.0
    if name == "lbfgs_prologue_t":
        chain = (2 * m * reduction_depth(lane_threads(n))
                 * card.dep_step_ns * 1e-6)
    elif name in HISTORY_KERNELS:
        chain = chain_ms(name, batch, n, card, m, itemsize)
    if chain > base:
        regime += ", chain binds"
    return max(base, chain), regime


# -- trips: counted work, the bench's bound -----------------------------------


def trip_work(obj, x0, stop, m=M, max_fev=MAX_FEV) -> dict:
    """Bytes and operations one kernel solve's trips need, lane by lane:
    each input read once and each output written once, counted while the
    solve runs (``flat_trip`` on CUDA tensors, its plain version on the
    CPU).

    A dead lane reads x0 and writes the trial point.  A lane mid-search
    reads g_t, sdir, x0 and writes gacc and the trial point.  A lane at the
    iteration boundary reads x0, g0, sdir and its accepted gradient, reads
    the history rows its two-loop uses, writes x0, g0, sdir, gacc, the
    trial point, and the one row of s and of y that an accepted pair takes
    in the ring (at the head when the history is full, else at age count).
    Scalar rows count for every live lane.  Returns the means per trip, the
    trips, the solve's batched iterations, and the bound of one trip
    (``bound_ms``, ``bound_by``)."""
    import torch

    from cppnumericalsolvers_tpu_torch.ops import flat_solve as fs

    state0 = obj.evaluate(x0)
    b, n = x0.shape
    w = x0.element_size()
    tot = {"bytes": 0.0, "ops": 0.0, "trips": 0}
    lanes = torch.arange(b, device=x0.device)

    def counting(st, f_t, g_t, x_trial, stopping, max_fev):
        si0 = st.si.clone()
        c0 = si0[:, fs._I_COUNT].long()
        head = si0[:, fs._I_HEAD].long()
        slot = torch.where(c0 >= m, head, (head + c0) % m)
        s_row, y_row = st.s[lanes, slot].clone(), st.y[lanes, slot].clone()
        fs.flat_trip(st, f_t, g_t, x_trial, stopping, max_fev)
        dead = si0[:, fs._I_STATUS] != 0
        # A boundary lane counts one more iteration; a lane mid-search
        # does not.
        bnd = ~dead & (st.si[:, fs._I_NUMIT] != si0[:, fs._I_NUMIT])
        mid = ~dead & ~bnd
        acc = bnd & ((st.s[lanes, slot] != s_row).any(1)
                     | (st.y[lanes, slot] != y_row).any(1))
        c1 = st.si[:, fs._I_COUNT].long()
        hist_read = 2 * n * (c1 - acc.long()).clamp(min=0)
        hist_write = torch.where(acc, 2 * n, 0)
        scal = (2 * (fs._NF + 8) + 1) * w + 2 * fs._NI * 4
        elems = torch.where(dead, 2 * n, torch.where(
            mid, 5 * n, 9 * n + hist_read + hist_write))
        byts = elems * w + torch.where(dead, fs._NI * 4, scal)
        ops = torch.where(dead, 0, torch.where(
            mid, 4 * n, 24 * n + 10 * n * c1))
        tot["bytes"] += float(byts.sum())
        tot["ops"] += float(ops.sum())
        tot["trips"] += 1

    res = fs.flat_lbfgs_solve(obj, state0, stop, m=m, max_fev=max_fev,
                              trip=counting)
    dname = str(x0.dtype).split(".")[1]
    bytes_ms = tot["bytes"] / tot["trips"] / HBM_BYTES_PER_S * 1e3
    ops_ms = tot["ops"] / tot["trips"] / PEAK_OPS_PER_S[dname] * 1e3
    return {
        "trips": tot["trips"],
        "batched_iterations": int(res.progress.num_iterations.max()),
        "bytes_per_trip": tot["bytes"] / tot["trips"],
        "ops_per_trip": tot["ops"] / tot["trips"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def trip_bound(trips, bytes_per_trip, eval_ms, trip_floor_ms) -> dict:
    """The least time a flat solve of ``trips`` trips could take: the
    larger of its kernel bytes at 3.35 TB/s (``bytes``) and, trip by trip,
    the evaluation's device time plus the floor of an eager trip
    (``evaluation_and_trip_floor``).  Each term in ms, the binding one
    named."""
    terms = {
        "bytes": trips * bytes_per_trip / HBM_BYTES_PER_S * 1e3,
        "evaluation_and_trip_floor": trips * (eval_ms + trip_floor_ms),
    }
    by = max(terms, key=terms.get)
    return {"bound_ms": terms[by], "bound_by": by,
            **{f"{k}_ms": v for k, v in terms.items()}}


# -- the calibrations ---------------------------------------------------------


def trip_floor_loop(k, device):
    """``k`` trips of the port's eager loop with trivial content: each trip
    evaluates the grid's objective (``models.pairwise_rosenbrock``) at x
    through ``batched_value_and_grad`` (x of ``FLOOR_SHAPE`` read as 128
    lanes of n = 8: one closed-form launch, as a flat trip's evaluation),
    launches ``trip_floor`` once on its 8 buffers, and reads one any-lane
    predicate (``core.tree.any_lane`` of ``i < k``): an evaluation, one
    launch and one status read, the structure of a flat trip.
    ``benchmarks/roofline.py``'s skeleton also steps x through a transpose
    pair, which XLA fuses into its loop; a flat trip of the port has no
    such launches, and a floor must hold no work the trip does not.
    Returns ``(x, buffers)``."""
    import torch

    import cppnumericalsolvers_tpu_torch as cns
    from cppnumericalsolvers_tpu_torch.core.tree import any_lane
    from cppnumericalsolvers_tpu_torch.ops import floors

    obj = cns.models.pairwise_rosenbrock()
    x = torch.ones(FLOOR_SHAPE, dtype=torch.float32, device=device)
    lanes = x.view(FLOOR_SHAPE[1], FLOOR_SHAPE[0])
    bufs = [torch.full(FLOOR_SHAPE, float(i), dtype=torch.float32,
                       device=device)
            for i in range(floors.TRIP_FLOOR_BUFFERS)]
    i = torch.zeros((), dtype=torch.int32, device=device)
    while True:
        obj.batched_value_and_grad(lanes)
        floors.trip_floor(bufs)
        i = i + 1
        if not any_lane(i < k):
            return x, bufs


def device_busy_us(fn, trace_path=None):
    """The card's busy time while ``fn()`` runs, by ``torch.profiler``: the
    device time of every kernel and copy, summed.  None where the profiler
    shows no device time.  With ``trace_path`` the capture is also written
    there as a Chrome trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    if trace_path:
        os.makedirs(os.path.dirname(os.path.abspath(trace_path)),
                    exist_ok=True)
        prof.export_chrome_trace(trace_path)
    total = sum(e.device_time_total for e in prof.events()
                if e.device_type == DeviceType.CUDA)
    return float(total) if total else None


def _host_slope_us(run, lo, hi):
    """The median over CALIBRATION_REPEATS of ``(t(hi) - t(lo)) / (hi -
    lo)`` in microseconds, each ``run(k)`` timed on the host clock between
    two synchronises; and the slopes."""
    import torch

    def timed(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(k)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    slopes = [(timed(hi) - timed(lo)) / (hi - lo) * 1e6
              for _ in range(CALIBRATION_REPEATS)]
    return statistics.median(slopes), slopes


def measure_loop_trip_overhead_us(reps_lo=100, reps_hi=900,
                                  device="cuda") -> dict:
    """The floor of one trip of the port's eager loop (:func:`trip_floor_loop`
    on ``device``, a CUDA device), two ways:

    * ``host_us``: host-clock time a trip, the slope between ``reps_lo``
      and ``reps_hi`` trips, each run ending in ``synchronize()``
      (the median of three slopes);
    * ``device_us``: the card's busy time a trip over ``reps_lo`` trips,
      from ``torch.profiler``'s device times (None: not measured).

    The JAX package's figure is the device duration of a compiled loop
    (``lax.while_loop``); this port's loop runs on the host, so its floor
    is a host-clock number, and the card is idle for most of it."""
    dev = _cuda(device)
    trip_floor_loop(reps_lo, dev)  # warm: allocator, kernel library
    host, slopes = _host_slope_us(lambda k: trip_floor_loop(k, dev),
                                  reps_lo, reps_hi)
    busy = device_busy_us(lambda: trip_floor_loop(reps_lo, dev))
    return {"host_us": host, "host_us_runs": slopes,
            "device_us": None if busy is None else busy / reps_lo,
            "trips": [reps_lo, reps_hi]}


def launch_chain(k, a, b):
    """``k`` dependent ``launch_floor`` launches, ``a`` and ``b`` taking
    turns as input and output; returns the last output."""
    from cppnumericalsolvers_tpu_torch.ops import floors

    for _ in range(k):
        floors.launch_floor(a, out=b)
        a, b = b, a
    return a


def measure_launch_overhead_us(reps_lo=200, reps_hi=1800,
                               device="cuda") -> dict:
    """The cost of one launch of the port's kernels, by chains of
    ``reps_lo`` and ``reps_hi`` dependent ``launch_floor`` launches on
    ``device`` (a CUDA device), the slope of the time over the chain's
    length (the median of three):

    * ``host_us``: launched from the host, the cost the port's eager loops
      pay, on the host clock ending in ``synchronize()``;
    * ``graph_us``: the same chains captured in a ``torch.cuda.CUDAGraph``
      and replayed, the counterpart of the JAX package's chain, one
      compiled ``lax.scan``."""
    import torch

    dev = _cuda(device)
    a = torch.zeros(FLOOR_SHAPE, dtype=torch.float32, device=dev)
    b = torch.empty_like(a)
    launch_chain(reps_lo, a, b)  # warm
    host, host_runs = _host_slope_us(lambda k: launch_chain(k, a, b),
                                     reps_lo, reps_hi)
    graphs = {}
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        launch_chain(2, a, b)
    torch.cuda.current_stream(dev).wait_stream(side)
    for k in (reps_lo, reps_hi):
        graphs[k] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[k]):
            launch_chain(k, a, b)
        graphs[k].replay()
    graph, graph_runs = _host_slope_us(lambda k: graphs[k].replay(),
                                       reps_lo, reps_hi)
    return {"host_us": host, "host_us_runs": host_runs,
            "graph_us": graph, "graph_us_runs": graph_runs,
            "launches": [reps_lo, reps_hi]}


# -- the fixed-budget measurements --------------------------------------------


def starts(batch, n, count=1, dtype=None, device="cpu"):
    """``count`` starting batches from ``numpy.random.default_rng(0)``,
    uniform in [-2, 2], in the JAX module's order (float32 by default)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    dtype = dtype or torch.float32
    return [torch.from_numpy(rng.uniform(-2.0, 2.0, (batch, n))).to(
        device=device, dtype=dtype) for _ in range(count)]


def _run_pipelined(obj, solver, x0s, stopping, device, internals=None):
    """The batched solves of ``x0s``, one after another: ``(host seconds,
    summed lane iterations, summed nfev, trips of each solve)``.  The timed
    region ends once the sums are on the host, which waits for the card."""
    import cppnumericalsolvers_tpu_torch as cns

    _sync(device)
    t0 = time.perf_counter()
    iters = nfev = 0
    trips = []
    for x0 in x0s:
        res = cns.minimize_batched(obj, x0, solver, stopping,
                                   internals=internals, device=device)
        iters = iters + res.progress.num_iterations.sum()
        nfev = nfev + res.state.nfev.sum()
        trips.append(res.trips)
    iters, nfev = float(iters), float(nfev)
    return time.perf_counter() - t0, iters, nfev, trips


def _fixed_budget_row(batch, n, obj, solver, x0s, stopping, dev,
                      internals=None, trace_path=None) -> dict:
    """One warm run of the solves, one untimed by the profiler (its host
    clock: ``per_batched_iter_ms``), and the first solve traced (the card's
    busy time; one batch keeps the profiler's own processing short)."""
    warm = _run_pipelined(obj, solver, x0s, stopping, dev, internals)
    wall, iters, nfev, trips = _run_pipelined(obj, solver, x0s, stopping,
                                              dev, internals)
    traced = []
    busy = device_busy_us(lambda: traced.append(_run_pipelined(
        obj, solver, x0s[:1], stopping, dev, internals)), trace_path)
    per_iter_ms = wall * 1e3 / (iters / batch)
    busy_ms = (None if busy is None
               else busy / 1e3 / (traced[0][1] / batch))
    return {
        "batch": batch, "n": n, "dtype": "float32", "pipeline": len(x0s),
        "batched_iterations": iters / batch, "trips": sum(trips),
        "traced_batched_iterations": traced[0][1] / batch,
        "trips_runs": [sum(warm[3]), sum(trips), sum(traced[0][3])],
        "wall_s": wall,
        "per_batched_iter_ms": per_iter_ms,
        "lane_iters_per_s": batch / (per_iter_ms * 1e-3),
        "nfev_per_iter": nfev / iters,
        "device_busy_ms_per_iter": busy_ms,
        "device_busy_pct": None if busy_ms is None
        else 100.0 * busy_ms / per_iter_ms,
    }


def measure_shape(batch, n, pipeline=PIPELINE, device="cuda",
                  profile_dir=None) -> dict:
    """The time of a batched iteration of ``Lbfgs(m=10)`` at (batch, n):
    ``pipeline`` float32 batches of the pairwise extended Rosenbrock from
    :func:`starts`, solved one after another with the convergence tests
    off for :func:`fixed_budget` iterations (inside the descent phase).
    ``per_batched_iter_ms`` is the host clock of an untraced run over its
    batched iterations; ``device_busy_ms_per_iter`` the card's busy time
    in a traced solve of the first batch (tracing inflates the host's time,
    so the two come from different runs).  With ``profile_dir`` the traced
    run's Chrome trace is written there."""
    import cppnumericalsolvers_tpu_torch as cns

    dev = _cuda(device)
    iters = fixed_budget(n)
    obj = cns.models.pairwise_rosenbrock().with_mode("first")
    trace = (os.path.join(profile_dir, "trace.json") if profile_dir
             else None)
    row = _fixed_budget_row(batch, n, obj, cns.Lbfgs(m=M),
                            starts(batch, n, pipeline, device=dev),
                            fixed_iteration_stopping(iters), dev,
                            trace_path=trace)
    row["iterations"] = iters
    return row


def measure_solver_shape(batch, n, solver, mode="first", internals=None,
                         pipeline=8, iters_hi=12, device="cuda") -> dict:
    """:func:`measure_shape` for any solver (and its ``internals``, e.g.
    L-BFGS-B's boxes) on the objective downgraded to ``mode``, with
    ``iters_hi`` iterations, which must stay inside the solver's descent
    phase."""
    import cppnumericalsolvers_tpu_torch as cns

    dev = _cuda(device)
    obj = cns.models.pairwise_rosenbrock().with_mode(mode)
    row = _fixed_budget_row(batch, n, obj, solver,
                            starts(batch, n, pipeline, device=dev),
                            fixed_iteration_stopping(iters_hi), dev,
                            internals)
    row["iterations"] = iters_hi
    return row


def measure_kernel_standalone(batch, n, m=M, k_lo=KERNEL_CHAIN[0],
                              k_hi=KERNEL_CHAIN[1], device="cuda") -> dict:
    """Device time of one launch of the direction-step kernel
    (``lbfgs_prologue``, batch-major) at (batch, n), float32: chains of
    ``k_lo`` and ``k_hi`` launches on made-up inputs (a full history,
    every pending pair accepted, so each launch shifts the history), each
    enqueued behind a spin of the card and timed with CUDA events, and
    contrasted.  One untimed chain of :data:`KERNEL_WARM` launches comes
    first.  A diagnostic: the bound never reads it.  ``starved`` lists the
    chains whose spin ended before the last launch was enqueued."""
    import numpy as np
    import torch

    from cppnumericalsolvers_tpu_torch.ops.fused_step import lbfgs_prologue

    dev = _cuda(device)
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    x, g = normal(batch, n), normal(batch, n)
    s = normal(batch, m, n, scale=0.1)
    y = s + normal(batch, m, n, scale=0.03)
    s_new = normal(batch, n, scale=0.1)
    y_new = s_new + normal(batch, n, scale=0.03)
    count = torch.full((batch,), m, dtype=torch.int32, device=dev)
    gamma = torch.ones(batch, dtype=torch.float32, device=dev)
    valid = torch.ones(batch, dtype=torch.bool, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)

    def chain(k):
        # One stream runs the launches one after another.
        for _ in range(k):
            lbfgs_prologue(x, g, s, y, count, gamma, s_new, y_new, valid,
                           done)

    chain(KERNEL_WARM)
    ms, starved = {}, []
    for k in (k_lo, k_hi):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(KERNEL_PAD_CYCLES)
        a.record()
        chain(k)
        if a.query():
            starved.append(k)
        z.record()
        torch.cuda.synchronize()
        ms[k] = a.elapsed_time(z)
    per = (ms[k_hi] - ms[k_lo]) / (k_hi - k_lo)
    byts, _ = phase_work("direction", batch, n, m, 4)
    return {"kernel_ms": per, "kernel_gbps": byts / (per * 1e-3) / 1e9,
            "chain_walls_ms": [ms[k_lo], ms[k_hi]],
            "launches": [k_lo, k_hi],
            "warm_launches": KERNEL_WARM, "starved": starved}


def measure_eval_standalone(batch, n, k=EVAL_CALLS, device="cuda"):
    """Device ms of one batched ``value_and_grad`` of the pairwise extended
    Rosenbrock at a (batch, n) float32 start from :func:`starts`, the floor
    of every trip: the card's busy time over ``k`` calls
    (``torch.profiler``) over ``k``; None where the profiler shows no device
    time.  One stream runs the calls one after another, and eager PyTorch
    eliminates none, so they need no data dependence (JAX's chain feeds
    each point to the next for XLA's sake)."""
    import cppnumericalsolvers_tpu_torch as cns

    dev = _cuda(device)
    obj = cns.models.pairwise_rosenbrock()
    x = starts(batch, n, device=dev)[0]
    obj.batched_value_and_grad(x)  # warm
    busy = device_busy_us(
        lambda: [obj.batched_value_and_grad(x) for _ in range(k)])
    return None if busy is None else busy / k / 1e3


def measure_model_sharded(n=SHARDED_N, iters_lo=SHARDED_ITERS[0],
                          iters_hi=SHARDED_ITERS[1], reps=SHARDED_REPS,
                          device="cuda") -> dict:
    """Time of an iteration of one instance with x sharded over the model
    axis (``parallel.minimize_model_sharded``, ``Lbfgs(m=10,
    two_loop_impl="xla")``) on a world of one NCCL rank: ``reps`` float32
    instances of the view-form extended Rosenbrock from
    ``default_rng(0)``, solved with :func:`fixed_iteration_stopping` at
    ``iters_lo`` and at ``iters_hi`` iterations (after one warm solve), and
    the host times contrasted over the iterations.  The process joins the
    world through a ``FileStore`` under ``build/`` and leaves it, as
    ``chip_smoke.py``'s ``parallel_main`` does; a world of one measures the
    sharded loop's own cost, not scaling (``benchmarks_torch/scaling.py``).

    At n = 4096 the longer budget runs past the descent phase into line
    searches of several evaluations an iteration, so the contrast is
    given per evaluation too, beside the evaluations an iteration in the
    short budget and in the contrast (``nfev_per_iter``): the time an
    iteration is the stalled loop's, not the descent phase's."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import cppnumericalsolvers_tpu_torch as cns
    from benchmarks_torch.scaling import objective
    from cppnumericalsolvers_tpu_torch import parallel

    dev = _cuda(device)
    x0s = torch.from_numpy(np.random.default_rng(0).uniform(
        -2.0, 2.0, (reps, n))).to(device=dev, dtype=torch.float32)
    store = os.path.join(ROOT, "build", f"roofline_store_{os.getpid()}")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    try:
        mesh = parallel.make_mesh(axis="model", device=dev)
        obj = objective()
        solver = cns.Lbfgs(m=M, two_loop_impl="xla")

        def run(iters, rows):
            stop = fixed_iteration_stopping(iters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            its = nfev = 0
            for i in rows:
                res = parallel.minimize_model_sharded(
                    obj, x0s[i], solver, stop, mesh=mesh, device=dev)
                its += int(res.progress.num_iterations)
                nfev += int(res.state.nfev)
            return time.perf_counter() - t0, its, nfev

        run(iters_lo, range(1))  # warm: NCCL's set-up, the allocator
        (w1, i1, f1), (w2, i2, f2) = (run(it, range(reps))
                                      for it in (iters_lo, iters_hi))
    finally:
        dist.destroy_process_group()
        os.remove(store)
    return {"n": n, "mesh_devices": 1, "reps": reps,
            "budgets": [iters_lo, iters_hi],
            "iterations": [i1, i2], "nfev": [f1, f2],
            "wall_s": [w1, w2],
            "nfev_per_iter": [f1 / max(i1, 1), (f2 - f1) / max(i2 - i1, 1)],
            "per_iter_ms_model_sharded": (w2 - w1) * 1e3 / max(i2 - i1, 1),
            "per_eval_ms_model_sharded": (w2 - w1) * 1e3 / max(f2 - f1, 1)}


def trip_work_cross_check(batch=CROSS_CHECK_SHAPE[0],
                          n=CROSS_CHECK_SHAPE[1], device="cuda") -> dict:
    """The traffic model against the bytes one real solve needs: a
    fixed-budget float32 solve at (batch, n) from :func:`starts`, its
    trips' bytes and operations counted lane by lane by :func:`trip_work`
    (each input read once, each output written once), a batched iteration,
    beside :func:`traffic_model_bytes` at the same nfev.  The port has no
    XLA, so this takes the place of ``xla_cost_analysis``."""
    import cppnumericalsolvers_tpu_torch as cns

    dev = _cuda(device)
    obj = cns.models.pairwise_rosenbrock()
    work = trip_work(obj, starts(batch, n, device=dev)[0],
                     fixed_iteration_stopping(fixed_budget(n)))
    its = work["batched_iterations"]
    nfev = work["trips"] / its
    model, parts = traffic_model_bytes(batch, n, nfev)
    counted = work["bytes_per_trip"] * work["trips"] / its
    return {"batch": batch, "n": n, "trips": work["trips"],
            "batched_iterations": its, "nfev_per_iter": nfev,
            "counted_bytes_per_iter": counted,
            "counted_ops_per_iter": work["ops_per_trip"] * nfev,
            "model_bytes_per_iter": model, "model_parts": parts,
            "counted_over_model": counted / model}


# -- the report ---------------------------------------------------------------


def write_markdown(rows, card: Card, path, power_limit=None, sharded=None,
                   cross=None, op_tables=None) -> None:
    """``ROOFLINE_TORCH.md``: the grid's rows, the model-sharded point, the
    cross-check of the traffic model, the definition of the bound, and
    (``--profile``) the traces' op tables."""
    lines = [
        "# Roofline: the port's batched L-BFGS step on the card",
        "",
        f"Card: {card.kind}, power limit {power_limit or 'not read'}; "
        f"{card.sms} SMs, L2 {card.l2_bytes / 2**20:.0f} MiB; memory "
        f"rate {card.hbm_bytes_per_s / 1e12:.2f} TB/s, float32 "
        f"{PEAK_OPS_PER_S['float32'] / 1e12:.0f} TFLOP/s outside the tensor "
        f"cores (data sheet); one dependent reduction step "
        f"{card.dep_step_ns:.2f} ns (an estimate, fitted to nothing).",
        "",
        "Written by `python3 benchmarks_torch/roofline.py`.  Workload: the "
        "pairwise extended Rosenbrock, float32, `Lbfgs(m=10)` with "
        "More-Thuente (the flat loop: one evaluation and one `flat_trip` "
        "launch a trip), the convergence tests off, a fixed budget inside "
        "the descent phase (50, 80 or 60 iterations by n), "
        f"{PIPELINE} batches from seed 0 solved one after another.  Time of "
        "a batched iteration: the host clock of an untraced run ending in a "
        "read on the host; the card's busy time: `torch.profiler` on a "
        "traced run of its own.",
        "",
        "| B | n | regime | ms/iter (host) | card busy ms/iter (%) | "
        "lane-iters/s | nfev/iter | model MB/iter | achieved GB/s | "
        "HBM util % | prologue alone ms (GB/s) | kernel model ms | eval ms "
        "| attainable ms | % of attainable | bottleneck |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        regime = "L2" if r.get("l2_resident") else "L2 + HBM excess"
        busy = r.get("device_busy_ms_per_iter")
        busy_s = ("n/a" if busy is None
                  else f"{busy:.4f} ({r['device_busy_pct']:.1f}%)")
        kern = ("n/a" if r.get("kernel_ms") is None
                else f"{r['kernel_ms']:.4f} ({r['kernel_gbps']:.0f})")
        lines.append(
            f"| {r['batch']} | {r['n']} | {regime} | "
            f"{r['per_batched_iter_ms']:.4f} | {busy_s} | "
            f"{r['lane_iters_per_s']:.4g} | {r['nfev_per_iter']:.3f} | "
            f"{r['model_bytes_per_iter'] / 1e6:.2f} | "
            f"{r['achieved_gbps']:.1f} | {r['hbm_utilization_pct']:.2f} | "
            f"{kern} | {r['kernel_model_ms']:.5f} | "
            f"{r['eval_ms']:.4f} | {r['attainable_ms']:.4f} | "
            f"{r['pct_of_attainable']:.1f}% | {r['bottleneck']} |")
    if rows:
        trip = rows[0]["loop_trip_floor_ms"]
        lines += ["", f"Trip floor (host clock, an eager trip with trivial "
                      f"content): {trip:.4f} ms."]
    if sharded:
        lines += [
            "",
            f"Model-sharded point (`parallel.minimize_model_sharded`, "
            f"`two_loop_impl=\"xla\"`, a world of "
            f"{sharded['mesh_devices']} NCCL rank, one instance of n = "
            f"{sharded['n']}, {sharded['reps']} instances at "
            f"{sharded['budgets'][0]} and {sharded['budgets'][1]} "
            f"iterations contrasted): "
            f"{sharded['per_iter_ms_model_sharded']:.3f} ms an "
            f"iteration, {sharded['per_eval_ms_model_sharded']:.3f} ms an "
            f"evaluation.  The evaluations an iteration are "
            f"{sharded['nfev_per_iter'][0]:.2f} in the first "
            f"{sharded['budgets'][0]} iterations and "
            f"{sharded['nfev_per_iter'][1]:.2f} in the contrast: the longer "
            "budget runs past the descent phase into stalled line searches, "
            "so the time an iteration is not the sharded loop's cost in the "
            "descent phase; the time an evaluation is the steadier figure.  "
            "Scaling over cards is `benchmarks_torch/scaling.py`'s.",
        ]
    if cross:
        lines += [
            "",
            f"Traffic model against counted bytes (in place of XLA's cost "
            f"analysis, which the port has not: `trip_work` counts each "
            f"input read once and each output written once, lane by lane, "
            f"over one fixed-budget solve at ({cross['batch']}, "
            f"{cross['n']})): {cross['counted_bytes_per_iter'] / 1e6:.2f} MB "
            f"a batched iteration counted, "
            f"{cross['model_bytes_per_iter'] / 1e6:.2f} MB modelled "
            f"(ratio {cross['counted_over_model']:.3f}; the model charges "
            "the whole history read and written, and the driver's 12n).",
        ]
    lines += [
        "",
        "**Attainable bound**: per batched iteration, `max(light, kernel + "
        "nfev x (eval + linesearch + trip floor) + epilogue)`.  `kernel`, "
        "`linesearch` and `epilogue` are hardware-derived models of the flat "
        "trip's phases (operations at the peak rate; the direction step's "
        "2m dependent sums at one reduction step each); `eval` is the "
        "evaluation's measured device time, the trip floor the measured "
        "host cost of an eager trip with trivial content; `light` is 0 "
        "where the flat carry fits the L2 (the regime column), else its "
        "excess over the L2 read once an iteration at the memory rate.  No "
        "input is a solver kernel's measured time: the prologue's own time "
        "is a diagnostic column.  The excess is charged once an iteration "
        "and not twice a trip, as the JAX module does: that charge holds "
        "only where each trip touches each byte, and a mid-search trip "
        "reads 5n a lane and never the history.  The bottleneck names the "
        "binding term.",
        "",
    ]
    if op_tables:
        lines += ["## Op tables of the traced runs "
                  "(`benchmarks_torch/trace_table.py`)"]
        for title, table in op_tables:
            lines += ["", f"### {title}", "", table]
        lines.append("")
    with open(path, "w") as fh:
        fh.write("\n".join(lines))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _shapes(text):
    return [tuple(int(v) for v in s.split("x")) for s in text.split(",")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="write torch.profiler traces under profiles/")
    ap.add_argument("--shapes", type=_shapes, default=GRID,
                    help="comma list like 1024x32,256x4096 (default: GRID)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("roofline: no CUDA device is available; nothing was run.",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from benchmarks_torch import trace_table
    from cppnumericalsolvers_tpu_torch.ops import _build

    def log(msg):
        print(f"[roofline] {msg}", file=sys.stderr, flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    line = card_line()
    power_limit = line.rsplit(",", 1)[1].strip()
    card = card_params(dev)
    log(f"{line} | {card}")
    _build.build_all()
    trip = measure_loop_trip_overhead_us(device=dev)
    trip_ms = trip["host_us"] / 1e3
    log(f"trip floor {trip['host_us']:.2f} us (host)")
    rows, op_tables = [], []
    for b, n in args.shapes:
        pdir = (os.path.join(ROOT, "profiles", f"torch_lbfgs_b{b}_n{n}")
                if args.profile else None)
        row = measure_shape(b, n, device=dev, profile_dir=pdir)
        k = measure_kernel_standalone(b, n, device=dev)
        row.update(kernel_ms=k["kernel_ms"], kernel_gbps=k["kernel_gbps"],
                   kernel_starved=k["starved"],
                   kernel_pct_of_step=100.0 * k["kernel_ms"]
                   / row["per_batched_iter_ms"])
        eval_ms = measure_eval_standalone(b, n, device=dev)
        if eval_ms is None:
            raise RuntimeError("torch.profiler showed no device time for "
                               "the evaluation")
        rows.append(analyze_shape(row, card, eval_ms, trip_ms))
        log(json.dumps(row))
        if pdir:
            try:
                op_tables.append((f"(B={b}, n={n})", trace_table.format_table(
                    pdir, top=12,
                    iters=round(row["traced_batched_iterations"]))))
            except SystemExit as e:  # a capture with no device event
                log(str(e))
    cross = trip_work_cross_check(device=dev)
    log(json.dumps(cross))
    sharded = measure_model_sharded(device=dev)
    log(json.dumps(sharded))
    write_markdown(rows, card, os.path.join(ROOT, MARKDOWN), power_limit,
                   sharded, cross, op_tables)
    out = {
        "metric": "lbfgs_roofline_grid",
        "device_kind": torch.cuda.get_device_name(0),
        "power_limit": power_limit,
        "peak_hbm_gbps": card.hbm_bytes_per_s / 1e9,
        "card": dataclasses.asdict(card),
        "trip_floor": trip,
        "shapes": rows,
        "model_sharded_point": sharded,
        # The port has no XLA: trip_work's counted bytes of one real solve
        # take the place of xla_cost_analysis_b1024_n256.
        "trip_work_b1024_n256": cross,
        "markdown": MARKDOWN,
    }
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "roofline_torch.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    over = [(r["batch"], r["n"]) for r in rows
            if not r["pct_of_attainable"] <= 100.0]
    if over:
        log(f"rows above 100% of their attainable bound: {over}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
