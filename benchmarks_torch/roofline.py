"""The bound of the port's bench legs on an NVIDIA H100.

The port's counterparts of what ``bench.py``'s legs take from
``benchmarks/roofline.py``, under the same names where the meaning is the
same:

* :data:`GRID`, the throughput grid's five shapes
  (``benchmarks/roofline.py:100``);
* :func:`trip_work`, the bytes and operations one flat solve's trips need
  (``chip_smoke.py``'s timing phase calls it too);
* :func:`measure_loop_trip_overhead_us`, the floor of one trip of the port's
  eager loop, over the ``trip_floor`` kernel (``ops/floors.py``);
* :func:`measure_launch_overhead_us`, the cost of one launch of the port's
  kernels, over the ``launch_floor`` kernel, from the host and in a CUDA
  graph;
* :func:`trip_bound`, the least time a flat solve could take: the larger of
  its kernel bytes at the card's memory rate and its evaluations' device
  time plus the trip floor, trip by trip.

``benchmarks/roofline.py``'s VMEM-residency and VPU model is the TPU's and
is not carried over.  The measurements need a CUDA device and raise
without one; nothing here falls back to the CPU.
"""

from __future__ import annotations

import statistics
import time

__all__ = [
    "GRID",
    "HBM_BYTES_PER_S",
    "PEAK_OPS_PER_S",
    "device_busy_us",
    "launch_chain",
    "measure_launch_overhead_us",
    "measure_loop_trip_overhead_us",
    "trip_bound",
    "trip_floor_loop",
    "trip_work",
]

GRID = [(1024, 32), (8192, 32), (1024, 256), (1024, 1024), (256, 4096)]
#: NVIDIA H100 SXM (data sheet): HBM3 rate, and the peak rates outside the
#: tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
#: The flat solve's history and search budget on the grid (chip_smoke.py's
#: main path: ``Lbfgs(m=10, max_linesearch_fev=20)``).
M = 10
MAX_FEV = 20
#: The calibration kernels' buffers (benchmarks/roofline.py's (8, 128)).
FLOOR_SHAPE = (8, 128)
#: The repeats of each calibration; the median slope is kept.
CALIBRATION_REPEATS = 3


def _cuda(device):
    import torch

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"this measurement needs a CUDA device, not "
                           f"{dev}")
    return dev


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
    trips, and the bound of one trip (``bound_ms``, ``bound_by``)."""
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

    fs.flat_lbfgs_solve(obj, state0, stop, m=m, max_fev=max_fev,
                        trip=counting)
    dname = str(x0.dtype).split(".")[1]
    bytes_ms = tot["bytes"] / tot["trips"] / HBM_BYTES_PER_S * 1e3
    ops_ms = tot["ops"] / tot["trips"] / PEAK_OPS_PER_S[dname] * 1e3
    return {
        "trips": tot["trips"],
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


def trip_floor_loop(k, device):
    """``k`` trips of the port's eager loop with trivial content, as
    ``benchmarks/roofline.py``'s trip skeleton: each trip evaluates the
    objective ``sum(x * x)`` of ``x.T`` ((128, 8): 128 lanes of n = 8)
    through ``batched_value_and_grad``, steps ``x - 1e-9 g`` transposed
    back, launches ``trip_floor`` once on its 8 buffers, and reads one
    any-lane predicate (``core.tree.any_lane`` of ``i < k``): an
    evaluation, one launch and one status read, the structure of a flat
    trip.  Returns ``(x, buffers)``."""
    import torch

    import cppnumericalsolvers_tpu_torch as cns
    from cppnumericalsolvers_tpu_torch.core.tree import any_lane
    from cppnumericalsolvers_tpu_torch.ops import floors

    obj = cns.objective(lambda v: torch.sum(v * v))
    x = torch.ones(FLOOR_SHAPE, dtype=torch.float32, device=device)
    bufs = [torch.full(FLOOR_SHAPE, float(i), dtype=torch.float32,
                       device=device)
            for i in range(floors.TRIP_FLOOR_BUFFERS)]
    i = torch.zeros((), dtype=torch.int32, device=device)
    while True:
        _, g = obj.batched_value_and_grad(x.T)
        x = x - 1e-9 * g.T
        floors.trip_floor(bufs)
        i = i + 1
        if not any_lane(i < k):
            return x, bufs


def device_busy_us(fn):
    """The card's busy time while ``fn()`` runs, by ``torch.profiler``: the
    device time of every kernel and copy, summed.  None where the profiler
    shows no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
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
