#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one GPU

The main path is the batched L-BFGS / More-Thuente solve,
``minimize_batched(objective, x0_batch, Lbfgs(m=10))``, whose loop trip is
one batched objective evaluation plus one ``flat_trip`` kernel launch.

Phases (each raises on failure, so the script then exits non-zero):

1. build   compile ``ops/csrc/flat_trip.cu`` with nvcc for sm_90a and load it;
2. card    print the card's name and power limit (nvidia-smi);
3. parity  ~50 trips of a plain-version solve; at every trip the identical
           state goes through the kernel and through the plain version, and
           every output is compared (float64 and float32);
4. main    ``minimize_batched`` in float32 on the pairwise extended
           Rosenbrock at the throughput-grid shapes the flat path serves,
           launch counts set to 0 just before and read just after; the result
           is held against the same solve through the plain version on the
           card; one float64 solve must agree lane for lane; ``minimize`` on
           the 2-D Rosenbrock must reach (1, 1);
5. timing  CUDA events around every trip and evaluation, plain, kernel,
           kernel, plain, on the host clock and on the card's own time, and
           a count of the bytes and operations each trip's data needs;
6. report  one JSON line per shape, the ``kernels`` line, the card line and,
           last, the device line.  ``chiprun_out/chip_smoke.json`` keeps the
           full record.

With no GPU it prints no result and exits 1; nothing runs on the CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

SEED = 0
M = 10
MAX_FEV = 20
# Grid shapes of the throughput benchmark that the flat path serves, plus
# (256, 4096), which records the flat kernel above n = 1024 for routing.
MAIN_SHAPES = [(1024, 32), (8192, 32), (1024, 1024), (256, 4096)]
HEADLINE_SHAPE = (1024, 1024)
PARITY_SHAPES = [(1024, 32), (1024, 1024)]
PARITY_TRIPS = 50
# Float outputs: |kernel - plain| <= RTOL * scale, where scale is the
# largest magnitude in the lane's vector (or the scalar itself).  The kernel
# sums in another order than torch.sum, so the floor is a few ulps of a
# length-n reduction amplified by the two-loop recursion.
RTOL = {"float64": 1e-9, "float32": 1e-5}
# float32 lanes allowed to disagree at one trip (a comparison that flips on
# a last-bit difference of a dot product): at most 0.1%.
F32_MISMATCH_SHARE = 1e-3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS_PER_S = {"float32": 67e12}  # H100 SXM, outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run.",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    import cppnumericalsolvers_tpu_torch as cns
    from cppnumericalsolvers_tpu_torch.ops import _build
    from cppnumericalsolvers_tpu_torch.ops import flat_solve as fs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    record = {}

    # 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_flat_trip()
    record["build_s"] = time.perf_counter() - t0
    log(f"[build] flat_trip.cu: {record['build_s']:.2f} s")

    # 2. card ---------------------------------------------------------------
    card = card_line()
    log(f"[card] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    obj = cns.models.pairwise_rosenbrock()

    def start(b, n, dtype):
        rng = np.random.default_rng(SEED)
        x0 = rng.uniform(-2.0, 2.0, (b, n))
        return torch.from_numpy(x0).to(device=dev, dtype=dtype)

    # 3. parity, trip by trip -------------------------------------------------
    max_abs_err = 0.0
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[1]
        for b, n in PARITY_SHAPES:
            r = parity(fs, obj, start(b, n, dtype), cns, dname)
            max_abs_err = max(max_abs_err, r["max_abs_err"])
            record[f"parity_{dname}_{b}x{n}"] = r
            log(f"[parity] {dname} ({b}, {n}): {r['trips']} trips, "
                f"{r['mismatched_lane_trips']} mismatched lane-trips of "
                f"{r['lane_trips']}, max abs err {r['max_abs_err']:.3e}, "
                f"max scaled err {r['max_scaled_err']:.3e} "
                f"(worst field {r['worst_field']})")
            if dname == "float64" and r["mismatched_lane_trips"]:
                raise AssertionError(f"float64 parity failed: {r}")
            share = r["mismatched_lane_trips"] / r["lane_trips"]
            if share > F32_MISMATCH_SHARE:
                raise AssertionError(f"float32 parity failed: {r}")
            if r["launches"] < r["trips"]:
                raise AssertionError("flat_trip kernel did not launch")

    # 4. main path ------------------------------------------------------------
    solver = cns.Lbfgs(m=M, max_linesearch_fev=MAX_FEV)
    stop32 = cns.default_stopping(torch.float32)
    main_launches = 0
    shapes = []
    for b, n in MAIN_SHAPES:
        x0 = start(b, n, torch.float32)
        torch.cuda.synchronize()
        fs.flat_trip.launches = 0
        t0 = time.perf_counter()
        res = cns.minimize_batched(obj, x0, solver, stop32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fs.flat_trip.launches
        main_launches += launches
        if launches == 0 or launches != res.trips:
            raise AssertionError(
                f"({b}, {n}): {launches} kernel launches for {res.trips} "
                "trips")
        check_result(res, b, n, M)
        plain = fs.flat_lbfgs_solve(
            obj, obj.evaluate(x0), stop32, m=M, max_fev=MAX_FEV,
            trip=fs.flat_trip_reference,
        )
        agree = float(
            (res.progress.status == plain.progress.status)
            .float().mean())
        dnfev = abs(float(res.state.nfev.float().mean())
                    - float(plain.state.nfev.float().mean()))
        its = res.progress.num_iterations
        row = {
            "shape": [b, n], "dtype": "float32", "trips": res.trips,
            "launches": launches, "plain_trips": plain.trips,
            "status_agreement": agree, "mean_nfev_diff": dnfev,
            "batched_iterations": int(its.max()),
            "mean_iterations": float(its.float().mean()),
            "mean_nfev": float(res.state.nfev.float().mean()),
            "converged_share": converged_share(res, cns),
            "main_wall_s": wall,
            "lane_iterations_per_s": float(its.sum()) / wall,
        }
        log(f"[main] ({b}, {n}) float32: {res.trips} trips, {launches} "
            f"launches, {row['batched_iterations']} batched iterations, "
            f"status agreement {agree:.4f}, mean nfev diff {dnfev:.3f}, "
            f"converged {row['converged_share']:.4f}, wall {wall:.3f} s")
        if agree < 0.99 or dnfev >= 3.0:
            raise AssertionError(f"({b}, {n}) disagrees with plain: {row}")
        shapes.append(row)
        del res, plain

    x0 = start(256, 64, torch.float64)
    fs.flat_trip.launches = 0
    res = cns.minimize_batched(obj, x0, solver)
    main_launches += fs.flat_trip.launches
    check_result(res, 256, 64, M)
    plain = fs.flat_lbfgs_solve(
        obj, obj.evaluate(x0), cns.default_stopping(torch.float64), m=M,
        max_fev=MAX_FEV, trip=fs.flat_trip_reference,
    )
    same = bool((res.progress.status == plain.progress.status).all())
    log(f"[main] (256, 64) float64: {res.trips} trips, statuses equal on "
        f"every lane: {same}")
    if not same or fs.flat_trip.launches == 0:
        raise AssertionError("float64 main-path solve disagrees with plain")

    fs.flat_trip.launches = 0
    one = cns.minimize(cns.models.rosenbrock(),
                       torch.tensor([-1.2, 1.0], dtype=torch.float64), solver)
    main_launches += fs.flat_trip.launches
    err = float((one.state.x.cpu() - 1.0).abs().max())
    log(f"[main] minimize 2-D Rosenbrock: status "
        f"{int(one.progress.status)}, |x - 1| = {err:.2e}")
    if err > 1e-4 or fs.flat_trip.launches == 0:
        raise AssertionError("minimize did not reach the 2-D optimum")

    # 5. timing ---------------------------------------------------------------
    for row in shapes:
        b, n = row["shape"]
        row.update(timing(fs, obj, start(b, n, torch.float32), stop32))
        log(f"[time] ({b}, {n}) float32: kernel {row['ms']:.4f} ms/trip, "
            f"plain {row['plain_ms']:.4f} ms/trip, bound "
            f"{row['bound_ms']:.4f} ms/trip ({row['bound_by']}), solve "
            f"{row['solve_s']:.3f} s kernel vs {row['plain_solve_s']:.3f} s "
            f"plain, {row['lane_iterations_per_s_timed']:.4g} "
            f"lane-iterations/s; per trip: evaluation {row['eval_ms']:.4f} "
            f"ms on the card, host clock {row['wall_ms_per_trip']:.4f} ms; "
            f"starved timed calls {row['starved_calls']} of "
            f"{row['padded_calls']}")
        log("[shape] " + json.dumps(row))
    record["shapes"] = shapes

    # 6. report ---------------------------------------------------------------
    head = next(r for r in shapes if tuple(r["shape"]) == HEADLINE_SHAPE)
    kernels = {"kernels": [{
        "name": "flat_trip",
        "route": "cuda",
        "source": "cppnumericalsolvers_tpu_torch/ops/csrc/flat_trip.cu",
        "replaces": "cppnumericalsolvers_tpu/ops/flat_solve.py:109",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": list(HEADLINE_SHAPE),
        "dtype": "float32",
    }]}
    record["kernels"] = kernels
    record["card"] = card
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(json.dumps(kernels))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def converged_share(res, cns) -> float:
    import torch

    conv = torch.tensor(cns.CONVERGED_STATUSES, device=res.progress.status.device)
    return float(torch.isin(res.progress.status, conv).float().mean())


def check_result(res, b, n, m) -> None:
    """Finite values of the expected shapes; every lane has stopped."""
    st, pr, it = res.state, res.progress, res.internals
    shapes = {
        "x": (st.x, (b, n)), "value": (st.value, (b,)),
        "gradient": (st.gradient, (b, n)), "status": (pr.status, (b,)),
        "s_memory": (it.s_memory, (b, m, n)),
        "y_memory": (it.y_memory, (b, m, n)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise AssertionError(f"{name}: shape {tuple(t.shape)} != {shape}")
    for name in ("x", "value", "gradient"):
        if not bool(shapes[name][0].isfinite().all()):
            raise AssertionError(f"{name} is not finite")
    if bool((pr.status == 0).any()):
        raise AssertionError("a lane is still CONTINUE after the solve")


def parity(fs, obj, x0, cns, dname) -> dict:
    """Feed the identical state to the kernel and the plain version at every
    trip of a plain-version solve and compare every output."""
    import torch

    stop = cns.default_stopping(x0.dtype)
    st, x_trial = fs.init_flat_state(obj.evaluate(x0), M, MAX_FEV)
    rtol = RTOL[dname]
    launches0 = fs.flat_trip.launches
    trips = bad = 0
    max_abs = max_scaled = 0.0
    worst = ""
    b = x0.shape[0]
    for _ in range(PARITY_TRIPS):
        if not bool((st.si[:, fs._I_STATUS] == 0).any()):
            break
        f_t, g_t = obj.batched_value_and_grad(x_trial)
        k_st, k_xt = st.clone(), x_trial.clone()
        fs.flat_trip(k_st, f_t, g_t, k_xt, stop, MAX_FEV)
        fs.flat_trip_reference(st, f_t, g_t, x_trial, stop, MAX_FEV)
        torch.cuda.synchronize()
        lane_bad = (k_st.si != st.si).any(1)
        pairs = {"x_trial": (k_xt, x_trial, True)}
        for name in ("x0", "g0", "sdir", "gacc", "s", "y"):
            pairs[name] = (getattr(k_st, name), getattr(st, name), True)
        pairs["sf"] = (k_st.sf, st.sf, False)
        pairs["ring"] = (k_st.ring, st.ring, False)
        errs = {}
        for name, (k, p, vector) in pairs.items():
            k, p = k.reshape(b, -1), p.reshape(b, -1)
            same_nonfinite = (
                (k.isnan() == p.isnan()).all(1)
                & ((k.isinf() & (k == p)) == p.isinf()).all(1))
            fin = p.isfinite() & k.isfinite()
            diff = torch.where(fin, (k - p).abs(), torch.zeros_like(p))
            mag = torch.where(fin, p.abs(), torch.zeros_like(p))
            scale = mag.amax(1, keepdim=True) if vector else mag
            scaled = diff / scale.clamp_min(torch.finfo(p.dtype).tiny)
            scaled = torch.where(diff == 0, torch.zeros_like(diff), scaled)
            lane_bad |= ~same_nonfinite | (scaled > rtol).any(1)
            errs[name] = (diff, scaled)
        good = ~lane_bad
        for name, (diff, scaled) in errs.items():
            if bool(good.any()):
                a = float(diff[good].max())
                s = float(scaled[good].max())
                max_abs = max(max_abs, a)
                if s > max_scaled:
                    max_scaled, worst = s, name
        bad += int(lane_bad.sum())
        trips += 1
    return {
        "trips": trips, "lane_trips": trips * b, "mismatched_lane_trips": bad,
        "max_abs_err": max_abs, "max_scaled_err": max_scaled,
        "worst_field": worst, "rtol": rtol,
        "launches": fs.flat_trip.launches - launches0,
    }


def timing(fs, obj, x0, stop) -> dict:
    """Per-trip time of the kernel and of the plain version, each solve run
    in the order plain, kernel, kernel, plain, and the least time each
    trip's data needs on this card.

    Two kinds of solve.  Host-clock solves time whole trips as a user sees
    them.  Device solves give the card's own time: before each evaluation
    and each trip a spin kernel (``torch.cuda._sleep``) keeps the card busy
    while the host enqueues the work, so the CUDA events around it measure
    the work and not the host's launch gaps.  A call whose start event had
    already passed when its work was enqueued is counted as starved; the
    device figures hold only where that count is 0."""
    import torch

    class Timed:
        """Records CUDA events around each call of ``fn``."""

        def __init__(self, fn, pad_cycles):
            self.fn, self.pad, self.events, self.starved = fn, pad_cycles, [], 0

        def __call__(self, *args):
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            if self.pad:
                torch.cuda._sleep(self.pad)
            a.record()
            out = self.fn(*args)
            if self.pad and a.query():
                self.starved += 1
            z.record()
            self.events.append((a, z))
            return out

        def mean_ms(self):
            return sum(a.elapsed_time(z) for a, z in self.events) / len(
                self.events)

    class TimedObjective:
        def __init__(self, pad_cycles):
            self.batched_value_and_grad = Timed(obj.batched_value_and_grad,
                                                pad_cycles)

    def solve(trip, device_time):
        state0 = obj.evaluate(x0)
        # About 10 ms and 50 ms of spin at the H100's clock: several times
        # what the host takes to enqueue an evaluation or a kernel trip
        # (about 2 ms) and a plain trip (about 13 ms).
        plain = trip is fs.flat_trip_reference
        pad = (100_000_000 if plain else 20_000_000) if device_time else 0
        trip, tobj = Timed(trip, pad), TimedObjective(pad and 20_000_000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fs.flat_lbfgs_solve(tobj, state0, stop, m=M, max_fev=MAX_FEV,
                                  trip=trip)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ev = tobj.batched_value_and_grad
        return {
            "trip_ms": trip.mean_ms(), "eval_ms": ev.mean_ms(), "wall": wall,
            "wall_ms_per_trip": wall / res.trips * 1e3,
            "lane_iterations": float(res.progress.num_iterations.sum()),
            "starved": trip.starved + ev.starved,
            "calls": len(trip.events) + len(ev.events),
        }

    runs = {}
    for device_time in (False, True):
        for which in ("plain", "kernel", "kernel", "plain"):
            trip = fs.flat_trip if which == "kernel" else fs.flat_trip_reference
            runs.setdefault((which, device_time), []).append(
                solve(trip, device_time))
    work = trip_work(fs, obj, x0, stop)

    def mean(which, device_time, key):
        rs = runs[(which, device_time)]
        return sum(r[key] for r in rs) / len(rs)

    padded = [r for k, rs in runs.items() if k[1] for r in rs]
    return {
        "starved_calls": sum(r["starved"] for r in padded),
        "padded_calls": sum(r["calls"] for r in padded),
        # Device time per trip (spin-padded solves).
        "ms": mean("kernel", True, "trip_ms"),
        "plain_ms": mean("plain", True, "trip_ms"),
        "kernel_ms_runs": [r["trip_ms"] for r in runs[("kernel", True)]],
        "plain_ms_runs": [r["trip_ms"] for r in runs[("plain", True)]],
        "eval_ms": mean("kernel", True, "eval_ms"),
        # Host clock (unpadded solves): whole trips and whole solves.
        "wall_ms_per_trip": mean("kernel", False, "wall_ms_per_trip"),
        "plain_wall_ms_per_trip": mean("plain", False, "wall_ms_per_trip"),
        "kernel_span_ms": mean("kernel", False, "trip_ms"),
        "eval_span_ms": mean("kernel", False, "eval_ms"),
        "solve_s": mean("kernel", False, "wall"),
        "plain_solve_s": mean("plain", False, "wall"),
        "lane_iterations_per_s_timed": (
            mean("kernel", False, "lane_iterations")
            / mean("kernel", False, "wall")),
        **work,
    }


def trip_work(fs, obj, x0, stop) -> dict:
    """Bytes and operations one kernel solve's trips need, lane by lane:
    each input read once and each output written once.

    A dead lane reads x0 and writes the trial point.  A lane mid-search
    reads g_t, sdir, x0 and writes gacc and the trial point.  A lane at the
    iteration boundary reads x0, g0, sdir and its accepted gradient, reads
    the history rows its two-loop uses, writes x0, g0, sdir, gacc, the
    trial point, and the history rows that changed (one row, or all m when a
    full history shifts).  Scalar rows count for every live lane."""
    import torch

    state0 = obj.evaluate(x0)
    b, n = x0.shape
    w = x0.element_size()
    tot = {"bytes": 0.0, "ops": 0.0, "trips": 0}
    lanes = torch.arange(b, device=x0.device)

    def counting(st, f_t, g_t, x_trial, stopping, max_fev):
        si0 = st.si.clone()
        c0 = si0[:, fs._I_COUNT].long()
        slot = c0.clamp(max=M - 1)
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
        hist_write = torch.where(acc, torch.where(c0 >= M, 2 * M * n, 2 * n),
                                 0)
        scal = (2 * (fs._NF + 8) + 1) * w + 2 * fs._NI * 4
        elems = torch.where(dead, 2 * n, torch.where(
            mid, 5 * n, 9 * n + hist_read + hist_write))
        byts = elems * w + torch.where(dead, fs._NI * 4, scal)
        ops = torch.where(dead, 0, torch.where(
            mid, 4 * n, 24 * n + 10 * n * c1))
        tot["bytes"] += float(byts.sum())
        tot["ops"] += float(ops.sum())
        tot["trips"] += 1

    fs.flat_lbfgs_solve(obj, state0, stop, m=M, max_fev=MAX_FEV,
                        trip=counting)
    dname = str(x0.dtype).split(".")[1]
    bytes_ms = tot["bytes"] / tot["trips"] / HBM_BYTES_PER_S * 1e3
    ops_ms = tot["ops"] / tot["trips"] / PEAK_OPS_PER_S[dname] * 1e3
    return {
        "bytes_per_trip": tot["bytes"] / tot["trips"],
        "ops_per_trip": tot["ops"] / tot["trips"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


if __name__ == "__main__":
    sys.exit(main())
