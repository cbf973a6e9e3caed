#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Two paths through ``minimize_batched(objective, x0_batch, Lbfgs(m=10))``:

* the flat solve (a fresh solve without a trace), whose loop trip is one
  batched objective evaluation plus one ``flat_trip`` kernel launch;
* the iteration-granular loop (``trace=``, ``internals=``, ``resume``), whose
  iteration is one ``lbfgs_prologue`` launch, one ``mt_trip`` launch per
  evaluation of the batched line search, and one ``lbfgs_epilogue`` launch.

Phases (each raises on failure, so the script then exits non-zero):

1. build   compile the four sources of ``ops/csrc/`` with nvcc for sm_90a,
           all at once, and load them;
2. card    print the card's name and power limit (nvidia-smi);
3. parity  flat: ~50 trips of a plain-version solve; at every trip the
           identical state goes through the kernel and through the plain
           version, and every output is compared (float64 and float32).
           Nested: the same for every call of the three kernels during a
           plain-version solve run to its end, at every shape the nested
           path runs at, so that done lanes, full-history pushes and the
           statuses that end a lane are compared too;
4. main    flat: ``minimize_batched`` in float32 on the pairwise extended
           Rosenbrock at the throughput-grid shapes, launch counts set to 0
           just before and read just after; the result is held against the
           same solve through the plain version on the card; one float64
           solve must agree lane for lane; ``minimize`` on the 2-D
           Rosenbrock must reach (1, 1).
           Nested: a traced solve cut by ``max_iterations``, ``resume`` to
           the end and a warm start with ``internals=`` and ``trace=``, with
           launch counts that must match the iteration and trip counts; the
           result is held against the same solves through the plain versions
           on the card and against the flat path;
5. timing  CUDA events around every kernel call and evaluation, plain,
           kernel, kernel, plain, on the host clock and on the card's own
           time, a count of the bytes and operations each call's data
           needs, and whole flat and nested solves side by side;
6. report  one JSON line per shape, the ``kernels`` line, the card line and,
           last, the device line.  ``chiprun_out/chip_smoke.json`` keeps the
           full record.

With no GPU it prints no result and exits 1; nothing runs on the CPU.
"""

from __future__ import annotations

import contextlib
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
# The iteration-granular path: full width in float32.  Its kernels are held
# against their plain versions at these shapes and at (1024, 32).
NESTED_SHAPES = [(1024, 1024), (256, 4096)]
NESTED_PARITY_SHAPES = [(1024, 32)] + NESTED_SHAPES
# One more nested parity solve, for the rungs the default solve does not
# reach: lanes that start at the optimum (zero step: stall reset, x_delta),
# lanes far out (overflow in the search: the non-finite guard), a counted
# relative f_delta test in place of the plateau ring, a loose gradient-norm
# test, and an iteration limit.
EDGE_SHAPE = (1024, 32)
EDGE_LANES = 16
EDGE_STOPPING = dict(past=0, f_delta=1e-3, f_delta_violations=2,
                     f_delta_relative=True, gradient_norm=1.0,
                     max_iterations=40)
NESTED_CUT = 10                 # max_iterations of the cut solve
NESTED_TRACE = 16               # trace capacity on the main path
NESTED_TIMED_ITERATIONS = 40    # depth of the spin-padded nested solves
REPLACES = {
    "flat_trip": "cppnumericalsolvers_tpu/ops/flat_solve.py:109",
    "mt_trip": "cppnumericalsolvers_tpu/ops/fused_linesearch.py:255",
    "lbfgs_prologue": "cppnumericalsolvers_tpu/ops/fused_step.py:118",
    "lbfgs_epilogue": "cppnumericalsolvers_tpu/ops/fused_step.py:358",
}
# Float outputs: |kernel - plain| <= RTOL * scale, where scale is the
# largest magnitude in the lane's vector (or the scalar itself).  The kernel
# sums in another order than torch.sum, so the floor is a few ulps of a
# length-n reduction amplified by the two-loop recursion.
RTOL = {"float64": 1e-9, "float32": 1e-5}
# The prologue's search direction is the end of the two-loop's 2m dependent length-n
# reductions, each a difference of like-sized terms.  Late in a float32
# solve the kernel and the plain version end up to 2e-5 (n = 1024) and
# 5e-5 (n = 4096) of the direction's largest entry apart, with every integer
# output and the whole history bit-equal; 50 trips into a solve (the flat
# phase) it is 1.3e-6.
DIRECTION_RTOL = {"float64": 1e-9, "float32": 1e-4}
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


class Mods:
    """The port's modules, imported once the GPU is known to be there."""

    def __init__(self):
        import cppnumericalsolvers_tpu_torch as cns
        from cppnumericalsolvers_tpu_torch.ops import _build
        from cppnumericalsolvers_tpu_torch.ops import flat_solve as fs
        from cppnumericalsolvers_tpu_torch.ops import fused_linesearch as fl
        from cppnumericalsolvers_tpu_torch.ops import fused_step as fstep
        from cppnumericalsolvers_tpu_torch.solvers import lbfgs as lb

        self.cns, self.build, self.fs, self.fl = cns, _build, fs, fl
        self.fstep, self.lb = fstep, lb
        #: The nested path's kernel wrappers (each counts its launches) and
        #: their plain versions.
        self.kernels = {
            "lbfgs_prologue": fstep.lbfgs_prologue,
            "mt_trip": fl.mt_trip,
            "lbfgs_epilogue": fstep.lbfgs_epilogue,
        }
        self.plain = {
            "lbfgs_prologue": fstep.lbfgs_prologue_reference,
            "mt_trip": fl.mt_trip_reference,
            "lbfgs_epilogue": fstep.lbfgs_epilogue_reference,
        }

    @contextlib.contextmanager
    def swapped(self, fns: dict):
        """Run the nested path through ``fns`` (by kernel name) in place of
        the kernel wrappers: the plain versions, or wrappers that compare,
        time or count.  The names set are those the solver and the search
        look up at each call; the launch counts stay on the wrappers."""
        try:
            self._set(fns)
            yield
        finally:
            self._set(self.kernels)

    def _set(self, fns: dict) -> None:
        self.lb.lbfgs_prologue = fns["lbfgs_prologue"]
        self.lb.lbfgs_epilogue = fns["lbfgs_epilogue"]
        self.fl.mt_trip = fns["mt_trip"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run.",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    mods = Mods()
    cns, fs = mods.cns, mods.fs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    record = {}

    # 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    mods.build.build_all()
    for name in mods.build.KERNELS:
        mods.build.load(name)
    record["build_s"] = time.perf_counter() - t0
    log(f"[build] {', '.join(mods.build.KERNELS)}: "
        f"{record['build_s']:.2f} s")

    # 2. card ---------------------------------------------------------------
    card = card_line()
    log(f"[card] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    obj = cns.models.pairwise_rosenbrock()

    def start(b, n, dtype):
        rng = np.random.default_rng(SEED)
        x0 = rng.uniform(-2.0, 2.0, (b, n))
        return torch.from_numpy(x0).to(device=dev, dtype=dtype)

    # 3. parity, call by call -------------------------------------------------
    max_abs_err = {name: 0.0 for name in REPLACES}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[1]
        for b, n in PARITY_SHAPES:
            r = parity(fs, obj, start(b, n, dtype), cns, dname)
            record[f"parity_{dname}_{b}x{n}"] = r
            check_parity("flat_trip", dname, b, n, r, max_abs_err)
            if r["launches"] < r["calls"]:
                raise AssertionError("flat_trip kernel did not launch")
        for b, n in NESTED_PARITY_SHAPES:
            t0 = time.perf_counter()
            nested, cover = nested_parity(mods, obj, start(b, n, dtype),
                                          dname)
            cover["seconds"] = time.perf_counter() - t0
            record[f"nested_parity_{dname}_{b}x{n}"] = {**nested,
                                                        "cover": cover}
            for name, r in nested.items():
                check_parity(name, dname, b, n, r, max_abs_err)
            log(f"[parity] nested {dname} ({b}, {n}) covered: "
                + json.dumps(cover))
            check_cover(cover, b, n)
        b, n = EDGE_SHAPE
        x0 = start(b, n, dtype)
        x0[:EDGE_LANES] = 1.0
        x0[EDGE_LANES:2 * EDGE_LANES] *= 1e6
        x0[2 * EDGE_LANES:3 * EDGE_LANES] *= 1e9
        nested, cover = nested_parity(
            mods, obj, x0, dname,
            cns.default_stopping(dtype).replace(**EDGE_STOPPING))
        record[f"nested_parity_edge_{dname}"] = {**nested, "cover": cover}
        for name, r in nested.items():
            check_parity(name, dname, b, n, r, max_abs_err)
        log(f"[parity] nested {dname} ({b}, {n}) edge lanes covered: "
            + json.dumps(cover))
        check_cover(cover, b, n, edge=True)

    # 4. main path ------------------------------------------------------------
    solver = cns.Lbfgs(m=M, max_linesearch_fev=MAX_FEV)
    stop32 = cns.default_stopping(torch.float32)
    main_launches = {name: 0 for name in REPLACES}
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
        main_launches["flat_trip"] += launches
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
    main_launches["flat_trip"] += fs.flat_trip.launches
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
    main_launches["flat_trip"] += fs.flat_trip.launches
    err = float((one.state.x.cpu() - 1.0).abs().max())
    log(f"[main] minimize 2-D Rosenbrock: status "
        f"{int(one.progress.status)}, |x - 1| = {err:.2e}")
    if err > 1e-4 or fs.flat_trip.launches == 0:
        raise AssertionError("minimize did not reach the 2-D optimum")

    nested_rows = []
    for b, n in NESTED_SHAPES:
        row = nested_main(mods, obj, start(b, n, torch.float32), solver,
                          stop32)
        for name, count in row["launches"].items():
            main_launches[name] += count
        nested_rows.append(row)

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

    for row in nested_rows:
        b, n = row["shape"]
        x0 = start(b, n, torch.float32)
        row.update(nested_timing(mods, obj, x0, solver, stop32))
        row.update(path_compare(cns, obj, x0, solver, stop32))
        for name, k in row["kernels"].items():
            k["launches_per_solve"] = row[
                "nested_trips" if name == "mt_trip" else "nested_iterations"]
            log(f"[time] nested ({b}, {n}) float32 {name}: kernel "
                f"{k['ms']:.4f} ms/launch, plain {k['plain_ms']:.4f} "
                f"ms/call, bound {k['bound_ms']:.4f} ms ({k['bound_by']}), "
                f"{k['launches_per_solve']} launches in a full solve")
        log(f"[time] nested ({b}, {n}) float32: evaluation "
            f"{row['eval_ms']:.4f} ms on the card; starved timed calls "
            f"{row['starved_calls']} of {row['padded_calls']}; full solve "
            f"on the host clock: nested {row['nested_solve_s']:.3f} s "
            f"({row['nested_iterations']} iterations, {row['nested_trips']} "
            f"evaluations), flat {row['flat_solve_s']:.3f} s "
            f"({row['flat_trips']} evaluations)")
        log("[nested] " + json.dumps(row))
    record["nested"] = nested_rows

    # 6. report ---------------------------------------------------------------
    head = next(r for r in shapes if tuple(r["shape"]) == HEADLINE_SHAPE)
    nhead = next(r for r in nested_rows if tuple(r["shape"]) == HEADLINE_SHAPE)
    timed = {"flat_trip": head, **nhead["kernels"]}
    kernels = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"cppnumericalsolvers_tpu_torch/ops/csrc/{name}.cu",
        "replaces": REPLACES[name],
        "launches": main_launches[name],
        "max_abs_err": max_abs_err[name],
        "ms": timed[name]["ms"],
        "plain_ms": timed[name]["plain_ms"],
        "bound_ms": timed[name]["bound_ms"],
        "bound_by": timed[name]["bound_by"],
        "library_ms": None,
        "shape": list(HEADLINE_SHAPE),
        "dtype": "float32",
    } for name in REPLACES]}
    for k in kernels["kernels"]:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on its path")
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


def check_parity(name, dname, b, n, r, max_abs_err) -> None:
    """Log one kernel's parity figures and raise where they pass the stated
    tolerance: float64 no lane-call may differ, float32 at most 0.1%."""
    max_abs_err[name] = max(max_abs_err[name], r["max_abs_err"])
    log(f"[parity] {name} {dname} ({b}, {n}): {r['calls']} calls, "
        f"{r['mismatched_lane_calls']} mismatched lane-calls of "
        f"{r['lane_calls']}, max abs err {r['max_abs_err']:.3e}, "
        f"max scaled err {r['max_scaled_err']:.3e} "
        f"(worst field {r['worst_field']}), mismatches by field "
        f"{r['mismatched_by_field']}")
    if r["calls"] == 0:
        raise AssertionError(f"{name}: no call was compared")
    if dname == "float64" and r["mismatched_lane_calls"]:
        raise AssertionError(f"{name} float64 parity failed: {r}")
    if r["mismatched_lane_calls"] / r["lane_calls"] > F32_MISMATCH_SHARE:
        raise AssertionError(f"{name} float32 parity failed: {r}")


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


class Compare:
    """Accumulates, over many calls, the comparison of a kernel's outputs
    with its plain version's on the same inputs.  A lane-call is bad when an
    integer output differs, a non-finite value differs, or a float output is
    off by more than ``rtol`` (``rtol_of[name]`` where given) times its
    scale: the largest magnitude of the lane's vector, or the scalar itself.
    The errors reported are the largest over all lanes, bad ones included."""

    def __init__(self, rtol, rtol_of=None):
        self.rtol, self.rtol_of = rtol, rtol_of or {}
        self.calls = self.lane_calls = self.bad = 0
        self.max_abs = self.max_scaled = 0.0
        self.worst = ""
        self.bad_by_field = {}

    def add(self, b, ints, floats) -> None:
        """``ints``: name -> (kernel, plain); ``floats``: name -> (kernel,
        plain, is_vector).  Every tensor has ``b`` leading lanes."""
        import torch

        lane_bad = torch.zeros(b, dtype=torch.bool,
                               device=next(iter(ints.values()))[0].device)

        def mark(name, bad):
            nonlocal lane_bad
            lane_bad = lane_bad | bad
            count = int(bad.sum())
            if count:
                self.bad_by_field[name] = (
                    self.bad_by_field.get(name, 0) + count)

        for name, (k, p) in ints.items():
            mark(name, (k.reshape(b, -1) != p.reshape(b, -1)).any(1))
        for name, (k, p, vector) in floats.items():
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
            rtol = self.rtol_of.get(name, self.rtol)
            mark(name, ~same_nonfinite | (scaled > rtol).any(1))
            self.max_abs = max(self.max_abs, float(diff.max()))
            sc = float(scaled.max())
            if sc > self.max_scaled:
                self.max_scaled, self.worst = sc, name
        self.bad += int(lane_bad.sum())
        self.calls += 1
        self.lane_calls += b

    def result(self, launches) -> dict:
        return {
            "calls": self.calls, "lane_calls": self.lane_calls,
            "mismatched_lane_calls": self.bad,
            "mismatched_by_field": self.bad_by_field,
            "max_abs_err": self.max_abs,
            "max_scaled_err": self.max_scaled, "worst_field": self.worst,
            "rtol": self.rtol, "launches": launches,
        }


def parity(fs, obj, x0, cns, dname) -> dict:
    """Feed the identical state to the kernel and the plain version at every
    trip of a plain-version flat solve and compare every output."""
    import torch

    stop = cns.default_stopping(x0.dtype)
    st, x_trial = fs.init_flat_state(obj.evaluate(x0), M, MAX_FEV)
    cmp = Compare(RTOL[dname])
    launches0 = fs.flat_trip.launches
    b = x0.shape[0]
    for _ in range(PARITY_TRIPS):
        if not bool((st.si[:, fs._I_STATUS] == 0).any()):
            break
        f_t, g_t = obj.batched_value_and_grad(x_trial)
        k_st, k_xt = st.clone(), x_trial.clone()
        fs.flat_trip(k_st, f_t, g_t, k_xt, stop, MAX_FEV)
        fs.flat_trip_reference(st, f_t, g_t, x_trial, stop, MAX_FEV)
        torch.cuda.synchronize()
        floats = {"x_trial": (k_xt, x_trial, True)}
        for name in ("x0", "g0", "sdir", "gacc", "s", "y"):
            floats[name] = (getattr(k_st, name), getattr(st, name), True)
        floats["sf"] = (k_st.sf, st.sf, False)
        floats["ring"] = (k_st.ring, st.ring, False)
        cmp.add(b, {"si": (k_st.si, st.si)}, floats)
    return cmp.result(fs.flat_trip.launches - launches0)


def _clone_record(rec):
    return type(rec)(**{k: v.clone() for k, v in vars(rec).items()})


def nested_parity(mods, obj, x0, dname, stop=None):
    """During a plain-version solve of the iteration-granular path, run to
    its end under ``stop`` (the default criteria if None), every call's inputs go through the kernel and through the plain
    version, and every output is compared.  Returns the figures of each of
    the three kernels, and what the compared calls covered: lane-calls on
    done lanes (each kernel's early return), pushes into a full history,
    history resets, non-finite search results, and the statuses on which
    lanes left CONTINUE."""
    import torch

    cns, fl, fstep = mods.cns, mods.fl, mods.fstep
    b = x0.shape[0]
    cmps = {name: Compare(RTOL[dname], {"ls_dir": DIRECTION_RTOL[dname]})
            for name in mods.kernels}
    launches0 = {name: fn.launches for name, fn in mods.kernels.items()}
    cover = {"prologue_done_lane_calls": 0, "full_history_pushes": 0,
             "prologue_history_resets": 0, "mt_trip_idle_lane_calls": 0,
             "epilogue_done_lane_calls": 0, "epilogue_stall_resets": 0,
             "epilogue_nonfinite_lane_calls": 0,
             "ended_on_status": {}}

    def prologue(x, g, s_mem, y_mem, count, gamma, s_new, y_new, valid, done):
        k = [t.clone() for t in (s_mem, y_mem, count, gamma)]
        count0, newest0 = count.clone(), s_mem[:, -1].clone()
        kd, ka, kg, *_ = mods.kernels["lbfgs_prologue"](
            x, g, *k, s_new, y_new, valid, done)
        out = fstep.lbfgs_prologue_reference(
            x, g, s_mem, y_mem, count, gamma, s_new, y_new, valid, done)
        torch.cuda.synchronize()
        cmps["lbfgs_prologue"].add(b, {"mem_count": (k[2], count)}, {
            "ls_dir": (kd, out[0], True), "alpha_init": (ka, out[1], False),
            "dginit": (kg, out[2], False), "s_memory": (k[0], s_mem, True),
            "y_memory": (k[1], y_mem, True), "gamma": (k[3], gamma, False),
        })
        cover["prologue_done_lane_calls"] += int(done.sum())
        cover["full_history_pushes"] += int(
            ((count0 >= M) & (s_mem[:, -1] != newest0).any(1)).sum())
        cover["prologue_history_resets"] += int((count < count0).sum())
        return out

    def trip(x0_, sdir, f_t, g_t, st, max_fev):
        k = st.clone()
        cover["mt_trip_idle_lane_calls"] += int(
            (st.si[:, fl._I_INFO] != 0).sum())
        mods.kernels["mt_trip"](x0_, sdir, f_t, g_t, k, max_fev)
        fl.mt_trip_reference(x0_, sdir, f_t, g_t, st, max_fev)
        torch.cuda.synchronize()
        cmps["mt_trip"].add(b, {"si": (k.si, st.si)}, {
            "x_trial": (k.x_trial, st.x_trial, True),
            "gacc": (k.gacc, st.gacc, True), "sf": (k.sf, st.sf, False),
        })

    def epilogue(state, x_ls, f_ls, g_ls, ls_nfev, count, s_pend, y_pend,
                 pvalid, done, progress, crit):
        ks, kp = _clone_record(state), _clone_record(progress)
        kc, ksp, kyp, kpv = (t.clone() for t in (count, s_pend, y_pend,
                                                 pvalid))
        count0 = count.clone()
        mods.kernels["lbfgs_epilogue"](
            ks, x_ls, f_ls, g_ls, ls_nfev, kc, ksp, kyp, kpv, done, kp, crit)
        out = fstep.lbfgs_epilogue_reference(
            state, x_ls, f_ls, g_ls, ls_nfev, count, s_pend, y_pend, pvalid,
            done, progress, crit)
        torch.cuda.synchronize()
        ints = {"nfev": (ks.nfev, state.nfev), "mem_count": (kc, count),
                "pending_valid": (kpv, pvalid)}
        for name in ("num_iterations", "x_delta_violations",
                     "f_delta_violations", "status", "past_pos"):
            ints[name] = (getattr(kp, name), getattr(progress, name))
        floats = {
            "x": (ks.x, state.x, True),
            "gradient": (ks.gradient, state.gradient, True),
            "s_pending": (ksp, s_pend, True),
            "y_pending": (kyp, y_pend, True),
            "value": (ks.value, state.value, False),
        }
        for name in ("x_delta", "f_delta", "gradient_norm", "past_ring",
                     "condition_hessian"):
            floats[name] = (getattr(kp, name), getattr(progress, name), False)
        cmps["lbfgs_epilogue"].add(b, ints, floats)
        cover["epilogue_done_lane_calls"] += int(done.sum())
        cover["epilogue_stall_resets"] += int((count < count0).sum())
        cover["epilogue_nonfinite_lane_calls"] += int(
            (~f_ls.isfinite() & ~done).sum())
        # ``done`` is the status on entry; a live lane whose status is set
        # now left CONTINUE in this call.
        ended = progress.status[~done & (progress.status != 0)]
        for code, lanes in zip(*(t.tolist() for t in
                                 ended.unique(return_counts=True))):
            name = cns.Status(code).name
            cover["ended_on_status"][name] = (
                cover["ended_on_status"].get(name, 0) + lanes)
        return out

    with mods.swapped({"lbfgs_prologue": prologue, "mt_trip": trip,
                       "lbfgs_epilogue": epilogue}):
        res = cns.minimize_batched(
            obj, x0, cns.Lbfgs(m=M, max_linesearch_fev=MAX_FEV),
            stop or cns.default_stopping(x0.dtype), trace=1)
    cover["iterations"] = int(res.progress.num_iterations.max())
    cover["trips"] = res.trips
    return {name: cmps[name].result(fn.launches - launches0[name])
            for name, fn in mods.kernels.items()}, cover


def check_cover(cover, b, n, edge=False) -> None:
    """The compared calls must have reached each kernel's done-lane return,
    pushes into a full history, and every lane's end on a status; the edge
    solve also stall resets and at least three different statuses."""
    if edge and (cover["epilogue_stall_resets"] <= 0
                 or len(cover["ended_on_status"]) < 3):
        raise AssertionError(f"nested parity, edge lanes: {cover}")
    for key in ("prologue_done_lane_calls", "mt_trip_idle_lane_calls",
                "epilogue_done_lane_calls", "full_history_pushes"):
        if cover[key] <= 0:
            raise AssertionError(f"nested parity ({b}, {n}): no {key}")
    if sum(cover["ended_on_status"].values()) != b:
        raise AssertionError(
            f"nested parity ({b}, {n}): not every lane ended inside the "
            f"compared calls: {cover['ended_on_status']}")


def nested_main(mods, obj, x0, solver, stop) -> dict:
    """The iteration-granular path through its entry points: a traced solve
    cut by ``max_iterations``, ``resume`` to the end, and a warm start with
    ``internals=`` and ``trace=``.  The launch counts must match the
    iteration and trip counts; the resumed solve must equal the
    uninterrupted one bit for bit on at least 99% of lanes; statuses are
    held against the same solves through
    the plain versions on the card, and against the flat path."""
    import torch

    cns = mods.cns
    b, n = x0.shape
    cut_stop = stop.replace(max_iterations=NESTED_CUT)

    def run():
        cut = cns.minimize_batched(obj, x0, solver, cut_stop,
                                   trace=NESTED_TRACE)
        return cut, cns.resume(obj, cut, solver, stop, trace=NESTED_TRACE)

    torch.cuda.synchronize()
    for fn in mods.kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    cut, res = run()
    warm = cns.minimize_batched(obj, x0, solver, stop,
                                internals=res.internals, trace=NESTED_TRACE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in mods.kernels.items()}

    iterations = (
        int(cut.progress.num_iterations.max())
        + int((res.progress.num_iterations
               - cut.progress.num_iterations).max())
        + int(warm.progress.num_iterations.max()))
    trips = cut.trips + res.trips + warm.trips
    want = {"lbfgs_prologue": iterations, "mt_trip": trips,
            "lbfgs_epilogue": iterations}
    if launches != want or min(launches.values()) <= 0:
        raise AssertionError(
            f"nested ({b}, {n}): launches {launches}, expected {want}")
    if not bool((cut.progress.status
                 == int(cns.Status.ITERATION_LIMIT)).any()):
        raise AssertionError("the cut solve did not stop on its limit")
    for r in (res, warm):
        check_result(r, b, n, M)
    tr = warm.trace
    if tuple(tr.value.shape) != (b, NESTED_TRACE) or not bool(
            tr.value[:, 0].isfinite().all()) or bool((tr.status[:, 0] < 0)
                                                     .any()):
        raise AssertionError(f"trace buffer is wrong: {tr.value.shape}")

    # The cut solve's trace holds its iterations, the resumed one's the
    # rest: together they are the uninterrupted solve's.  A lane may part
    # from the uninterrupted run only through the plateau ring, which lacks
    # the value of the iteration the limit fired on.
    full = cns.minimize_batched(obj, x0, solver, stop, trace=NESTED_TRACE)
    traced = cut.trace.value.where(cut.trace.status >= 0, res.trace.value)
    same_lane = ((full.state.x == res.state.x).all(1)
                 & (full.state.nfev == res.state.nfev)
                 & (full.progress.status == res.progress.status)
                 & ((full.trace.value == traced)
                    | (full.trace.value.isnan() & traced.isnan())).all(1))
    resumed_equal = float(same_lane.float().mean())
    with mods.swapped(mods.plain):
        _, plain = run()
    flat = cns.minimize_batched(obj, x0, solver, stop)

    def against(other):
        agree = float((res.progress.status == other.progress.status)
                      .float().mean())
        dnfev = abs(float(res.state.nfev.float().mean())
                    - float(other.state.nfev.float().mean()))
        return agree, dnfev

    agree, dnfev = against(plain)
    flat_agree, flat_dnfev = against(flat)
    row = {
        "shape": [b, n], "dtype": "float32", "launches": launches,
        "iterations": iterations, "trips": trips,
        "cut_iterations": int(cut.progress.num_iterations.max()),
        "resumed_equals_uninterrupted": resumed_equal,
        "status_agreement": agree, "mean_nfev_diff": dnfev,
        "flat_status_agreement": flat_agree,
        "flat_mean_nfev_diff": flat_dnfev,
        "mean_nfev": float(res.state.nfev.float().mean()),
        "converged_share": converged_share(res, cns),
        "warm_iterations": int(warm.progress.num_iterations.max()),
        "main_wall_s": wall,
    }
    log(f"[main] nested ({b}, {n}) float32: cut at "
        f"{row['cut_iterations']} iterations, resumed and warm-started: "
        f"{iterations} iterations, {trips} search trips, launches "
        f"{launches}; resumed equals uninterrupted on "
        f"{resumed_equal:.4f} of lanes; "
        f"against the plain versions: status agreement {agree:.4f}, mean "
        f"nfev diff {dnfev:.3f}; against the flat path: status agreement "
        f"{flat_agree:.4f}, mean nfev diff {flat_dnfev:.3f}; converged "
        f"{row['converged_share']:.4f}, wall {wall:.3f} s")
    if resumed_equal < 0.99:
        raise AssertionError(f"nested ({b}, {n}): resume changed the solve")
    if agree < 0.99 or dnfev >= 3.0:
        raise AssertionError(f"nested ({b}, {n}) disagrees with plain: {row}")
    return row


class Timed:
    """Records CUDA events around each call of ``fn``.  With ``pad_cycles``
    a spin kernel (``torch.cuda._sleep``) goes before each call and keeps
    the card busy while the host enqueues the work, so the events measure
    the work and not the host's launch gaps; a call whose start event had
    already passed when its work was enqueued is counted as starved."""

    def __init__(self, fn, pad_cycles):
        self.fn, self.pad, self.events, self.starved = fn, pad_cycles, [], 0

    def __call__(self, *args):
        import torch

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
    """``obj`` with its batched evaluation timed."""

    def __init__(self, obj, pad_cycles):
        self.mode, self.evaluate = obj.mode, obj.evaluate
        self.batched_value_and_grad = Timed(obj.batched_value_and_grad,
                                            pad_cycles)


# About 10 ms and 50 ms of spin at the H100's clock: several times what the
# host takes to enqueue an evaluation or a kernel call (about 2 ms) and a
# plain call (about 13 ms).
KERNEL_PAD, PLAIN_PAD = 20_000_000, 100_000_000


def nested_timing(mods, obj, x0, solver, stop) -> dict:
    """Device time per call of the three nested-path kernels and of their
    plain versions (spin-padded solves cut at NESTED_TIMED_ITERATIONS, in
    the order plain, kernel, kernel, plain), and the least time each call's
    data needs on this card."""
    import torch

    cns = mods.cns
    cut = stop.replace(max_iterations=NESTED_TIMED_ITERATIONS)

    def solve(fns, pad):
        timed = {name: Timed(fn, pad) for name, fn in fns.items()}
        tobj = TimedObjective(obj, KERNEL_PAD)
        with mods.swapped(timed):
            res = cns.minimize_batched(tobj, x0, solver, cut, trace=1)
        torch.cuda.synchronize()
        ev = tobj.batched_value_and_grad
        calls = list(timed.values()) + [ev]
        return {
            **{name: t.mean_ms() for name, t in timed.items()},
            "eval_ms": ev.mean_ms(), "trips": res.trips,
            "starved": sum(t.starved for t in calls),
            "calls": sum(len(t.events) for t in calls),
        }

    runs = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        plain = which == "plain"
        runs[which].append(solve(mods.plain if plain else mods.kernels,
                                 PLAIN_PAD if plain else KERNEL_PAD))
    work = nested_work(mods, obj, x0, solver, cut)

    def mean(which, key):
        return sum(r[key] for r in runs[which]) / len(runs[which])

    every = runs["plain"] + runs["kernel"]
    return {
        "kernels": {name: {
            "ms": mean("kernel", name), "plain_ms": mean("plain", name),
            "ms_runs": [r[name] for r in runs["kernel"]],
            **work[name],
        } for name in mods.kernels},
        "eval_ms": mean("kernel", "eval_ms"),
        "timed_iterations": NESTED_TIMED_ITERATIONS,
        "starved_calls": sum(r["starved"] for r in every),
        "padded_calls": sum(r["calls"] for r in every),
    }


def nested_work(mods, obj, x0, solver, stop) -> dict:
    """Bytes and operations the calls of one nested solve need, lane by
    lane, each input read once and each output written once.

    ``mt_trip``: a searching lane reads g_t, the direction and x0 and writes
    the accepted gradient and the trial point; a lane whose search is over
    reads its info code.  ``lbfgs_prologue``: a live lane reads x, g and the
    pending pair, reads the history rows its two-loop uses, writes the rows
    that changed (one, or all m when a full history shifts) and the
    direction; a done lane writes a zero direction.  ``lbfgs_epilogue``: a
    live lane reads x0, g0 and the search's x and g and writes x, g and the
    pending pair; a done lane reads its flag.  Scalars count for live lanes."""
    import torch

    cns, fl = mods.cns, mods.fl
    n = x0.shape[1]
    w = x0.element_size()
    eps = torch.finfo(x0.dtype).eps
    tot = {name: {"bytes": 0.0, "ops": 0.0, "calls": 0}
           for name in mods.kernels}

    def add(name, byts, ops):
        tot[name]["bytes"] += float(byts.sum())
        tot[name]["ops"] += float(ops.sum())
        tot[name]["calls"] += 1

    def prologue(x, g, s_mem, y_mem, count, gamma, s_new, y_new, valid, done):
        live = ~done
        sy, s2, y2 = ((a * c).sum(1) for a, c in
                      ((s_new, y_new), (s_new, s_new), (y_new, y_new)))
        accept = valid & live & (sy > eps * s2.sqrt() * y2.sqrt())
        c0 = count.long()
        full = c0 >= M
        c1 = torch.where(accept & ~full, c0 + 1, c0)
        hist_read = 2 * n * (c1 - accept.long()).clamp(min=0)
        hist_write = torch.where(
            accept, torch.where(full, 2 * M * n, 2 * n), 0)
        elems = torch.where(live, 5 * n + hist_read + hist_write, n)
        add("lbfgs_prologue",
            elems * w + torch.where(live, 4 * w + 2 * 4 + 2, 2 * w + 1),
            torch.where(live, 14 * n + 10 * n * c1, 0))
        return mods.kernels["lbfgs_prologue"](
            x, g, s_mem, y_mem, count, gamma, s_new, y_new, valid, done)

    def trip(x0_, sdir, f_t, g_t, st, max_fev):
        active = st.si[:, fl._I_INFO] == 0
        scal = (2 * fl._NF + 1) * w + 2 * fl._NI * 4
        add("mt_trip", torch.where(active, 5 * n * w + scal, 4),
            torch.where(active, 4 * n, 0))
        mods.kernels["mt_trip"](x0_, sdir, f_t, g_t, st, max_fev)

    def epilogue(state, x_ls, f_ls, g_ls, ls_nfev, count, s_pend, y_pend,
                 pvalid, done, progress, crit):
        live = ~done
        scal = (2 + 3 + 2 * 8) * w + 12 * 4 + 2
        add("lbfgs_epilogue", torch.where(live, 8 * n * w + scal, 1),
            torch.where(live, 8 * n, 0))
        return mods.kernels["lbfgs_epilogue"](
            state, x_ls, f_ls, g_ls, ls_nfev, count, s_pend, y_pend, pvalid,
            done, progress, crit)

    with mods.swapped({"lbfgs_prologue": prologue, "mt_trip": trip,
                       "lbfgs_epilogue": epilogue}):
        cns.minimize_batched(obj, x0, solver, stop, trace=1)
    dname = str(x0.dtype).split(".")[1]
    out = {}
    for name, t in tot.items():
        bytes_ms = t["bytes"] / t["calls"] / HBM_BYTES_PER_S * 1e3
        ops_ms = t["ops"] / t["calls"] / PEAK_OPS_PER_S[dname] * 1e3
        out[name] = {
            "bytes_per_call": t["bytes"] / t["calls"],
            "ops_per_call": t["ops"] / t["calls"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
    return out


def path_compare(cns, obj, x0, solver, stop) -> dict:
    """Whole solves to the end on the host clock, flat, nested, nested,
    flat: the same algorithm through the two loops."""
    import torch

    def solve(nested):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cns.minimize_batched(obj, x0, solver, stop,
                                   trace=1 if nested else 0)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    walls = {False: [], True: []}
    for nested in (False, True, True, False):
        res, wall = solve(nested)
        walls[nested].append(wall)
        if nested:
            nres = res
        else:
            fres = res
    its = nres.progress.num_iterations
    mean = {k: sum(v) / len(v) for k, v in walls.items()}
    return {
        "nested_solve_s": mean[True], "flat_solve_s": mean[False],
        "nested_solve_s_runs": walls[True], "flat_solve_s_runs": walls[False],
        "nested_iterations": int(its.max()), "nested_trips": nres.trips,
        "flat_trips": fres.trips,
        "nested_lane_iterations_per_s": float(its.sum()) / mean[True],
        "flat_lane_iterations_per_s": float(
            fres.progress.num_iterations.sum()) / mean[False],
    }


def timing(fs, obj, x0, stop) -> dict:
    """Per-trip time of the kernel and of the plain version, each solve run
    in the order plain, kernel, kernel, plain, and the least time each
    trip's data needs on this card.

    Two kinds of solve.  Host-clock solves time whole trips as a user sees
    them.  Device solves give the card's own time (spin-padded, see
    :class:`Timed`); the device figures hold only where the count of starved
    calls is 0."""
    import torch

    def solve(trip, device_time):
        state0 = obj.evaluate(x0)
        plain = trip is fs.flat_trip_reference
        pad = (PLAIN_PAD if plain else KERNEL_PAD) if device_time else 0
        trip, tobj = Timed(trip, pad), TimedObjective(obj, pad and KERNEL_PAD)
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
