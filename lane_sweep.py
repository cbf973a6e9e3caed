#!/usr/bin/env python3
"""Time the redesigned kernels under every lane mapping or launch plan on
one GPU.

    python3 lane_sweep.py                      # from the repository root
    python3 lane_sweep.py --baseline DIR       # also time DIR's package

For each shape the kernels run at in ``chip_smoke.py`` it forces each lane
mapping (``ops/_kernel.py::_pick``: lanes per block, threads per lane, where
the history rows are read) or launch plan (``ops/fused_step_t.py``) and
records the kernel's device time per launch with ``torch.profiler``
(float32, m = 10):

* ``flat_trip``: 30 trips of a solve with the shipped mapping, then 40
  trips from a copy of that state under each mapping; one trip of each is
  also held against the plain version (largest scaled error of the
  direction, and whether the int scalars are equal);
* ``lbfgs_prologue``: a traced solve cut at 40 iterations per mapping;
* ``lbfgs_prologue_t``: a traced solve of the batch-minor loop cut at 40
  iterations per launch plan (lane tile, threads, cluster) that gives at
  least 128 blocks;
* ``mt_trip``: a traced solve cut at 40 iterations per mapping, batch-major
  at (1024, 1024) and (256, 4096), batch-minor at (1024, 32) and (512,
  2048);
* ``push_two_loop``: 20 calls on made-up inputs (``chip_smoke.made_up``,
  fresh copies each call) per mapping, at the shapes ``chip_smoke.py`` runs
  it (float32, and float64 at path B's (1024, 256));
* ``two_loop``: 20 calls on made-up inputs per mapping, in float32 and
  float64, at path C's shapes and at n = 256 and 2048 (the ring, the
  stream, the rows in place and q in device memory where each fits a
  block; q in device memory is a mapping of every block-per-lane history
  kernel);
* ``lbfgs_epilogue``: a traced solve cut at 40 iterations per mapping
  (lanes per block, threads per lane, cluster), and on made-up inputs
  (``chip_smoke.made_up_epilogue``) a digest of every output's bits per
  mapping, which must equal the baseline kernel's.

``--baseline DIR`` times the package of another checkout (for example the
parent commit unpacked with ``git archive``) at its own mappings in a
subprocess, for a comparison within one call, and holds the epilogue's
bits against its kernel's.  The record goes to
``chiprun_out/lane_sweep.json``; each line is printed as it is measured.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAT_SHAPES = [(1024, 32), (8192, 32), (1024, 1024), (256, 4096)]
PROLOGUE_SHAPES = [(1024, 32), (1024, 256), (1024, 1024), (512, 2048),
                   (256, 4096)]
T_SHAPES = [(1024, 32), (1024, 256), (1024, 1024), (512, 2048)]
MT_SHAPES = [(1024, 1024, False), (256, 4096, False), (1024, 32, True),
             (512, 2048, True)]
PUSH_SHAPES = [(1024, 32, 4), (1024, 256, 4), (1024, 1024, 4),
               (256, 4096, 4), (1024, 256, 8)]
EPILOGUE_SHAPES = [(1024, 32), (1024, 256), (1024, 1024), (512, 2048),
                   (256, 4096), (64, 16384)]
TWO_LOOP_SHAPES = [(b, n, w) for w in (4, 8)
                   for b, n in ((1024, 32), (1024, 256), (1024, 1024),
                                (512, 2048), (256, 4096))]
M = 10


def smoke():
    """``chip_smoke.py`` of this checkout (its made-up inputs and the
    epilogue's mappings), whatever package is imported."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def variants(K, n, op, itemsize=4):
    """``None`` (the shipped mapping) and the forced ones at width ``n``;
    ``flat_trip`` and ``two_loop`` take no staged rows."""
    S, T, D = K.ROWS_STREAM, K.ROWS_STAGED, K.ROWS_DIRECT
    modes = (S, D) if op in ("flat_trip", "two_loop") else (T, S, D)
    if n <= 64:
        warp = (D,) + modes[:-2]
        if op in ("push_two_loop", "two_loop"):
            warp += (K.ROWS_REGISTERS,)
        return [None] + [(lpb, 32, rows) for lpb in (1, 2, 4, 8)
                         for rows in warp]
    if op == "two_loop":
        modes += (K.ROWS_RING,)
    modes += (K.ROWS_DEVICE_Q,)
    out = [None]
    for tpl in (64, 128, 256, 512):
        if tpl * 16 < n or tpl > n:
            continue
        for rows in modes:
            if K.lane_smem_bytes(M, n, itemsize, rows, 1,
                                 False) <= K.SMEM_LIMIT:
                out.append((1, tpl, rows))
    return out


def t_variants(ft, b, n):
    """``None`` (the shipped plan) and every plan of at least 128 blocks."""
    return [None] + [p for p in ft.launch_candidates(b, M, n, 4)
                     if p["blocks"] >= 128]


def mt_variants(n):
    """``None`` and the forced ``mt_trip`` mappings at width ``n``."""
    if n <= 64:
        return [None] + [(lpb, 32) for lpb in (1, 2, 4, 8)]
    return [None] + [(1, tpl) for tpl in (64, 128, 256, 512)
                     if tpl * 2 <= n <= tpl * 32]


def device_us(prof, key):
    events = [e for e in prof.key_averages() if key in e.key]
    total = sum(getattr(e, "device_time_total", 0) for e in events)
    count = sum(e.count for e in events)
    return total / max(count, 1), count


def measure(root, forced):
    """Time the package under ``root``; ``forced`` sweeps the mappings."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import cppnumericalsolvers_tpu_torch as cns
    from cppnumericalsolvers_tpu_torch.ops import flat_solve as fs

    K = None
    if forced:
        from cppnumericalsolvers_tpu_torch.ops import _kernel as K
        shipped = K._pick

    def force(v, only=None):
        """Force mapping ``v`` on op ``only``; the other ops keep theirs."""
        if K is None:
            return
        if v is None:
            K._pick = shipped
            return
        lpb, tpl, rows = v

        def pick(op, b, n, m, w):
            if op != only:
                return shipped(op, b, n, m, w)
            return lpb, tpl, rows, K.lane_smem_bytes(m, n, w, rows, lpb,
                                                     tpl == 32), 1
        K._pick = pick

    dev = torch.device("cuda")
    obj = cns.models.pairwise_rosenbrock()
    stop = cns.default_stopping(torch.float32)

    def start(b, n):
        x0 = np.random.default_rng(0).uniform(-2.0, 2.0, (b, n))
        return torch.from_numpy(x0).to(dev, torch.float32)

    out = {}
    for b, n in FLAT_SHAPES:
        force(None)
        st, xt = fs.init_flat_state(obj.evaluate(start(b, n)), M, 20)
        for _ in range(30):
            f, g = obj.batched_value_and_grad(xt)
            fs.flat_trip(st, f, g, xt, stop, 20)
        for v in (variants(K, n, "flat_trip") if K else [None]):
            force(v, "flat_trip")
            s1, x1 = st.clone(), xt.clone()
            f, g = obj.batched_value_and_grad(x1)
            s2, x2 = s1.clone(), x1.clone()
            fs.flat_trip(s1, f, g, x1, stop, 20)
            fs.flat_trip_reference(s2, f, g, x2, stop, 20)
            err = float(((s1.sdir - s2.sdir).abs().amax(1)
                         / s2.sdir.abs().amax(1).clamp_min(1e-30)).max())
            same = bool((s1.si == s2.si).all())
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(40):
                    f, g = obj.batched_value_and_grad(x1)
                    fs.flat_trip(s1, f, g, x1, stop, 20)
                torch.cuda.synchronize()
            us, count = device_us(prof, "flat_trip")
            key = f"flat_trip {b}x{n} {v or 'shipped'}"
            out[key] = {"us": us, "launches": count, "direction_err": err,
                        "ints_equal": same}
            print("[sweep]", key, json.dumps(out[key]), flush=True)
    solver = cns.Lbfgs(m=M, max_linesearch_fev=20)
    for b, n in PROLOGUE_SHAPES:
        for v in (variants(K, n, "lbfgs_prologue") if K else [None]):
            force(v, "lbfgs_prologue")
            cns.minimize_batched(obj, start(b, n), solver,
                                 stop.replace(max_iterations=2), trace=1)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                cns.minimize_batched(obj, start(b, n), solver,
                                     stop.replace(max_iterations=40), trace=1)
                torch.cuda.synchronize()
            us, count = device_us(prof, "prologue_kernel")
            key = f"lbfgs_prologue {b}x{n} {v or 'shipped'}"
            out[key] = {"us": us, "launches": count}
            print("[sweep]", key, json.dumps(out[key]), flush=True)
    force(None)

    def layout(minor):
        cns.Lbfgs._TRANSPOSED_N_MAX = 1 << 30 if minor else 0
        cns.Lbfgs._TRANSPOSED_B_MIN = 1

    def nested(b, n, key, label):
        """Device time per launch of ``key`` in a traced 40-iteration
        solve; a package whose kernels cannot take (b, n) (a checkout from
        before the rows could be read in place) records the refusal."""
        try:
            cns.minimize_batched(obj, start(b, n), solver,
                                 stop.replace(max_iterations=2), trace=1)
        except ValueError as err:
            out[label] = {"error": str(err)}
            print("[sweep]", label, json.dumps(out[label]), flush=True)
            return
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cns.minimize_batched(obj, start(b, n), solver,
                                 stop.replace(max_iterations=40), trace=1)
            torch.cuda.synchronize()
        us, count = device_us(prof, key)
        out[label] = {"us": us, "launches": count}
        print("[sweep]", label, json.dumps(out[label]), flush=True)

    shipped_n, shipped_b = cns.Lbfgs._TRANSPOSED_N_MAX, \
        cns.Lbfgs._TRANSPOSED_B_MIN
    from cppnumericalsolvers_tpu_torch.ops import fused_step_t as ft
    shipped_plan = ft.prologue_t_launch_plan
    layout(True)
    for b, n in T_SHAPES:
        for plan in (t_variants(ft, b, n) if forced else [None]):
            ft.prologue_t_launch_plan = (
                shipped_plan if plan is None
                else (lambda *_a, _p=plan: _p))
            tag = "shipped" if plan is None else (
                f"tile {plan['lane_tile']} threads {plan['threads']} "
                f"cluster {plan['cluster']}")
            nested(b, n, "prologue_t_kernel",
                   f"lbfgs_prologue_t {b}x{n} {tag}")
    ft.prologue_t_launch_plan = shipped_plan
    for b, n, minor in MT_SHAPES:
        layout(minor)
        for v in (mt_variants(n) if K else [None]):
            if v is None or K is None:
                force(None)
            else:
                def pick(op, b_, n_, m_, w_, _v=v):
                    if op != "mt_trip":
                        return shipped(op, b_, n_, m_, w_)
                    return _v[0], _v[1], K.ROWS_DIRECT, 0, 1
                K._pick = pick
            nested(b, n, "mt_trip_kernel",
                   f"mt_trip {b}x{n} {'minor' if minor else 'major'} "
                   f"{v or 'shipped'}")
    force(None)
    layout(False)
    cs = smoke()
    from cppnumericalsolvers_tpu_torch.ops import two_loop as tl

    for b, n, w in PUSH_SHAPES:
        dtype = torch.float32 if w == 4 else torch.float64
        a = cs.made_up(b, n, dtype, dev)
        keys = ("g", "s", "y", "count", "gamma", "s_new", "y_new", "valid")
        for v in (variants(K, n, "push_two_loop", w) if K else [None]):
            force(v, "push_two_loop")
            calls = [[a[k].clone() for k in keys] for _ in range(21)]
            tl.lbfgs_push_and_direction(*calls[0])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for args in calls[1:]:
                    tl.lbfgs_push_and_direction(*args)
                torch.cuda.synchronize()
            # push_two_loop_kernel, or the register-held rows'
            # push_two_loop_regs_kernel.
            us, count = device_us(prof, "push_two_loop")
            dname = "float32" if w == 4 else "float64"
            key = f"push_two_loop {b}x{n} {dname} {v or 'shipped'}"
            out[key] = {"us": us, "launches": count}
            print("[sweep]", key, json.dumps(out[key]), flush=True)
    force(None)
    for b, n, w in TWO_LOOP_SHAPES:
        dtype = torch.float32 if w == 4 else torch.float64
        a = cs.made_up(b, n, dtype, dev)
        args = [a[k] for k in ("g", "s", "y", "count", "gamma")]
        dname = "float32" if w == 4 else "float64"
        for v in (variants(K, n, "two_loop", w) if K else [None]):
            force(v, "two_loop")
            tl.two_loop_direction(*args)  # the history is read only
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    tl.two_loop_direction(*args)
                torch.cuda.synchronize()
            # two_loop_kernel, or the register-held rows'
            # two_loop_regs_kernel.
            us, count = device_us(prof, "two_loop")
            key = f"two_loop {b}x{n} {dname} {v or 'shipped'}"
            out[key] = {"us": us, "launches": count}
            print("[sweep]", key, json.dumps(out[key]), flush=True)
    force(None)

    def force_epilogue(v):
        if K is None:
            return contextlib.nullcontext()
        return cs.forced_mapping(K, "lbfgs_epilogue", v)

    for b, n in EPILOGUE_SHAPES:
        for v in (cs.epilogue_mappings(K, b, n, 4) if K else [None]):
            with force_epilogue(v):
                nested(b, n, "epilogue_kernel",
                       f"lbfgs_epilogue {b}x{n} {list(v) if v else 'shipped'}")
    from cppnumericalsolvers_tpu_torch.ops import fused_step as fstep

    bits = {}
    for b, n in cs.EPILOGUE_SHAPES:
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[1]
            a = cs.made_up_epilogue(cns, b, n, dtype, dev)
            crit = cns.default_stopping(dtype).replace(max_iterations=10)
            w = dtype.itemsize
            for v in (cs.epilogue_mappings(K, b, n, w) if K else [None]):
                with force_epilogue(v):
                    r = cs.epilogue_call(fstep.lbfgs_epilogue, a, crit)
                torch.cuda.synchronize()
                h = hashlib.sha256()
                for k in sorted(r):
                    h.update(r[k].cpu().numpy().tobytes())
                bits[f"{b}x{n} {dname} {list(v) if v else 'shipped'}"] = (
                    h.hexdigest())
    out["epilogue_bits"] = bits
    cns.Lbfgs._TRANSPOSED_N_MAX = shipped_n
    cns.Lbfgs._TRANSPOSED_B_MIN = shipped_b
    return out


def baseline_ptxas(root) -> dict:
    """Registers and spills of the redesigned kernels in checkout ``root``,
    built with this checkout's nvcc flags."""
    from cppnumericalsolvers_tpu_torch.ops import _build

    out = {}
    for name in ("flat_trip", "lbfgs_prologue", "lbfgs_prologue_t",
                 "mt_trip", "push_two_loop", "lbfgs_epilogue", "two_loop"):
        src = os.path.join(os.path.abspath(root), "cppnumericalsolvers_tpu_torch",
                           "ops", "csrc", f"{name}.cu")
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", os.devnull, src],
            capture_output=True, text=True)
        for fn, regs, stores, loads, stack in _build.parse_ptxas(
                proc.stdout + proc.stderr):
            out[fn] = [regs, stores, loads, stack]
            print(f"[baseline ptxas] {name} {fn}: {regs} registers, "
                  f"{stores}/{loads} bytes spilled, {stack} bytes stack "
                  "frame", flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", help="another checkout to time")
    parser.add_argument("--only", help=argparse.SUPPRESS)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("lane_sweep: no CUDA device is available", file=sys.stderr)
        return 1
    if args.only:
        print("RESULT " + json.dumps(measure(args.only, forced=False)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print("[card]", card, flush=True)
    sys.path.insert(0, ROOT)
    record = {"card": card, "sweep": measure(ROOT, forced=True)}
    if args.baseline:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--only",
             os.path.abspath(args.baseline)], capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        record["baseline"] = json.loads(lines[-1][len("RESULT "):])
        record["baseline_ptxas"] = baseline_ptxas(args.baseline)
        theirs = record["baseline"].pop("epilogue_bits")
        for key, val in record["baseline"].items():
            print("[baseline]", key, json.dumps(val), flush=True)
        # Every mapping of the epilogue gives the baseline kernel's bits.
        mine = record["sweep"]["epilogue_bits"]
        equal = {key: digest == theirs[" ".join(key.split(" ")[:2])
                                       + " shipped"]
                 for key, digest in mine.items()}
        record["epilogue_bits_equal_to_baseline"] = equal
        print("[baseline] lbfgs_epilogue made-up outputs bit-equal to the "
              f"baseline kernel under {sum(equal.values())} of {len(equal)} "
              "(shape, dtype, mapping)", flush=True)
        if not all(equal.values()):
            print("[baseline] differing: "
                  + json.dumps([k for k, v in equal.items() if not v]),
                  flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "lane_sweep.json"), "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
