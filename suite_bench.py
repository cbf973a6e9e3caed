#!/usr/bin/env python3
"""The MGH-376 reliability benchmark of the PyTorch/CUDA port, on one GPU.

    python3 suite_bench.py        # from the repository root; needs one GPU

The port's counterpart of bench.py's reliability leg (bench.py stays the
JAX package's).  The 376 instances of
``cppnumericalsolvers_tpu_torch.models.mgh_benchmark_instances`` (58
distinct MGH problems at their published dimensions, n = 2-40, 6-7 starts
each) are solved one problem at a time by ``minimize_batched`` with the
reliability solver and stopping of bench.py:50-66 (``Lbfgs(m=10)``, the
Conservative preset with two x-delta strikes); every instance is a fresh,
untraced solve, so it runs the flat loop and its ``flat_trip`` kernel.

Protocol (bench.py:237-300): every instance is first solved in float32;
the problems with an instance that misses the success contract
(``models.suite.success_mask``, bench.py:76-83) are solved again in float64
from their original starts, and each failed instance takes the float64
result, billed with both attempts' nfev.  That is the single solve, the
headline figure (the reference's own is 95% converged).  Then up to two
polish rounds (bench.py:177) restart the instances still failing from their
last iterate in float64 with a fresh history, adding their nfev: the
polished figure, a different protocol, reported beside it.

It prints the converged count of the single and the polished solve, the
instances solved at each precision stage, the total nfev and the wall
seconds, then each instance whose outcome differs from BENCH_INSTANCES.json
(the JAX package's record on a TPU; information, not a gate).  The record,
one row per instance in BENCH_INSTANCES.json's fields, goes to
``chiprun_out/suite_instances.json``.  With no GPU it prints no result and
exits 1.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TOTAL_INSTANCES = 376  # reference benchmark size (its README.md:6)
BASELINE_CONVERGED_PCT = 95.0  # reference reliability (its README.md:8-9)
POLISH_ROUNDS = 2
REFERENCE_RECORD = os.path.join(ROOT, "BENCH_INSTANCES.json")


def reliability_solver(cns):
    return cns.Lbfgs(m=10)


def reliability_stopping(cns, dtype):
    # bench.py:54-66: the Conservative preset (the reference's guidance for
    # the MGH problems with flat valleys), with two x-delta strikes instead
    # of one; float32 takes the preset's float32 variant.
    return cns.conservative_stopping(dtype).replace(x_delta_violations=2)


def _record(problem, res):
    """One problem's per-instance figures as numpy arrays (one read of the
    device per field)."""
    import numpy as np

    from cppnumericalsolvers_tpu_torch.models import success_mask

    f = res.state.value.double().cpu().numpy()
    ginf = res.state.gradient.abs().amax(-1).double().cpu().numpy()
    x = res.state.x.cpu().numpy()
    xinf = np.abs(x).max(-1).astype(np.float64)
    return {
        "problem": problem,
        "ok": success_mask(problem, f, ginf, xinf),
        "nfev": res.state.nfev.cpu().numpy().astype(np.float64),
        "x": x,
        "f": f,
        "status": res.progress.status.cpu().numpy().astype(np.int64),
        "iters": res.progress.num_iterations.cpu().numpy().astype(np.int64),
        "trips": res.trips,
    }


def solve_problems(cns, batches, dtype, device):
    """``minimize_batched`` on each ``(problem, starts)``: one record per
    problem (:func:`_record`)."""
    import torch

    solver = reliability_solver(cns)
    stop = reliability_stopping(cns, dtype)
    device = torch.device(device)
    out = []
    for problem, starts in batches:
        x0 = torch.from_numpy(starts).to(device=device, dtype=dtype)
        res = cns.minimize_batched(problem.objective, x0, solver, stop,
                                   device=device)
        out.append(_record(problem, res))
    return out


def single_solve(device="cuda", seed=0) -> dict:
    """The float32-first, float64-fallback single solve of the 376
    instances on ``device``.  Returns ``records`` (one per problem, the
    single-solve outcome with ``stage`` 0 for float32 and 1 for the float64
    fallback), the passes' own records (``float32``: every problem;
    ``float64``: the problems that fell back, all their lanes, by index)
    and the wall seconds of each pass."""
    import numpy as np
    import torch

    import cppnumericalsolvers_tpu_torch as cns
    from cppnumericalsolvers_tpu_torch.models import mgh_benchmark_instances

    batches32 = mgh_benchmark_instances(TOTAL_INSTANCES, seed=seed,
                                        dtype_str="float32")
    batches64 = mgh_benchmark_instances(TOTAL_INSTANCES, seed=seed)
    t0 = time.perf_counter()
    pass32 = solve_problems(cns, batches32, torch.float32, device)
    f32_wall = time.perf_counter() - t0
    records = []
    for rec in pass32:
        records.append(dict(rec, stage=np.zeros(rec["ok"].size, np.int64),
                            x=rec["x"].astype(np.float64)))
    fail = [i for i, r in enumerate(records) if not r["ok"].all()]
    t0 = time.perf_counter()
    pass64 = solve_problems(cns, [batches64[i] for i in fail], torch.float64,
                            device)
    f64_wall = time.perf_counter() - t0
    for i, new in zip(fail, pass64):
        rec = records[i]
        bad = ~rec["ok"]
        for key in ("ok", "f", "status", "iters"):
            rec[key] = np.where(bad, new[key], rec[key])
        rec["x"] = np.where(bad[:, None], new["x"], rec["x"])
        # A fallback instance pays its failed float32 attempt and the
        # float64 solve.
        rec["nfev"] = rec["nfev"] + np.where(bad, new["nfev"], 0.0)
        rec["stage"] = np.where(bad, 1, rec["stage"])
    return {"records": records, "float32": pass32,
            "float64": dict(zip(fail, pass64)),
            "f32_wall_s": f32_wall, "f64_wall_s": f64_wall}


def polish_records(records, device, rounds=POLISH_ROUNDS) -> int:
    """Restart the failing instances from their last iterate in float64
    with a fresh history and fresh stopping counters, adding their nfev
    (bench.py:177-214): up to ``rounds`` rounds.  Changes ``records`` in
    place; returns the instances restarted."""
    import torch

    import cppnumericalsolvers_tpu_torch as cns

    restarted = 0
    for _ in range(rounds):
        todo = [i for i, r in enumerate(records) if not r["ok"].all()]
        if not todo:
            break
        news = solve_problems(
            cns, [(records[i]["problem"], records[i]["x"]) for i in todo],
            torch.float64, device)
        for i, new in zip(todo, news):
            rec = records[i]
            bad = ~rec["ok"]
            restarted += int(bad.sum())
            rec["nfev"][bad] += new["nfev"][bad]
            rec["ok"] = rec["ok"] | new["ok"]
            rec["x"] = new["x"]
    return restarted


def instance_rows(records) -> list:
    """One row per (problem, start) in BENCH_INSTANCES.json's fields."""
    rows = []
    for rec in records:
        p = rec["problem"]
        for k in range(rec["ok"].size):
            rows.append({
                "problem": p.name,
                "n": int(p.x0.shape[0]),
                "start": k,
                "ok": bool(rec["ok"][k]),
                "nfev": float(rec["nfev"][k]),
                "f": float(rec["f"][k]),
                "status": int(rec["status"][k]),
                "iters": int(rec["iters"][k]),
                "stage": int(rec["stage"][k]),
            })
    return rows


def reference_differences(rows) -> list:
    """The instances whose success or precision stage differs from
    BENCH_INSTANCES.json's (the JAX package on a TPU)."""
    with open(REFERENCE_RECORD) as f:
        ref = {(r["problem"], r["start"]): r for r in json.load(f)["rows"]}
    out = []
    for row in rows:
        theirs = ref.get((row["problem"], row["start"]))
        if theirs is None or (theirs["ok"], theirs.get("stage")) != (
                row["ok"], row["stage"]):
            out.append({"problem": row["problem"], "start": row["start"],
                        "ok": row["ok"], "stage": row["stage"],
                        "reference": None if theirs is None else {
                            "ok": theirs["ok"],
                            "stage": theirs.get("stage"),
                            "status": theirs["status"]},
                        "status": row["status"]})
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("suite_bench: no CUDA device is available; nothing was run.",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import subprocess

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    run = single_solve("cuda")
    records = run["records"]
    total = sum(r["ok"].size for r in records)
    single = sum(int(r["ok"].sum()) for r in records)
    f32_ok = sum(int(r["ok"].sum()) for r in run["float32"])
    rows = instance_rows(records)
    single_nfev = sum(float(r["nfev"].sum()) for r in records)
    tp = time.perf_counter()
    restarted = polish_records(records, "cuda")
    polish_wall = time.perf_counter() - tp
    polished = sum(int(r["ok"].sum()) for r in records)
    result = {
        "card": card,
        "total_instances": total,
        "distinct_problems": len(records),
        "converged_single_solve": single,
        "converged_pct_single_solve": 100.0 * single / total,
        "converged_with_restarts": polished,
        "converged_pct_with_restarts": 100.0 * polished / total,
        "solved_in_float32": f32_ok,
        "attempted_in_float64": total - f32_ok,
        "solved_in_float64": single - f32_ok,
        "nfev_single_solve": single_nfev,
        "nfev_with_restarts": sum(float(r["nfev"].sum()) for r in records),
        "polish_rounds": POLISH_ROUNDS,
        "polish_restarted_instances": restarted,
        "f32_pass_s": run["f32_wall_s"],
        "f64_pass_s": run["f64_wall_s"],
        "polish_s": polish_wall,
        "wall_s": time.perf_counter() - t0,
        "baseline_converged_pct": BASELINE_CONVERGED_PCT,
    }
    diffs = reference_differences(rows)
    result["differences_from_reference"] = len(diffs)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "suite_instances.json"), "w") as f:
        json.dump({"rows": rows, "summary": result,
                   "differences_from_reference": diffs}, f)
    for d in diffs:
        print("[differs from BENCH_INSTANCES.json] " + json.dumps(d))
    print(f"[suite] {card}: single solve {single}/{total} converged "
          f"({result['converged_pct_single_solve']:.2f}%; float32 {f32_ok}, "
          f"float64 fallback {single - f32_ok} of {total - f32_ok} "
          f"attempted), polished {polished}/{total} "
          f"({result['converged_pct_with_restarts']:.2f}%), nfev "
          f"{single_nfev:.0f} single, {result['nfev_with_restarts']:.0f} "
          f"polished, wall {result['wall_s']:.1f} s")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
