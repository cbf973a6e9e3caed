#!/usr/bin/env python3
"""Head-to-head: the port's L-BFGS against SciPy's L-BFGS-B on MGH-376.

    python3 benchmarks_torch/compare_scipy.py              # on one GPU
    python3 benchmarks_torch/compare_scipy.py --device cpu

The PyTorch/CUDA port's counterpart of ``benchmarks/compare_scipy.py``,
which stays the JAX package's.  The same experiment: the 376 instances of
the MGH suite (``suite_bench.py``'s: ``models.mgh_benchmark_instances``,
seed 0, 58 problems), suite_bench.py's reliability solver and stopping
(``Lbfgs(m=10)``, the Conservative preset with two x-delta strikes) and
success contract (``models.success_mask``), float64 on both sides, one
attempt per instance on each (the reference's single-run protocol), every
objective-and-gradient evaluation counted once.  The port solves each
problem's starts with one ``minimize_batched`` (the flat loop and its
``flat_trip`` kernel on the card); SciPy's L-BFGS-B (unbounded, so plain
L-BFGS) runs on the host at the JAX script's settings (m = 10, ``gtol``
1e-6, ``ftol`` 1e-12, at most 20,000 evaluations), its objective and
gradient the port's own in one call on the CPU.  The port's kernels are
built and the allocator warmed by one solve before the timed pass, as the
JAX script pre-warms its compile cache.

Prints one JSON line with the JAX script's keys, plus ``device``: the
card's name and power limit (``nvidia-smi``), or "cpu".  With no GPU and
no ``--device cpu`` it prints no result and exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCIPY_OPTIONS = {"maxcor": 10, "ftol": 1e-12, "gtol": 1e-6, "maxfun": 20000,
                 "maxiter": 10000}


def run_ours(batches, device):
    """One float64 attempt per instance: ``(ok, nfev)`` over all of them in
    order, by suite_bench.py's solver, stopping and success contract."""
    import numpy as np
    import torch

    import cppnumericalsolvers_tpu_torch as cns
    import suite_bench

    records = suite_bench.solve_problems(cns, batches, torch.float64, device)
    return (np.concatenate([r["ok"] for r in records]),
            np.concatenate([r["nfev"] for r in records]))


def run_scipy(batches):
    """SciPy's L-BFGS-B on the same instances at the JAX script's settings:
    ``(ok, nfev)``, nfev counting each fused objective-and-gradient call
    once."""
    import numpy as np
    import torch
    from scipy import optimize

    from cppnumericalsolvers_tpu_torch.models import success_mask

    oks, nfevs = [], []
    for problem, starts in batches:
        def fun(x, vg=problem.objective.value_and_grad):
            v, g = vg(torch.from_numpy(x))
            return float(v), g.numpy().astype(np.float64)

        for x0 in starts:
            res = optimize.minimize(fun, np.asarray(x0, dtype=np.float64),
                                    jac=True, method="L-BFGS-B",
                                    options=SCIPY_OPTIONS)
            f = np.asarray([float(res.fun)])
            ginf = np.asarray([np.max(np.abs(np.asarray(res.jac)))])
            xinf = np.asarray([np.max(np.abs(np.asarray(res.x)))])
            oks.append(success_mask(problem, f, ginf, xinf)[0])
            nfevs.append(float(res.nfev))
    return np.asarray(oks), np.asarray(nfevs)


def compare(ours_ok, ours_nfev, sp_ok, sp_nfev, t_ours, t_sp) -> dict:
    """The JAX script's summary: convergence, mean nfev and the reference's
    first-place accounting over the instances both sides solve (strictly
    fewer evaluations wins; ties are counted apart and split evenly into
    ``nfev_first_place``)."""
    import numpy as np

    both = ours_ok & sp_ok
    wins = int(np.sum(ours_nfev[both] < sp_nfev[both]))
    losses = int(np.sum(ours_nfev[both] > sp_nfev[both]))
    ties = int(both.sum()) - wins - losses
    return {
        "metric": "ours_vs_scipy_lbfgsb_single_solve",
        "total_instances": int(ours_ok.size),
        "ours_converged_pct": round(100.0 * float(ours_ok.mean()), 2),
        "scipy_converged_pct": round(100.0 * float(sp_ok.mean()), 2),
        "ours_mean_nfev": round(float(ours_nfev.mean()), 1),
        "scipy_mean_nfev": round(float(sp_nfev.mean()), 1),
        "both_solved": int(both.sum()),
        "nfev_wins": wins,
        "nfev_ties": ties,
        "nfev_losses": losses,
        "nfev_first_place": round(wins + ties / 2.0, 1),
        "ours_wall_s": round(t_ours, 1),
        "scipy_wall_s": round(t_sp, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the port solves: cuda (default) or cpu")
    args = ap.parse_args(argv)
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("compare_scipy: no CUDA device is available; nothing was run.",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import suite_bench
    from benchmarks_torch.roofline import card_line
    from cppnumericalsolvers_tpu_torch.models import mgh_benchmark_instances

    torch.set_num_threads(1)
    batches = mgh_benchmark_instances(suite_bench.TOTAL_INSTANCES, seed=0)
    run_ours(batches[:1], args.device)  # kernels built, allocator warm
    t0 = time.perf_counter()
    ours_ok, ours_nfev = run_ours(batches, args.device)
    if args.device != "cpu":
        torch.cuda.synchronize()
    t_ours = time.perf_counter() - t0
    t0 = time.perf_counter()
    sp_ok, sp_nfev = run_scipy(batches)
    t_sp = time.perf_counter() - t0
    out = compare(ours_ok, ours_nfev, sp_ok, sp_nfev, t_ours, t_sp)
    out["device"] = "cpu" if args.device == "cpu" else card_line()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
