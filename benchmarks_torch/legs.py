"""The bench legs' shapes, cuts and problems, shared by ``chip_smoke.py``
(``solvers_main``, ``constrained_main``, part (b) of ``parallel_main``) and
``bench_torch.py`` (``solver_legs``, ``al_leg``), so the two run the same
legs (bench.py:419-512)."""

from __future__ import annotations

__all__ = ["AL_LEG", "AL_LEG_BUDGET", "LANE_BOXES", "LBFGSB_BOX",
           "LBFGSB_RUNS", "SOLVER_RUNS", "al_leg_problem"]

# The other unconstrained solvers and searches (solvers_main), at bench.py's
# solver-leg shapes: (label, class, arguments, (B, n), objective mode,
# conservative preset, float32 iteration cut (0: none), kernels the path
# launches).  Gradient descent, conjugate gradient and Nelder-Mead are cut
# (PERF.md §4): gradient descent takes about 4,000 iterations to its end,
# and conjugate gradient's Armijo search backtracks up to ~100 times an
# iteration on some lane of 1024.
SOLVER_RUNS = [
    ("bfgs", "Bfgs", {}, (1024, 32), "first", False, 0, ("mt_trip",)),
    ("bfgs", "Bfgs", {}, (256, 256), "first", False, 0, ("mt_trip",)),
    ("newton", "NewtonDescent", {}, (1024, 32), "second", False, 0, ()),
    ("newton", "NewtonDescent", {}, (256, 64), "second", False, 0, ()),
    ("lbfgs_hz", "Lbfgs", {"m": 10, "line_search": "hager_zhang"},
     (1024, 32), "first", False, 0, ("lbfgs_prologue", "lbfgs_epilogue")),
    ("lbfgs_armijo", "Lbfgs", {"m": 10, "line_search": "armijo"},
     (1024, 32), "first", False, 0, ("lbfgs_prologue", "lbfgs_epilogue")),
    ("gd", "GradientDescent", {}, (1024, 32), "first", True, 300,
     ("mt_trip",)),
    ("cg", "ConjugateGradientDescent", {}, (1024, 32), "first", True, 100,
     ()),
    ("tr", "TrustRegionNewton", {}, (256, 64), "second", False, 0, ()),
    ("tr_hessian_free", "TrustRegionNewton", {"hessian_free": True},
     (256, 64), "first", False, 0, ()),
    ("nm", "NelderMead", {}, (1024, 8), "first", False, 200, ()),
]
# The constrained layer (constrained_main): bench.py's L-BFGS-B legs
# (bench.py:435-442; the box pins every odd coordinate at 0.9, so the Cauchy
# walk crosses real breakpoints), the same with a box per lane, bench.py's
# AL leg (bench.py:468-512: 64 lanes at n = 4096, 10 outer iterations of at
# most 40 inner ones).
LBFGSB_RUNS = [("box", (1024, 32)), ("box", (256, 256)),
               ("lane_boxes", (1024, 32))]
LBFGSB_BOX = (-2.0, 0.9)
LANE_BOXES = ((-2.0, 0.9), (-1.5, 1.5))
AL_LEG = (64, 4096)
AL_LEG_BUDGET = (10, 40)


def al_leg_problem(cns, n):
    """bench.py's AL leg (bench.py:468-512): f = sum(x) + 0.005 sum(x^2)
    under the sphere equality sum(x^2) - n = 0."""
    import torch

    return cns.ConstrainedProblem(
        cns.objective(lambda x: torch.sum(x) + 0.005 * torch.sum(x * x)),
        (cns.objective(lambda x: torch.sum(x * x) - float(n)),))
