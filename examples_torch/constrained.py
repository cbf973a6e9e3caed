"""Constrained optimization via the augmented-Lagrangian outer loop.

PyTorch counterpart of examples/constrained.py (the reference's
src/examples/constrained_simple.cc:1-136 and constrained_simple2.cc:1-91):

1. minimize (x0-1)^2 + (x1-2)^2  s.t.  x0 + x1 = 2  and  x1 - x0 >= 1
   -> x* = (0.5, 1.5)
2. minimize x0 + x1              s.t.  x0^2 + x1^2 = 2
   -> x* = (-1, -1)

On the card each inner L-BFGS solve runs the iteration-granular loop
(``lbfgs_prologue``, ``mt_trip``, ``lbfgs_epilogue``).  ``problems()`` is
what ``chip_smoke.py`` solves from many starts.

Run:  python examples_torch/constrained.py [--device cuda|cpu]
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cppnumericalsolvers_tpu_torch import (  # noqa: E402
    ConstrainedProblem, objective, status_message)
from cppnumericalsolvers_tpu_torch.solvers import (  # noqa: E402
    AugmentedLagrangian, Lbfgs)
from examples_torch import _common  # noqa: E402

SOLVES = ("quadratic", "circle")
#: Each problem's start in the original.
STARTS = {"quadratic": (5.0, -3.0), "circle": (2.0, 1.0)}


def problems() -> dict:
    """``{name: (problem, analytic optimum)}``: a quadratic with one
    equality and one inequality, (0.5, 1.5); a linear objective on the
    circle x0^2 + x1^2 = 2, (-1, -1)."""
    quadratic = ConstrainedProblem(
        objective=objective(
            lambda x: (x[0] - 1.0) ** 2 + (x[1] - 2.0) ** 2, mode="second"
        ),
        equality_constraints=(
            objective(lambda x: x[0] + x[1] - 2.0, mode="second"),
        ),
        inequality_constraints=(
            objective(lambda x: x[1] - x[0] - 1.0, mode="second"),
        ),
    )
    circle = ConstrainedProblem(
        objective=objective(lambda x: x[0] + x[1], mode="second"),
        equality_constraints=(
            objective(lambda x: x[0] ** 2 + x[1] ** 2 - 2.0, mode="second"),
        ),
    )
    return {"quadratic": (quadratic, (0.5, 1.5)),
            "circle": (circle, (-1.0, -1.0))}


def solve(name: str, device=None) -> dict:
    problem, _ = problems()[name]
    al = AugmentedLagrangian(inner_solver=Lbfgs())
    res = al.minimize(problem, torch.tensor(STARTS[name],
                                            dtype=torch.float64),
                      device=device)
    out = _common.figures(res)
    out["equality_multipliers"] = res.state.multipliers.equality.tolist()
    out["inequality_multipliers"] = (
        res.state.multipliers.inequality.tolist())
    return out


def report(tag, r, expect):
    x = np.asarray(r["x"])
    print(
        f"{tag}: x = {np.round(x, 6)}  (expect {expect})"
        f"  violation = {r['max_violation']:.2e}"
        f"  outer iters = {r['iterations']}"
        f"  [{status_message(r['status'])}]"
    )
    assert np.allclose(x, expect, atol=1e-3), tag


def main(device=None) -> dict:
    out = {name: solve(name, device) for name in SOLVES}
    optimum = {name: p[1] for name, p in problems().items()}
    # 1. Quadratic with one equality and one inequality.
    report("eq+ineq quadratic", out["quadratic"], optimum["quadratic"])
    print("   multipliers: lambda =",
          np.asarray(out["quadratic"]["equality_multipliers"]),
          " mu =", np.asarray(out["quadratic"]["inequality_multipliers"]))
    # 2. Linear objective on the circle x0^2 + x1^2 = 2.
    report("linear on circle", out["circle"], optimum["circle"])
    return out


if __name__ == "__main__":
    main(_common.parse_device(__doc__.splitlines()[0]).device)
