"""Box-constrained least squares, float32 — solved two ways.

PyTorch counterpart of examples/linear_regression.py (the reference's
src/examples/linear_regression.cc:1-102): the same bound-constrained least
squares solved (a) with L-BFGS-B's box and (b) with the
augmented-Lagrangian loop over four bound inequalities, after an
unconstrained L-BFGS fit; float32 throughout, as the original.  On the card
the free fit takes the flat solve (``flat_trip``), L-BFGS-B its search
(``mt_trip``), and the AL loop's inner L-BFGS the iteration-granular loop
(``lbfgs_prologue``, ``mt_trip``, ``lbfgs_epilogue``).

Run:  python examples_torch/linear_regression.py [--device cuda|cpu]
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
    ConstrainedProblem, minimize, objective)
from cppnumericalsolvers_tpu_torch.core.driver import (  # noqa: E402
    resolve_device)
from cppnumericalsolvers_tpu_torch.solvers import (  # noqa: E402
    AugmentedLagrangian,
    Lbfgs,
    Lbfgsb,
)
from examples_torch import _common  # noqa: E402

SOLVES = ("free", "lbfgsb", "al")
N_SAMPLES, N_FEATURES = 64, 2
LOWER, UPPER = 0.0, 1.0


def data():
    """The original's seed-0 samples, float32."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(N_SAMPLES, N_FEATURES)).astype(np.float32)
    w_true = np.array([1.8, -0.7], np.float32)
    y = a @ w_true + 0.05 * rng.normal(size=N_SAMPLES).astype(np.float32)
    return a, y


def solve(name: str, device=None) -> dict:
    dev = resolve_device(device)
    a_np, y_np = data()
    a = torch.from_numpy(a_np).to(dev)
    y = torch.from_numpy(y_np).to(dev)
    ls = objective(lambda w: torch.sum((a @ w - y) ** 2) / N_SAMPLES,
                   mode="first")
    if name == "free":
        return _common.figures(minimize(
            ls, torch.zeros(2, dtype=torch.float32), Lbfgs(), device=dev))
    x0 = torch.full((2,), 0.5, dtype=torch.float32)
    if name == "lbfgsb":
        return _common.figures(minimize(
            ls, x0, Lbfgsb(lower=LOWER, upper=UPPER), device=dev))
    # The augmented Lagrangian with 4 bound inequalities w-l >= 0, u-w >= 0.
    problem = ConstrainedProblem(
        objective=ls,
        inequality_constraints=(
            objective(lambda w: w[0] - LOWER, mode="first"),
            objective(lambda w: w[1] - LOWER, mode="first"),
            objective(lambda w: UPPER - w[0], mode="first"),
            objective(lambda w: UPPER - w[1], mode="first"),
        ),
    )
    al = AugmentedLagrangian(inner_solver=Lbfgs())
    return _common.figures(al.minimize(problem, x0, device=dev))


def main(device=None) -> dict:
    out = {name: solve(name, device) for name in SOLVES}
    w_free, w_box, w_al = (np.asarray(out[k]["x"], np.float32)
                           for k in SOLVES)
    print("unconstrained  w =", np.round(w_free, 4))
    print("lbfgsb box     w =", np.round(w_box, 4))
    print("al box         w =", np.round(w_al, 4))

    assert np.all(w_box >= LOWER - 1e-4) and np.all(w_box <= UPPER + 1e-4)
    assert np.allclose(w_box, w_al, atol=5e-3), (w_box, w_al)
    print("both box solvers agree; bound-pinned coordinates:",
          np.where((w_box < LOWER + 1e-3) | (w_box > UPPER - 1e-3))[0]
          .tolist())
    return out


if __name__ == "__main__":
    main(_common.parse_device(__doc__.splitlines()[0]).device)
