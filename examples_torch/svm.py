"""Support-vector machine, four formulations — the end-to-end demo workload.

PyTorch counterpart of examples/svm.py (the reference's SVM example family:
src/examples/svm_primal_lbfgs.cc:1-121, svm_primal_al.cc:1-201,
svm_dual_lbfgsb.cc:1-117, svm_dual_al.cc:1-151), on the original's
deterministic synthetic 2-class Gaussian data:

1. primal-lbfgs : min 0.5|w|^2 + C sum max(0, 1 - y f(x))^2  (plain L-BFGS;
                  on the card the flat solve, ``flat_trip``)
2. primal-al    : min 0.5|w|^2 + C sum xi^2  s.t.  y_i f(x_i) >= 1 - xi_i
                  (AL over L-BFGS, d+1+n variables: ``lbfgs_prologue``,
                  ``mt_trip``, ``lbfgs_epilogue``)
3. dual-lbfgsb  : the no-bias dual, 0 <= alpha <= C (L-BFGS-B: ``mt_trip``)
4. dual-al      : the full dual, AL outside (sum alpha y = 0) around
                  L-BFGS-B inside (the box): ``mt_trip``

All four must separate the data (accuracy at least 0.95).

The two AL formulations run to a budget.  The original runs them to their
limits, where the JAX package's loops spin without moving: its primal-AL
reaches its final violation (3.88e-6) at 10 outer iterations and then runs
to its 10,000-iteration limit (219,755 evaluations); its dual-AL's
violation (4.44e-4) is final after the first outer iteration, and it runs
148 of them, the inner L-BFGS-B to its own limit in each (420,859
evaluations).  The port's eager loops pay the host for every evaluation
and read (and its Cauchy walk one read a breakpoint, 100 a step here), so
it stops where the JAX package's figures stop moving: primal-AL after
PRIMAL_AL_OUTER outer iterations, dual-AL after DUAL_AL_OUTER with at most
DUAL_AL_INNER inner iterations each.

Run:  python examples_torch/svm.py [--device cuda|cpu]
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
    ConstrainedProblem, default_stopping, minimize, objective)
from cppnumericalsolvers_tpu_torch.core.driver import (  # noqa: E402
    resolve_device)
from cppnumericalsolvers_tpu_torch.solvers import (  # noqa: E402
    AugmentedLagrangian,
    Lbfgs,
    Lbfgsb,
)
from examples_torch import _common  # noqa: E402

C = 1.0
SOLVES = ("primal-lbfgs", "primal-al", "dual-lbfgsb", "dual-al")
PRIMAL_AL_OUTER = 10
DUAL_AL_OUTER = 1
DUAL_AL_INNER = 20


def make_data(n_per_class=50, d=4, seed=0):
    """The original's data, as numpy arrays."""
    rng = np.random.default_rng(seed)
    mean = np.zeros(d)
    mean[0], mean[1] = 2.0, 1.0
    xa = rng.normal(size=(n_per_class, d)) + mean
    xb = rng.normal(size=(n_per_class, d)) - mean
    x = np.vstack([xa, xb])
    y = np.concatenate([np.ones(n_per_class), -np.ones(n_per_class)])
    return x, y


def accuracy(w, b, x, y) -> float:
    pred = np.sign(x @ w + b)
    return float(np.mean(pred == y))


def _bias(alpha, w, x, y) -> float:
    """b from the free support vectors (0 < alpha < C), or 0 without."""
    sv = np.where((alpha > 1e-4) & (alpha < C - 1e-4))[0]
    return float(np.mean(y[sv] - x[sv] @ w)) if len(sv) else 0.0


def solve(name: str, device=None) -> dict:
    """One formulation's solve; its figures with the hyperplane (w, b) and
    its accuracy."""
    dev = resolve_device(device)
    x_np, y_np = make_data()
    x = torch.from_numpy(x_np).to(dev)
    y = torch.from_numpy(y_np).to(dev)
    n, d = x_np.shape

    def dual_obj(alpha):  # minimize the negated dual
        return 0.5 * alpha @ gram @ alpha - torch.sum(alpha)

    gram = (y[:, None] * x) @ (y[:, None] * x).T
    extra = {}
    if name == "primal-lbfgs":
        # -- 1. smooth primal (squared hinge), plain L-BFGS -----------------
        def primal_obj(wb):
            w, b = wb[:d], wb[d]
            margins = y * (x @ w + b)
            hinge = torch.clamp(1.0 - margins, min=0.0)
            return 0.5 * torch.dot(w, w) + C * torch.sum(hinge ** 2)

        res = minimize(objective(primal_obj, mode="first"),
                       torch.zeros(d + 1, dtype=torch.float64), Lbfgs(),
                       device=dev)
    elif name == "primal-al":
        # -- 2. constrained primal via AL (d + 1 + n variables) -------------
        def primal_c_obj(z):
            w, xi = z[:d], z[d + 1:]
            return 0.5 * torch.dot(w, w) + C * torch.sum(xi ** 2)

        def margin_constraint(i):
            # y_i (w.x_i + b) - 1 + xi_i >= 0
            return objective(
                lambda z, i=i: (y[i] * (x[i] @ z[:d] + z[d]) - 1.0
                                + z[d + 1 + i]),
                mode="first",
            )

        problem = ConstrainedProblem(
            objective=objective(primal_c_obj, mode="first"),
            inequality_constraints=tuple(margin_constraint(i)
                                         for i in range(n)),
        )
        res = AugmentedLagrangian(inner_solver=Lbfgs()).minimize(
            problem, torch.zeros(d + 1 + n, dtype=torch.float64),
            stopping=default_stopping(torch.float64).replace(
                max_iterations=PRIMAL_AL_OUTER),
            device=dev)
    elif name == "dual-lbfgsb":
        # -- 3. no-bias dual with box via native L-BFGS-B -------------------
        res = minimize(objective(dual_obj, mode="first"),
                       torch.full((n,), 0.5, dtype=torch.float64),
                       Lbfgsb(lower=0.0, upper=C), device=dev)
    else:
        # -- 4. full dual: AL (equality sum alpha y = 0) + L-BFGS-B (box) ---
        dual_problem = ConstrainedProblem(
            objective=objective(dual_obj, mode="first"),
            equality_constraints=(
                objective(lambda a: torch.dot(a, y), mode="first"),
            ),
        )
        inner = Lbfgsb(lower=0.0, upper=C)
        res = AugmentedLagrangian(inner_solver=inner).minimize(
            dual_problem, torch.full((n,), 0.5, dtype=torch.float64),
            stopping=default_stopping(torch.float64).replace(
                max_iterations=DUAL_AL_OUTER),
            inner_stopping=inner.default_stopping(torch.float64).replace(
                max_iterations=DUAL_AL_INNER),
            device=dev)
    out = _common.figures(res)
    z = np.asarray(out["x"])
    if name.startswith("primal"):
        w, b = z[:d], float(z[d])
    else:
        w = (z * y_np) @ x_np
        b = _bias(z, w, x_np, y_np)
        extra["support_vectors"] = int((z > 1e-4).sum())
        extra["eq_violation"] = float(abs(np.dot(z, y_np)))
    out.update(w=w.tolist(), b=b, accuracy=accuracy(w, b, x_np, y_np),
               **extra)
    return out


def main(device=None) -> dict:
    out = {name: solve(name, device) for name in SOLVES}
    r1, r2, r3, r4 = (out[k] for k in SOLVES)
    print(f"primal-lbfgs : acc = {r1['accuracy']:.3f}  "
          f"f = {r1['f']:.4f}  nfev = {r1['nfev']}")
    print(f"primal-al    : acc = {r2['accuracy']:.3f}  "
          f"violation = {r2['max_violation']:.2e}")
    print(f"dual-lbfgsb  : acc = {r3['accuracy']:.3f}  "
          f"support vectors = {r3['support_vectors']}")
    print(f"dual-al      : acc = {r4['accuracy']:.3f}  "
          f"eq violation = {r4['eq_violation']:.2e}")
    for tag in SOLVES:
        assert out[tag]["accuracy"] >= 0.95, (tag, out[tag]["accuracy"])
    print("all four formulations separate the data (acc >= 0.95)")
    return out


if __name__ == "__main__":
    main(_common.parse_device(__doc__.splitlines()[0]).device)
