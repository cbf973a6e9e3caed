"""Objective composition tour.

PyTorch counterpart of examples/expressions_tour.py (the reference's
src/examples/debug.cc:1-302, the expression-template tour): arithmetic on
objectives, mode propagation, the min/max-zero clamps, and the penalty and
augmented-Lagrangian composites evaluated at hand-checkable points.  Plain
PyTorch evaluations on the device: no solve, no kernel.

Run:  python examples_torch/expressions_tour.py [--device cuda|cpu]
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import torch  # noqa: E402

from cppnumericalsolvers_tpu_torch import (  # noqa: E402
    ConstrainedProblem,
    MultiplierState,
    augmented_lagrangian_value,
    constant,
    max_zero,
    min_zero,
    objective,
    to_penalty,
)
from cppnumericalsolvers_tpu_torch.core.driver import (  # noqa: E402
    resolve_device)
from examples_torch import _common  # noqa: E402

def _list(t):
    return t.detach().cpu().tolist()


def main(device=None) -> dict:
    dev = resolve_device(device)

    def vec(*values):
        return torch.tensor(values, dtype=torch.float64, device=dev)

    x = vec(1.0, 2.0)
    out = {}

    # -- arithmetic on objectives (function_expressions.h:401-518 analog) ---
    f = objective(lambda v: v[0] ** 2 + v[1] ** 2, mode="second")
    g = objective(lambda v: v[0] * v[1], mode="second")

    combo = 2.0 * f + g - constant(3.0)
    out["f"] = float(f.fn(x))
    out["g"] = float(g.fn(x))
    out["combo"] = float(combo.fn(x))
    out["combo_grad"] = _list(combo.gradient(x))
    out["combo_hessian"] = _list(combo.hessian(x))
    print("f(x) =", out["f"])  # 5
    print("g(x) =", out["g"])  # 2
    print("(2f + g - 3)(x) =", out["combo"])  # 9
    print("grad:", out["combo_grad"])  # [6, 9]
    print("hessian:\n", out["combo_hessian"])

    prod = f * g  # product rule propagates through autodiff
    out["prod"] = float(prod.fn(x))
    out["prod_grad"] = _list(prod.gradient(x))
    print("(f*g)(x) =", out["prod"], " grad:", out["prod_grad"])

    # Mode is the min of the operands (function_expressions.h:74-88):
    h_first = objective(lambda v: torch.sum(torch.abs(v) ** 1.5),
                        mode="first")
    out["mode"] = (f * h_first).mode
    print("mode of second*first product:", out["mode"])

    # -- one-sided clamps (function_expressions.h:317-399) ------------------
    c = objective(lambda v: v[0] - 1.5, mode="second")
    out["min_zero"] = float(min_zero(c).fn(x))
    out["max_zero"] = float(max_zero(c).fn(x))
    out["max_zero_grad"] = _list(max_zero(c).gradient(vec(2.0, 0.0)))
    print("min(0, c)(x) =", out["min_zero"])  # -0.5
    print("max(0, c)(x) =", out["max_zero"])  # 0
    print("d/dx max(0,c) at active side:", out["max_zero_grad"])

    # -- penalty / augmented-Lagrangian composites (function_penalty.h) -----
    problem = ConstrainedProblem(
        objective=f,
        equality_constraints=(
            objective(lambda v: v[0] + v[1] - 2.0, mode="second"),),
        inequality_constraints=(
            objective(lambda v: v[0] - 0.5, mode="second"),),
    )
    rho = 10.0
    out["penalty"] = float(to_penalty(problem, rho).fn(x))
    print("pure-penalty composite at x:", out["penalty"])

    multipliers = MultiplierState(equality=vec(0.5), inequality=vec(1.0))
    out["augmented_lagrangian"] = float(
        augmented_lagrangian_value(problem, x, multipliers, rho))
    # Hand-check: f=5, eq c=1 -> +lambda*c + rho/2 c^2 = .5 + 5;
    # ineq g=0.5, mu-rho*g = 1-5 < 0 -> PHR inactive side: -mu^2/(2 rho)
    print("augmented Lagrangian at x:", out["augmented_lagrangian"],
          "(expect 10.45)")
    assert abs(out["augmented_lagrangian"] - 10.45) < 1e-12
    return out


if __name__ == "__main__":
    main(_common.parse_device(__doc__.splitlines()[0]).device)
