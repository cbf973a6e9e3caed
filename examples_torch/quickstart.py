"""Quick-start: minimize f(x) = 5 x0^2 + 100 x1^2 + 5 from (-10, 2).

PyTorch counterpart of examples/quickstart.py (the reference's
src/examples/simple.cc:1-90): the same quadratic solved with every solver of
the suite, printing argmin / f / iterations / nfev / status.  On the card
L-BFGS takes the flat solve (one ``flat_trip`` launch a trip), gradient
descent, BFGS and L-BFGS-B their More-Thuente search (one ``mt_trip``
launch a trip); the others launch no kernel.

Run:  python examples_torch/quickstart.py [--device cuda|cpu] [solver]
      solver in {gd, cg, newton, bfgs, lbfgs, lbfgsb, tr, nm, all}
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import torch  # noqa: E402

from cppnumericalsolvers_tpu_torch import (  # noqa: E402
    minimize, objective, status_message)
from cppnumericalsolvers_tpu_torch.solvers import (  # noqa: E402
    Bfgs,
    ConjugateGradientDescent,
    GradientDescent,
    Lbfgs,
    Lbfgsb,
    NelderMead,
    NewtonDescent,
    TrustRegionNewton,
)

SOLVERS = {
    "gd": GradientDescent(),
    "cg": ConjugateGradientDescent(),
    "newton": NewtonDescent(),
    "bfgs": Bfgs(),
    "lbfgs": Lbfgs(),
    "lbfgsb": Lbfgsb(),
    "tr": TrustRegionNewton(),
    "nm": NelderMead(),
}
from examples_torch import _common  # noqa: E402


def solve(name: str, device=None) -> dict:
    """One solver's solve of the quadratic; its figures."""
    # Second-mode objective: every solver (incl. Newton/TR) can consume it.
    f = objective(
        lambda x: 5.0 * x[0] ** 2 + 100.0 * x[1] ** 2 + 5.0, mode="second"
    )
    x0 = torch.tensor([-10.0, 2.0], dtype=torch.float64)
    return _common.figures(minimize(f, x0, SOLVERS[name], device=device))


def main(device=None, which: str = "all") -> dict:
    names = list(SOLVERS) if which == "all" else [which]
    out = {}
    for name in names:
        r = out[name] = solve(name, device)
        x = r["x"]
        print(
            f"{name:7s} argmin = ({x[0]: .3e}, {x[1]: .3e})"
            f"  f = {r['f']:.6f}"
            f"  iters = {r['iterations']}"
            f"  nfev = {r['nfev']}"
            f"  [{status_message(r['status'])}]"
        )
        assert abs(r["f"] - 5.0) < 1e-4, name
    return out


if __name__ == "__main__":
    args = _common.parse_device(
        __doc__.splitlines()[0],
        lambda p: p.add_argument("solver", nargs="?", default="all"))
    main(args.device, args.solver)
