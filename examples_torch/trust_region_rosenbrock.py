"""Trust-region Newton on Rosenbrock with live radius dynamics.

PyTorch counterpart of examples/trust_region_rosenbrock.py (the reference's
src/examples/trust_region_newton_rosenbrock.cc:1-78): a per-iteration
callback prints the iterate's progress, and the trace buffer records the
same history on the device.  The trust region launches no kernel.

Run:  python examples_torch/trust_region_rosenbrock.py [--device cuda|cpu]
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
    TrustRegionNewton)

from examples_torch import _common  # noqa: E402


def solve(name: str = "tr", device=None) -> dict:
    """The traced solve, printing each iteration; its figures, with the
    iterations the trace recorded and the callback's lines."""
    del name
    rosen = objective(
        lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2,
        mode="second",
    )
    lines = []

    def live(info):
        lines.append((int(info["num_iterations"]), float(info["value"]),
                      float(info["gradient_norm"])))
        print(
            f"  iter {lines[-1][0]:3d}"
            f"  f = {lines[-1][1]: .6e}"
            f"  |g|inf = {lines[-1][2]:.3e}"
        )

    result = minimize(
        rosen, torch.tensor([-3.0, -4.0], dtype=torch.float64),
        TrustRegionNewton(), callback=live, trace=128, device=device,
    )
    out = _common.figures(result)
    out["recorded"] = int((result.trace.status >= 0).sum())
    out["callback"] = lines
    return out


def main(device=None) -> dict:
    r = solve("tr", device)
    x = r["x"]
    print(
        f"argmin = [{x[0]:.8f} {x[1]:.8f}]"
        f"  f = {r['f']:.3e}"
        f"  iters = {r['iterations']}"
        f"  [{status_message(r['status'])}]"
    )
    # The device-side trace holds the same history:
    print(f"trace buffer recorded {r['recorded']} iterations device-side")
    assert r["f"] < 1e-9
    return {"tr": r}


if __name__ == "__main__":
    main(_common.parse_device(__doc__.splitlines()[0]).device)
