"""examples_torch/quickstart.py and trust_region_rosenbrock.py against the
JAX package's examples, on the CPU.

Both JAX examples run as they are in processes of their own (see
tests/torch_examples.py).  Every quick-start solver: the status message,
iterations and nfev exact, f and the argmin to their printed precision
(an argmin at roundoff, 1e-19, within 1e-12).  The trust region: every
iteration its callback prints (iteration, f, |g|inf), the argmin, f, the
iterations and the status, and the trace's count.
"""

import numpy as np
import pytest
import torch

from cppnumericalsolvers_tpu_torch import status_message
from examples_torch import quickstart, trust_region_rosenbrock

import torch_examples as tex

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    procs = {name: tex.start_jax_example(name)
             for name in ("quickstart", "trust_region_rosenbrock")}
    port = {"quickstart": quickstart.main("cpu"),
            "trust_region_rosenbrock": trust_region_rosenbrock.main("cpu")}
    jax_out = {name: tex.finish(p) for name, p in procs.items()}
    return port, jax_out


@pytest.mark.parametrize("name", list(quickstart.SOLVERS))
def test_quickstart_solver_matches_jax(runs, name):
    port, jax_out = runs
    line = tex.line_with(jax_out["quickstart"], f"{name} ")
    x0, x1, f, iters, nfev = tex.numbers(line.split("argmin")[1])[:5]
    got = port["quickstart"][name]
    assert line.rstrip().endswith(f"[{status_message(got['status'])}]")
    assert got["iterations"] == int(iters)
    assert got["nfev"] == int(nfev)
    assert tex.printed_close(got["f"], f)
    for v, p in zip(got["x"], (x0, x1)):
        assert tex.printed_close(v, p, tex.X_ATOL), (v, p)


def test_trust_region_matches_jax(runs):
    port, jax_out = runs
    text = jax_out["trust_region_rosenbrock"]
    got = port["trust_region_rosenbrock"]["tr"]
    lines = [ln for ln in text.splitlines() if ln.lstrip().startswith("iter")]
    assert len(lines) == len(got["callback"])
    for ln, (it, f, g) in zip(lines, got["callback"]):
        p_it, p_f, p_g = tex.numbers(ln)
        assert it == int(p_it)
        assert tex.printed_close(f, p_f)
        assert tex.printed_close(g, p_g)
    last = tex.line_with(text, "argmin")
    x0, x1, f, iters = tex.numbers(last)[:4]
    assert got["iterations"] == int(iters)
    assert tex.printed_close(got["f"], f)
    for v, p in zip(got["x"], (x0, x1)):
        assert tex.printed_close(v, p)
    assert last.rstrip().endswith(f"[{status_message(got['status'])}]")
    recorded = tex.numbers(tex.line_with(text, "trace buffer"))[0]
    assert got["recorded"] == int(recorded)


def test_quickstart_figures_are_finite(runs):
    port, _ = runs
    for name, r in port["quickstart"].items():
        assert np.isfinite(r["x"]).all() and np.isfinite(r["f"]), name
