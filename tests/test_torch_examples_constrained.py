"""examples_torch/linear_regression.py and constrained.py against the JAX
package's examples, on the CPU (each JAX example runs as it is, in a
process of its own: tests/torch_examples.py).

linear_regression is float32, as its original: the three fits' w to the
printed four decimals within the example's own 5e-3, the pinned
coordinates exactly, and the statuses of the two solves that are not AL
against the JAX package's same solves.  constrained is float64: x and the
multipliers to their printed precision, the violation to its printed
digits, the outer iterations and the status exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu.solvers import Lbfgs as JaxLbfgs
from cppnumericalsolvers_tpu.solvers import Lbfgsb as JaxLbfgsb
from cppnumericalsolvers_tpu_torch import status_message
from examples_torch import constrained, linear_regression

import torch_examples as tex

torch.set_num_threads(1)
W_TOL = 5e-3


@pytest.fixture(scope="module")
def runs():
    procs = {name: tex.start_jax_example(name)
             for name in ("linear_regression", "constrained")}
    port = {"linear_regression": linear_regression.main("cpu"),
            "constrained": constrained.main("cpu")}
    return port, {name: tex.finish(p) for name, p in procs.items()}


@pytest.mark.parametrize("solve,prefix", [
    ("free", "unconstrained  w ="), ("lbfgsb", "lbfgsb box     w ="),
    ("al", "al box         w =")])
def test_regression_w_matches_jax(runs, solve, prefix):
    port, text = runs
    printed = tex.numbers(tex.line_with(text["linear_regression"], prefix))
    got = port["linear_regression"][solve]["x"]
    assert len(printed) == 2
    for v, p in zip(got, printed):
        assert abs(v - float(p)) <= W_TOL, (solve, v, p)


def test_regression_pinned_coordinates_match_jax(runs):
    port, text = runs
    line = tex.line_with(text["linear_regression"], "both box solvers agree")
    want = [int(v) for v in tex.numbers(line.split(":")[1])]
    w_box = np.asarray(port["linear_regression"]["lbfgsb"]["x"])
    pinned = np.where((w_box < linear_regression.LOWER + 1e-3)
                      | (w_box > linear_regression.UPPER - 1e-3))[0]
    assert pinned.tolist() == want


@pytest.mark.parametrize("solve", ["free", "lbfgsb"])
def test_regression_status_matches_jax(runs, solve):
    """The float32 solves that are not AL: the JAX package's status on the
    same data and start."""
    port, _ = runs
    a, y = linear_regression.data()
    aj, yj = jnp.asarray(a), jnp.asarray(y)
    ls = jcns.objective(
        lambda w: jnp.sum((aj @ w - yj) ** 2) / linear_regression.N_SAMPLES,
        mode="first")
    if solve == "free":
        res = jcns.minimize(ls, jnp.zeros(2, jnp.float32), JaxLbfgs())
    else:
        res = jcns.minimize(ls, jnp.full(2, 0.5, jnp.float32),
                            JaxLbfgsb(lower=0.0, upper=1.0))
    got = port["linear_regression"][solve]
    assert got["status"] == int(res.progress.status)
    np.testing.assert_allclose(got["x"], np.asarray(res.state.x),
                               rtol=0, atol=W_TOL)


@pytest.mark.parametrize("name,prefix", [("quadratic", "eq+ineq quadratic"),
                                         ("circle", "linear on circle")])
def test_constrained_matches_jax(runs, name, prefix):
    port, text = runs
    line = tex.line_with(text["constrained"], prefix)
    got = port["constrained"][name]
    x_part = line.split("x =")[1].split("(expect")[0]
    for v, p in zip(got["x"], tex.numbers(x_part)):
        assert tex.printed_close(v, p), (v, p)
    viol = tex.numbers(line.split("violation =")[1])[0]
    assert tex.printed_close(got["max_violation"], viol)
    outer = tex.numbers(line.split("outer iters =")[1])[0]
    assert got["iterations"] == int(outer)
    assert line.rstrip().endswith(f"[{status_message(got['status'])}]")


def test_constrained_multipliers_match_jax(runs):
    port, text = runs
    line = tex.line_with(text["constrained"], "multipliers:")
    lam, mu = line.split("lambda =")[1].split("mu =")
    got = port["constrained"]["quadratic"]
    for v, p in zip(got["equality_multipliers"], tex.numbers(lam)):
        assert tex.printed_close(v, p), (v, p)
    for v, p in zip(got["inequality_multipliers"], tex.numbers(mu)):
        assert tex.printed_close(v, p), (v, p)
