"""examples_torch/svm.py against the JAX package's examples/svm.py, on the
CPU.

The JAX example runs in a process of its own (tests/torch_examples.py)
while the port's ``main("cpu")`` runs here.  The port runs the two AL
formulations to a budget (examples_torch/svm.py says why); the JAX
example's own AL solves, run as it is, spin to their limits for minutes
after their figures stop moving, so it runs with its two
``AugmentedLagrangian.minimize`` calls cut to the port's budgets and
nothing else changed.  Its printed figures hold the port's: every
formulation's accuracy; primal-L-BFGS's f and nfev; dual-L-BFGS-B's
support vectors; the AL formulations' violations.  The AL solves are also
held against the JAX package's same solves, run meanwhile in two more
processes (this file run as a script, :data:`JAX_SOLVES`): outer iterations,
status and nfev exactly, x within 1e-11, at a short budget of 3 outer
iterations (primal) and at the example's budget (the dual, against the
JAX package's eager run: see its test); at the primal's 10 outer
iterations a last bit grows with the penalty (x 2.2e-10 apart at 5 outer
iterations, 1.7e-8 at 10), so there nfev is held within 1, x within 1e-7
and the violation within 1% of the JAX example's printed one.
"""

import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu.solvers import AugmentedLagrangian as JaxAL
from cppnumericalsolvers_tpu.solvers import Lbfgs as JaxLbfgs
from cppnumericalsolvers_tpu.solvers import Lbfgsb as JaxLbfgsb
from examples_torch import svm

import torch_examples as tex

torch.set_num_threads(1)
PRIMAL_SHORT = 3


#: The JAX package's AL solves the tests hold the port's to: (formulation,
#: outer budget, inner budget, eager).
JAX_SOLVES = {
    "primal-short": ("primal-al", PRIMAL_SHORT, 0, False),
    "primal": ("primal-al", svm.PRIMAL_AL_OUTER, 0, False),
    "dual": ("dual-al", svm.DUAL_AL_OUTER, svm.DUAL_AL_INNER, True),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's figures, the budgeted JAX example's printed text, and the
    JAX package's AL solves of :data:`JAX_SOLVES`, all run at once."""
    where = str(tmp_path_factory.mktemp("svm"))
    procs = [
        tex.start_jax_example("svm", al_budgets={
            "Lbfgs": (svm.PRIMAL_AL_OUTER, 0),
            "Lbfgsb": (svm.DUAL_AL_OUTER, svm.DUAL_AL_INNER)}),
        tex.start_script(__file__, where, "primal-short", "primal"),
        tex.start_script(__file__, where, "dual"),
    ]
    port = svm.main("cpu")
    text = tex.finish(procs[0])
    for proc in procs[1:]:
        tex.finish(proc)
    solves = {key: dict(np.load(os.path.join(where, f"{key}.npz")))
              for key in JAX_SOLVES}
    return port, text, {key: {k: v if k == "x" else v.item()
                              for k, v in r.items()}
                        for key, r in solves.items()}


def jax_al(name, outer, inner=0):
    """The JAX package's AL formulation ``name`` of examples/svm.py on its
    data, cut at ``outer`` outer and ``inner`` inner iterations."""
    x_np, y_np = svm.make_data()
    x, y = jnp.asarray(x_np), jnp.asarray(y_np)
    n, d = x_np.shape
    stop = jcns.default_stopping(jnp.float64).replace(max_iterations=outer)
    if name == "primal-al":
        def primal_c_obj(z):
            w, xi = z[:d], z[d + 1:]
            return 0.5 * jnp.vdot(w, w) + svm.C * jnp.sum(xi ** 2)

        cons = tuple(jcns.objective(
            lambda z, i=i: y[i] * (x[i] @ z[:d] + z[d]) - 1.0 + z[d + 1 + i],
            mode="first") for i in range(n))
        problem = jcns.ConstrainedProblem(
            objective=jcns.objective(primal_c_obj, mode="first"),
            inequality_constraints=cons)
        res = JaxAL(inner_solver=JaxLbfgs()).minimize(
            problem, jnp.zeros(d + 1 + n), stopping=stop)
    else:
        gram = (y[:, None] * x) @ (y[:, None] * x).T
        problem = jcns.ConstrainedProblem(
            objective=jcns.objective(
                lambda a: 0.5 * a @ gram @ a - jnp.sum(a), mode="first"),
            equality_constraints=(
                jcns.objective(lambda a: jnp.vdot(a, y), mode="first"),))
        inner_solver = JaxLbfgsb(lower=0.0, upper=svm.C)
        res = JaxAL(inner_solver=inner_solver).minimize(
            problem, jnp.full(n, 0.5), stopping=stop,
            inner_stopping=inner_solver.default_stopping(
                jnp.float64).replace(max_iterations=inner))
    return {"x": np.asarray(res.state.x), "nfev": int(res.state.nfev),
            "iterations": int(res.progress.num_iterations),
            "status": int(res.progress.status),
            "max_violation": float(res.state.max_violation)}


@pytest.mark.parametrize("name", svm.SOLVES)
def test_accuracy_matches_jax(runs, name):
    port, text, _ = runs
    acc = tex.numbers(tex.line_with(text, name).split("acc =")[1])[0]
    assert tex.printed_close(port[name]["accuracy"], acc)
    assert port[name]["accuracy"] >= 0.95


def test_primal_lbfgs_matches_jax(runs):
    port, text, _ = runs
    line = tex.line_with(text, "primal-lbfgs")
    f = tex.numbers(line.split("f =")[1])[0]
    nfev = tex.numbers(line.split("nfev =")[1])[0]
    assert tex.printed_close(port["primal-lbfgs"]["f"], f)
    assert port["primal-lbfgs"]["nfev"] == int(nfev)


def test_dual_lbfgsb_matches_jax(runs):
    port, text, _ = runs
    line = tex.line_with(text, "dual-lbfgsb")
    sv = tex.numbers(line.split("support vectors =")[1])[0]
    assert port["dual-lbfgsb"]["support_vectors"] == int(sv)


def same_solve(got, want, xtol):
    for key in ("iterations", "status", "nfev"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=xtol)


def test_primal_al_short_budget_is_exact(runs):
    old = svm.PRIMAL_AL_OUTER
    svm.PRIMAL_AL_OUTER = PRIMAL_SHORT
    try:
        got = svm.solve("primal-al", "cpu")
    finally:
        svm.PRIMAL_AL_OUTER = old
    same_solve(got, runs[2]["primal-short"], 1e-11)


def test_primal_al_at_the_example_budget(runs):
    port, text, solves = runs
    got = port["primal-al"]
    want = solves["primal"]
    assert got["iterations"] == want["iterations"]
    assert got["status"] == want["status"]
    assert abs(got["nfev"] - want["nfev"]) <= 1
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-7)
    viol = float(tex.numbers(tex.line_with(text, "primal-al")
                             .split("violation =")[1])[0])
    assert abs(got["max_violation"] - viol) <= 0.01 * viol


def test_dual_al_at_the_example_budget(runs):
    """Held against the JAX package's solve run eagerly: jitted, XLA's
    fusions move a roundoff-level decision of the warm-up inner solve (19
    evaluations jitted against 17 eager), and the port computes the
    package's arithmetic as written.  Iterations, status and nfev exact, x
    within 1e-10 (2.8e-11 measured)."""
    port, text, solves = runs
    got = port["dual-al"]
    same_solve(got, solves["dual"], 1e-10)
    eqv = tex.numbers(tex.line_with(text, "dual-al")
                      .split("eq violation =")[1])[0]
    assert tex.printed_close(got["eq_violation"], eqv)


if __name__ == "__main__":
    # python tests/test_torch_examples_svm.py DIR KEY...: the JAX solves of
    # JAX_SOLVES named, each saved to DIR/KEY.npz.
    for key in sys.argv[2:]:
        name, outer, inner, eager = JAX_SOLVES[key]
        with jax.disable_jit() if eager else contextlib.nullcontext():
            np.savez(os.path.join(sys.argv[1], f"{key}.npz"),
                     **jax_al(name, outer, inner))
