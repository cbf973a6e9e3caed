"""The port's unconstrained solvers against the JAX package's, batched.

Gradient descent, conjugate gradient, BFGS, Newton, trust-region Newton
(with the dense Hessian and Hessian-free), Nelder-Mead, and L-BFGS with the
Hager-Zhang and Armijo searches run the same numpy-seeded batch of starts
through ``cppnumericalsolvers_tpu.minimize_batched`` and the port's, in
float64 on the CPU, under the parity contract of ROADMAP.md:

* a 5-iteration budget: status, nfev and num_iterations exact on every
  lane, iterates, values and every float of the solver's internals within
  1e-12;
* full solves: per-lane status equal, mean nfev within 3, values within
  1e-6.

Outside the contract, measured on this file's batch of the pairwise
Rosenbrock (12 lanes, n = 6) and therefore solved here on a weighted
quadratic: gradient descent (conservative preset, 4,000-10,000 iterations a
lane) ends with 2 of 12 statuses different and mean nfev 641 apart, values
within 7.5e-9; conjugate gradient (2,765-51,233 evaluations a lane) with
statuses equal, mean nfev 0.2 apart, values 2.1e-5 apart.  Both follow the
Rosenbrock valley for thousands of steps, which amplify the last-bit
differences between XLA's sums (fused multiply-adds) and PyTorch's.

Also: BFGS's reset of a non-positive-definite or NaN inverse Hessian
(tests/test_fault_tolerance.py:85-118), the Hager-Zhang overflow recovery
inside an L-BFGS solve (:157-190), and a JAX solve cut at three iterations,
carried across by ``convert.from_jax_numpy`` and resumed in the port.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu import solvers as jsolvers
from cppnumericalsolvers_tpu.solvers.bfgs import (
    BfgsInternals as JaxBfgsInternals,
)
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.convert import from_jax_numpy
from cppnumericalsolvers_tpu_torch.core.tree import tree_map
from cppnumericalsolvers_tpu_torch.ops import flat_solve as fs
from cppnumericalsolvers_tpu_torch.ops import fused_step as fstep
from cppnumericalsolvers_tpu_torch.solvers.bfgs import BfgsInternals

torch.set_num_threads(1)

# name -> (class name, keyword arguments, objective mode, conservative)
SOLVERS = {
    "gd": ("GradientDescent", {}, "first", True),
    "cg": ("ConjugateGradientDescent", {}, "first", True),
    "bfgs": ("Bfgs", {}, "first", False),
    "newton": ("NewtonDescent", {}, "second", False),
    "tr": ("TrustRegionNewton", {}, "second", False),
    "tr_hessian_free": ("TrustRegionNewton", {"hessian_free": True},
                        "first", False),
    "nm": ("NelderMead", {}, "first", False),
    "lbfgs_hz": ("Lbfgs", {"line_search": "hager_zhang"}, "first", False),
    "lbfgs_armijo": ("Lbfgs", {"line_search": "armijo"}, "first", False),
}
# Solved on the weighted quadratic for their full solves (see above).
QUADRATIC_FULL = ("gd", "cg")


def jrosen(x):
    e, o = x[0::2], x[1::2]
    return jnp.sum(100.0 * (o - e**2) ** 2 + (1.0 - e) ** 2)


def trosen(x):
    e, o = x[0::2], x[1::2]
    return torch.sum(100.0 * (o - e**2) ** 2 + (1.0 - e) ** 2)


def jq2(x):
    return jnp.sum((x - 1.0) ** 2 * jnp.arange(1.0, x.shape[0] + 1))


def tq2(x):
    w = torch.arange(1.0, x.shape[0] + 1, dtype=x.dtype)
    return torch.sum((x - 1.0) ** 2 * w)


OBJECTIVES = {"rosenbrock": (jrosen, trosen), "quadratic": (jq2, tq2)}


def solvers(name):
    cls, kw, _, _ = SOLVERS[name]
    return getattr(jsolvers, cls)(**kw), getattr(cns, cls)(**kw)


def stoppings(name, **kw):
    jsolver, tsolver = solvers(name)
    if SOLVERS[name][3]:
        js = jcns.conservative_stopping(jnp.float64)
        ts = cns.conservative_stopping(torch.float64)
    else:
        js = jsolver.default_stopping(jnp.float64)
        ts = tsolver.default_stopping(torch.float64)
    return js.replace(**kw), ts.replace(**kw)


def objectives(name, which):
    mode = SOLVERS[name][2]
    jfn, tfn = OBJECTIVES[which]
    return jcns.objective(jfn, mode=mode), cns.objective(tfn, mode=mode)


def starts():
    return np.random.default_rng(3).uniform(-2.0, 2.0, (12, 6))


@functools.lru_cache(maxsize=None)
def solve_both(name, which, budget=0):
    jobj, tobj = objectives(name, which)
    jsolver, tsolver = solvers(name)
    kw = {"max_iterations": budget} if budget else {}
    js, ts = stoppings(name, **kw)
    x0 = starts()
    want = jcns.minimize_batched(jobj, jnp.asarray(x0), jsolver, js)
    got = cns.minimize_batched(tobj, torch.from_numpy(x0), tsolver, ts,
                               device="cpu")
    return want, got


def assert_close_tree(got, want, tol, skip=()):
    """Every float of ``got`` within ``tol`` of ``want`` (JAX's, carried
    across), every other leaf equal; the fields ``skip`` are left out."""
    want = from_jax_numpy(jax.tree.map(np.asarray, want))
    if isinstance(got, tuple):
        assert got == want == ()
        return
    for f in dataclasses.fields(got):
        if f.name in skip:
            continue
        a, b = getattr(got, f.name).numpy(), getattr(want, f.name).numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_five_iterations_are_exact(name):
    want, got = solve_both(name, "rosenbrock", 5)
    for field in ("status", "num_iterations"):
        np.testing.assert_array_equal(
            getattr(got.progress, field).numpy(),
            np.asarray(getattr(want.progress, field)), err_msg=field)
    np.testing.assert_array_equal(got.state.nfev.numpy(),
                                  np.asarray(want.state.nfev))
    for field in ("x", "value"):
        np.testing.assert_allclose(
            getattr(got.state, field).numpy(),
            np.asarray(getattr(want.state, field)), rtol=1e-12, atol=1e-12,
            err_msg=field)
    if not name.startswith("lbfgs"):
        # With the criterion off the port skips cond(H); the JAX package's
        # jitted solves compute it all the same (ROADMAP.md, C#10).
        assert_close_tree(got.internals, want.internals, 1e-12,
                          skip=("condition_hessian",))
    cond_h = getattr(got.internals, "condition_hessian", None)
    if cond_h is not None:
        assert not bool(cond_h.any())
    assert got.trips >= 5


@pytest.mark.parametrize("name", ["newton", "tr"])
def test_cond_h_from_the_solver_with_the_criterion_on(name):
    """With the Hessian-condition criterion on, Newton and trust region
    give cond(H) of their step's Hessian through their internals, the
    driver reads it from there (no extra evaluation), and the criterion
    stops the lanes whose Hessian is worse conditioned than the bound."""
    jobj, tobj = objectives(name, "rosenbrock")
    jsolver, tsolver = solvers(name)
    js, ts = stoppings(name, condition_hessian=3000.0, max_iterations=5)
    x0 = starts()
    want = jcns.minimize_batched(jobj, jnp.asarray(x0), jsolver, js)
    got = cns.minimize_batched(tobj, torch.from_numpy(x0), tsolver, ts,
                               device="cpu")
    np.testing.assert_array_equal(got.progress.status.numpy(),
                                  np.asarray(want.progress.status))
    np.testing.assert_array_equal(got.state.nfev.numpy(),
                                  np.asarray(want.state.nfev))
    fired = got.progress.status == int(cns.Status.HESSIAN_CONDITION_VIOLATION)
    assert 0 < int(fired.sum()) < fired.numel()
    assert_close_tree(got.internals, want.internals, 1e-9)
    np.testing.assert_allclose(got.progress.condition_hessian.numpy(),
                               np.asarray(want.progress.condition_hessian),
                               rtol=1e-9)


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_full_solves_meet_the_contract(name):
    which = "quadratic" if name in QUADRATIC_FULL else "rosenbrock"
    want, got = solve_both(name, which)
    np.testing.assert_array_equal(got.progress.status.numpy(),
                                  np.asarray(want.progress.status))
    assert abs(float(got.state.nfev.double().mean())
               - float(np.asarray(want.state.nfev).mean())) <= 3
    np.testing.assert_allclose(got.state.value.numpy(),
                               np.asarray(want.state.value), rtol=0,
                               atol=1e-6)
    assert bool(torch.isin(got.progress.status,
                           torch.tensor(cns.CONVERGED_STATUSES)).all())


@pytest.mark.parametrize("search", ["hager_zhang", "armijo"])
def test_lbfgs_searches_run_prologue_and_epilogue_never_flat_trip(
        search, monkeypatch):
    """Fresh L-BFGS solves with Hager-Zhang or Armijo take the
    iteration-granular loop: one prologue and one epilogue per iteration,
    no ``flat_trip``.  On the CPU the wrappers run their plain versions, so
    the counts come from shims that count calls as launches."""
    calls = {"flat_trip": 0, "lbfgs_prologue": 0, "lbfgs_epilogue": 0}

    def counting(name, fn):
        def shim(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return shim

    monkeypatch.setattr(fs, "flat_trip",
                        counting("flat_trip", fs.flat_trip))
    from cppnumericalsolvers_tpu_torch.solvers import lbfgs as lb
    for name in ("lbfgs_prologue", "lbfgs_epilogue"):
        monkeypatch.setattr(lb, name, counting(name, getattr(fstep, name)))
    x0 = torch.from_numpy(starts())
    res = cns.minimize_batched(cns.models.pairwise_rosenbrock(), x0,
                               cns.Lbfgs(line_search=search),
                               cns.default_stopping().replace(
                                   max_iterations=7), device="cpu")
    # The limit fires in the eighth iteration.
    iterations = int(res.progress.num_iterations.max())
    assert iterations == 8
    assert calls == {"flat_trip": 0, "lbfgs_prologue": iterations,
                     "lbfgs_epilogue": iterations}


@pytest.mark.parametrize("fill", [-1.0, float("nan")])
def test_bfgs_resets_a_bad_inverse_hessian(fill):
    """An inverse Hessian of -I (ascent directions) or NaN is reset to the
    identity (bfgs.h:84-92): the solve reaches the sphere's minimum, and
    ends as the JAX package's does from the same internals."""
    n = 2
    bad = np.eye(n) * fill if fill == -1.0 else np.full((n, n), fill)
    sphere_j = jcns.objective(lambda x: jnp.sum(x * x))
    sphere_t = cns.objective(lambda x: torch.sum(x * x))
    want = jcns.minimize(sphere_j, jnp.array([3.0, 4.0]), jsolvers.Bfgs(),
                         internals=JaxBfgsInternals(
                             inverse_hessian=jnp.asarray(bad),
                             fresh=jnp.zeros((), jnp.bool_)))
    got = cns.minimize(sphere_t, torch.tensor([3.0, 4.0],
                                              dtype=torch.float64),
                       cns.Bfgs(), internals=BfgsInternals(
                           inverse_hessian=torch.from_numpy(bad),
                           fresh=torch.zeros((), dtype=torch.bool)),
                       device="cpu")
    np.testing.assert_allclose(got.state.x.numpy(), [0.0, 0.0], atol=1e-5)
    assert int(got.progress.status) == int(want.progress.status)
    assert int(got.state.nfev) == int(want.state.nfev)
    np.testing.assert_allclose(got.state.x.numpy(), np.asarray(want.state.x),
                               rtol=1e-12, atol=1e-12)


def test_lbfgs_with_hager_zhang_recovers_from_overflow():
    """exp(10x) - 20x from 0: the first trial overflows to inf; the
    search's non-finite recovery (hager_zhang.h:342-355) shrinks back and
    the solve reaches ln(2)/10, as the JAX package's does."""
    want = jcns.minimize(
        jcns.objective(lambda x: jnp.exp(10.0 * x[0]) - 20.0 * x[0]),
        jnp.array([0.0]), jsolvers.Lbfgs(line_search="hager_zhang"))
    got = cns.minimize(
        cns.objective(lambda x: torch.exp(10.0 * x[0]) - 20.0 * x[0]),
        torch.tensor([0.0], dtype=torch.float64),
        cns.Lbfgs(line_search="hager_zhang"), device="cpu")
    assert float(got.state.x[0]) == pytest.approx(np.log(2.0) / 10.0,
                                                  abs=1e-5)
    assert int(got.progress.status) == int(want.progress.status)
    assert int(got.state.nfev) == int(want.state.nfev)
    np.testing.assert_allclose(float(got.state.x[0]),
                               float(want.state.x[0]), rtol=1e-12)


@pytest.mark.parametrize("name", ["gd", "cg", "bfgs", "newton", "tr",
                                  "tr_hessian_free", "nm"])
def test_jax_solve_cut_and_resumed_in_the_port(name):
    """A JAX solve cut at three iterations, carried across by
    ``from_jax_numpy`` (state, progress and the solver's internals) and
    resumed in the port, ends as the JAX package's resume of the same cut
    and, but for Nelder-Mead, as its uninterrupted solve.  A resumed plateau
    ring is one slot behind in both packages (ROADMAP.md, C#4), which moves
    Nelder-Mead's plateau stops (past = 5)."""
    which = "quadratic" if name in QUADRATIC_FULL else "rosenbrock"
    jobj, tobj = objectives(name, which)
    jsolver, tsolver = solvers(name)
    js, ts = stoppings(name)
    x0 = jnp.asarray(starts())
    cut = jcns.minimize_batched(jobj, x0, jsolver, js.replace(
        max_iterations=3))
    checkpoint = from_jax_numpy(jax.tree.map(np.asarray, cut))
    kept = tree_map(torch.clone, checkpoint)
    got = cns.resume(tobj, checkpoint, tsolver, ts, device="cpu")
    resumed = jax.vmap(lambda cp: jcns.resume(jobj, cp, jsolver, js))(cut)
    uninterrupted, _ = solve_both(name, which)
    for want in ([resumed] if name == "nm" else [resumed, uninterrupted]):
        np.testing.assert_array_equal(got.progress.status.numpy(),
                                      np.asarray(want.progress.status))
        assert abs(float(got.state.nfev.double().mean())
                   - float(np.asarray(want.state.nfev).mean())) <= 3
        np.testing.assert_allclose(got.state.value.numpy(),
                                   np.asarray(want.state.value), rtol=0,
                                   atol=1e-6)
    # The checkpoint is not changed.
    assert torch.equal(checkpoint.state.x, kept.state.x)
    assert torch.equal(checkpoint.progress.status, kept.progress.status)


def test_newton_with_a_singular_shifted_hessian_goes_non_finite_as_jax():
    """H = diag(-1e-5, 2): the shifted Hessian H + 1e-5 I is singular.  The
    batched solve (``torch.linalg.solve_ex``, which does not raise) gives an
    infinite direction as ``jnp.linalg.solve`` does, and the solve runs on
    to its iteration limit on non-finite iterates with the JAX package's
    statuses and nfev."""
    def jf(x):
        return -0.5e-5 * x[0] ** 2 + x[1] ** 2

    def tf(x):
        return -0.5e-5 * x[0] ** 2 + x[1] ** 2

    x0 = np.array([[1.0, 1.0], [0.0, 1.0], [2.0, -3.0]])
    want = jcns.minimize_batched(
        jcns.objective(jf, mode="second"), jnp.asarray(x0),
        jsolvers.NewtonDescent(),
        jcns.default_stopping(jnp.float64).replace(max_iterations=3))
    got = cns.minimize_batched(
        cns.objective(tf, mode="second"), torch.from_numpy(x0),
        cns.NewtonDescent(),
        cns.default_stopping(torch.float64).replace(max_iterations=3),
        device="cpu")
    np.testing.assert_array_equal(got.progress.status.numpy(),
                                  np.asarray(want.progress.status))
    np.testing.assert_array_equal(got.state.nfev.numpy(),
                                  np.asarray(want.state.nfev))
    np.testing.assert_array_equal(np.isfinite(got.state.x.numpy()),
                                  np.isfinite(np.asarray(want.state.x)))
    assert not np.isfinite(got.state.x.numpy()).any()
