"""The cases of tests/test_trust_region.py through the port's trust-region
Newton, against the JAX package's.

Each case runs in float64 on the CPU through both packages and must pass
the reference's own assertions (src/test/trust_region_newton_test.cc) and
end as the JAX package's solve does: the same status, num_iterations and
nfev, iterates within 1e-10.  The first accepted step is probed by calling
``TrustRegionNewton.step`` on a batch of one.  Both forms run: with the
dense Hessian and Hessian-free (``Objective.hvp`` inside the CG loop).  The
CG-Steihaug subproblem solver is also held lane by lane to the JAX
package's ``solve_tr_subproblem`` on a batch whose lanes leave its loop at
different passes (boundary, negative curvature, convergence).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu.solvers import TrustRegionNewton as JaxTr
from cppnumericalsolvers_tpu.solvers import (
    solve_tr_subproblem as jax_subproblem,
)
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.solvers import solve_tr_subproblem

torch.set_num_threads(1)

OBJECTIVES = {
    # f = 3 x0^2 + 10 x1^2 (trust_region_newton_test.cc:46-60).
    "convex": (lambda x: 3.0 * x[0] ** 2 + 10.0 * x[1] ** 2,) * 2,
    # f = 0.5 (x0^2 - x1^2), indefinite (:95-111).
    "indefinite": (lambda x: 0.5 * (x[0] ** 2 - x[1] ** 2),) * 2,
    # f = (x^2 - 2)^2 (:113-128).
    "double_well": (lambda x: (x[0] ** 2 - 2.0) ** 2,) * 2,
    "rosenbrock": (
        lambda x: (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2,
    ) * 2,
}
FORMS = [False, True]  # hessian_free


def objectives(name, hessian_free):
    jfn, tfn = OBJECTIVES[name]
    mode = "first" if hessian_free else "second"
    return jcns.objective(jfn, mode=mode), cns.objective(tfn, mode=mode)


def solve(name, x0, hessian_free, stop=None, **kw):
    jobj, tobj = objectives(name, hessian_free)
    stop = stop or {}
    want = jcns.minimize(
        jobj, jnp.asarray(x0, jnp.float64),
        JaxTr(hessian_free=hessian_free, **kw),
        jcns.default_stopping(jnp.float64).replace(**stop))
    got = cns.minimize(
        tobj, torch.tensor(x0, dtype=torch.float64),
        cns.TrustRegionNewton(hessian_free=hessian_free, **kw),
        cns.default_stopping(torch.float64).replace(**stop), device="cpu")
    assert int(got.progress.status) == int(want.progress.status)
    assert int(got.progress.num_iterations) == int(
        want.progress.num_iterations)
    assert int(got.state.nfev) == int(want.state.nfev)
    np.testing.assert_allclose(got.state.x.numpy(), np.asarray(want.state.x),
                               rtol=1e-10, atol=1e-10)
    return got


def first_step(name, x0, hessian_free, **kw):
    jobj, tobj = objectives(name, hessian_free)
    jsolver = JaxTr(hessian_free=hessian_free, **kw)
    tsolver = cns.TrustRegionNewton(hessian_free=hessian_free, **kw)
    jstate = jobj.evaluate(jnp.asarray(x0, jnp.float64), nfev=0)
    jnew, _ = jsolver.step(jobj, jstate, jsolver.init(jobj, jstate),
                           jcns.default_stopping(jnp.float64))
    tstate = tobj.evaluate(torch.tensor([x0], dtype=torch.float64))
    tnew, internals, _ = tsolver.step(
        tobj, tstate, tsolver.init_batched(tobj, tstate),
        cns.default_stopping(torch.float64))
    np.testing.assert_allclose(tnew.x[0].numpy(), np.asarray(jnew.x),
                               rtol=1e-12, atol=1e-12)
    assert int(tnew.nfev[0]) == int(jnew.nfev)
    return np.asarray(x0), tnew.x[0].numpy()


# -- Section A: basic convergence ------------------------------------------


@pytest.mark.parametrize("hessian_free", FORMS)
def test_strictly_convex_quadratic_converges_quickly(hessian_free):
    res = solve("convex", [5.0, 5.0], hessian_free)
    np.testing.assert_allclose(res.state.x.numpy(), [0.0, 0.0], atol=1e-8)
    assert int(res.progress.num_iterations) <= 10


@pytest.mark.parametrize("hessian_free", FORMS)
def test_rosenbrock_converges_from_standard_start(hessian_free):
    res = solve("rosenbrock", [-1.2, 1.0], hessian_free)
    np.testing.assert_allclose(res.state.x.numpy(), [1.0, 1.0], atol=1e-5)
    assert int(res.progress.num_iterations) < 80


# -- Section B: CG-Steihaug branch coverage --------------------------------


@pytest.mark.parametrize("hessian_free", FORMS)
def test_trust_region_boundary_exit_respects_radius(hessian_free):
    # From (5, 5) the Newton step is longer than 0.5: the first accepted
    # step lands on the initial radius (:191-212).
    x0, x1 = first_step("convex", [5.0, 5.0], hessian_free,
                        initial_radius=0.5)
    assert np.linalg.norm(x1 - x0) == pytest.approx(0.5, abs=1e-10)


@pytest.mark.parametrize("hessian_free", FORMS)
def test_indefinite_hessian_negative_curvature_step_is_bounded(hessian_free):
    x0, x1 = first_step("indefinite", [0.1, 0.5], hessian_free,
                        initial_radius=1.0)
    step_norm = np.linalg.norm(x1 - x0)
    assert 0.0 < step_norm <= 1.0 + 1e-10
    assert np.isfinite(x1).all()


@pytest.mark.parametrize("hessian_free", FORMS)
def test_interior_newton_step_reaches_closed_form_minimiser(hessian_free):
    res = solve("convex", [1.0, 1.0], hessian_free, {"gradient_norm": 1e-12},
                initial_radius=100.0)
    np.testing.assert_allclose(res.state.x.numpy(), [0.0, 0.0], atol=1e-10)
    assert int(res.progress.num_iterations) <= 3


# -- Section C: radius invariants ------------------------------------------


@pytest.mark.parametrize("hessian_free", FORMS)
def test_quartic_double_well_converges_despite_degenerate_start(
        hessian_free):
    res = solve("double_well", [0.1], hessian_free,
                {"gradient_norm": 1e-10, "max_iterations": 100},
                initial_radius=0.5)
    assert abs(float(res.state.x[0])) == pytest.approx(math.sqrt(2.0),
                                                       abs=1e-6)
    assert int(res.progress.num_iterations) < 50


@pytest.mark.parametrize("hessian_free", FORMS)
def test_max_radius_cap_is_enforced(hessian_free):
    res = solve("convex", [100.0, -100.0], hessian_free,
                {"gradient_norm": 1e-10, "max_iterations": 200},
                initial_radius=0.5, max_radius=2.0)
    np.testing.assert_allclose(res.state.x.numpy(), [0.0, 0.0], atol=1e-8)
    assert int(res.progress.num_iterations) < 150


# -- Section D: stopping plumbing ------------------------------------------


def test_gradient_norm_stop_fires():
    res = solve("convex", [3.0, 3.0], False,
                {"gradient_norm": 1e-4, "max_iterations": 100})
    assert int(res.progress.status) == int(cns.Status.GRADIENT_NORM_VIOLATION)
    assert int(res.progress.num_iterations) < 10


def test_iteration_limit_stop_fires():
    res = solve("rosenbrock", [-1.2, 1.0], False,
                {"max_iterations": 1, "gradient_norm": 1e-16})
    assert int(res.progress.status) == int(cns.Status.ITERATION_LIMIT)


# -- The subproblem solver, lane by lane -------------------------------------


def test_subproblem_lanes_leave_the_cg_loop_at_their_own_pass():
    rng = np.random.default_rng(7)
    b, n = 6, 5
    g = rng.normal(size=(b, n))
    a = rng.normal(size=(b, n, n))
    h = np.einsum("bij,bkj->bik", a, a) + 0.1 * np.eye(n)
    h[1] -= 3.0 * np.eye(n)  # indefinite: a negative-curvature exit
    radius = np.array([0.05, 10.0, 10.0, 1.0, 1e3, 0.5])
    tol = np.array([1e-8, 1e-8, 1e-3, 1e-8, 1e-10, 1e-8])
    g[5] = 1e-12  # trivially done before the loop
    tp, thit = solve_tr_subproblem(
        torch.from_numpy(g),
        lambda v: torch.einsum("bij,bj->bi", torch.from_numpy(h), v),
        torch.from_numpy(radius), torch.from_numpy(tol), n + 10)
    for k in range(b):
        hk = jnp.asarray(h[k])
        jp, jhit = jax_subproblem(jnp.asarray(g[k]), lambda v: hk @ v,
                                  jnp.asarray(radius[k]),
                                  jnp.asarray(tol[k]), n + 10)
        assert bool(thit[k]) == bool(jhit), k
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp),
                                   rtol=1e-12, atol=1e-12, err_msg=str(k))
    assert bool(thit[0]) and bool(thit[1]) and not bool(thit[4])
    assert not bool(tp[5].any())
