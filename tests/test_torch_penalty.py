"""The port's constrained layer (``core/problem.py``, ``core/penalty.py``)
against the JAX package's, in float64 on the CPU: the penalty helpers and
the composites of tests/test_augmented_lagrangian.py:60-185, each held to
its closed form and to the JAX package's value and gradient within 1e-12;
and the per-lane composites of a batch (two lanes at the same x with
different multipliers and penalties), where each lane's value, gradient,
Lagrangian gradient and auto-scaled penalty must be its own instance's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu.core import penalty as jpen
from cppnumericalsolvers_tpu.solvers import (
    AugmentedLagrangian as JaxAugmentedLagrangian,
    Lbfgs as JaxLbfgs,
)
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.core import penalty as tpen

torch.set_num_threads(1)

TOL = 1e-12


def linear_1d(lib, a, b):
    """f(x) = a + b*x[0] (the reference test's Linear1D fixture)."""
    return lib.objective(lambda x: a + b * x[0], mode="first")


# (builder name, (a, b) of the constraint, x0, closed-form value, gradient)
HELPERS = [
    ("quadratic_equality_penalty", (-2.0, 1.0), 2.0, 0.0, 0.0),
    ("quadratic_equality_penalty", (-2.0, 1.0), 5.0, 4.5, 3.0),
    ("quadratic_equality_penalty", (-2.0, 1.0), -1.0, 4.5, -3.0),
    ("quadratic_inequality_penalty_ge", (0.0, 1.0), 0.0, 0.0, 0.0),
    ("quadratic_inequality_penalty_ge", (0.0, 1.0), 5.0, 0.0, 0.0),
    ("quadratic_inequality_penalty_ge", (0.0, 1.0), -3.0, 4.5, -3.0),
    ("quadratic_inequality_penalty_lt", (0.0, 1.0), -5.0, 0.0, 0.0),
    ("quadratic_inequality_penalty_lt", (0.0, 1.0), 0.0, 0.0, 0.0),
    ("quadratic_inequality_penalty_lt", (0.0, 1.0), 3.0, 4.5, 3.0),
]


@pytest.mark.parametrize("name,ab,x0,value,gradient", HELPERS)
def test_penalty_helper_matches_closed_form_and_jax(name, ab, x0, value,
                                                    gradient):
    tp = getattr(tpen, name)(linear_1d(cns, *ab))
    jp = getattr(jpen, name)(linear_1d(jcns, *ab))
    v, g = tp.value_and_grad(torch.tensor([x0], dtype=torch.float64))
    jv, jg = jp.value_and_grad(jnp.asarray([x0], dtype=jnp.float64))
    assert float(v) == pytest.approx(value, abs=TOL)
    assert float(g[0]) == pytest.approx(gradient, abs=TOL)
    assert float(v) == pytest.approx(float(jv), abs=TOL)
    assert float(g[0]) == pytest.approx(float(jg[0]), abs=TOL)


def half_squared_norm(lib):
    mod = torch if lib is cns else jnp
    return lib.objective(lambda x: 0.5 * mod.sum(x * x), mode="first")


def x0_minus(lib, t):
    return lib.objective(lambda x: x[0] - t, mode="first")


def problem(lib, eq=(), ineq=()):
    return lib.ConstrainedProblem(
        half_squared_norm(lib), tuple(x0_minus(lib, t) for t in eq),
        tuple(x0_minus(lib, t) for t in ineq))


# (equality targets, inequality targets, lambda, mu, rho, x, closed form)
COMPOSITES = {
    "equality_only": ((1.0,), (), [2.0], [], 3.0, [3.0, 4.0], 22.5),
    "phr_inactive_side": ((), (0.5,), [], [7.0], 4.0, [3.0, 0.0], -1.625),
    "phr_active_side": ((), (0.5,), [], [7.0], 4.0, [0.0, 0.0], 4.0),
    "phr_off_at_zero_penalty": ((), (0.5,), [], [7.0], 0.0, [0.0, 0.0],
                                0.0),
}


@pytest.mark.parametrize("case", sorted(COMPOSITES))
def test_composite_matches_closed_form_and_jax(case):
    eq, ineq, lam, mu, rho, x, value = COMPOSITES[case]
    x = np.array(x)
    tprob, jprob = problem(cns, eq, ineq), problem(jcns, eq, ineq)
    tm = cns.MultiplierState(torch.tensor(lam, dtype=torch.float64),
                             torch.tensor(mu, dtype=torch.float64))
    jm = jcns.MultiplierState(jnp.asarray(lam, dtype=jnp.float64),
                              jnp.asarray(mu, dtype=jnp.float64))
    got = cns.augmented_lagrangian_value(tprob, torch.from_numpy(x), tm, rho)
    want = jcns.augmented_lagrangian_value(jprob, jnp.asarray(x), jm, rho)
    assert float(got) == pytest.approx(value, abs=TOL)
    assert float(got) == pytest.approx(float(want), abs=TOL)
    tv, tg = cns.to_augmented_lagrangian(tprob, tm, rho).value_and_grad(
        torch.from_numpy(x))
    jv, jg = jcns.to_augmented_lagrangian(jprob, jm, rho).value_and_grad(
        jnp.asarray(x))
    assert float(tv) == pytest.approx(float(jv), abs=TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(
        cns.lagrangian_gradient(tprob, torch.from_numpy(x), tm).numpy(),
        np.asarray(jcns.lagrangian_gradient(jprob, jnp.asarray(x), jm)),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        float(tpen.penalty_value(tprob, torch.from_numpy(x), rho)),
        float(jpen.penalty_value(jprob, jnp.asarray(x), rho)), rtol=TOL,
        atol=TOL)


def circle_with_ineq(lib):
    mod = torch if lib is cns else jnp
    o = lib.objective
    return lib.ConstrainedProblem(
        o(lambda x: mod.sum(x) + 0.25 * mod.sum(x * x * x), mode="first"),
        (o(lambda x: mod.sum(x * x) - 2.0, mode="first"),),
        (o(lambda x: x[0] - 0.5 * x[1], mode="first"),
         o(lambda x: 1.0 - x[1] * x[1], mode="first")))


def test_lanes_of_a_batch_keep_their_own_multipliers():
    """Two lanes at the same x with different (lambda, mu, rho), and a third
    elsewhere: each lane's batched value, gradient and Lagrangian gradient
    are its own instance's, in the port and in the JAX package."""
    x = np.array([[0.3, -1.2, 0.8], [0.3, -1.2, 0.8], [1.5, 0.2, -0.4]])
    lam = np.array([[0.5], [-2.0], [1.0]])
    mu = np.array([[0.0, 3.0], [1.5, 0.25], [2.0, 0.0]])
    rho = np.array([2.0, 10.0, 0.5])
    tprob, jprob = circle_with_ineq(cns), circle_with_ineq(jcns)
    tm = cns.MultiplierState(torch.from_numpy(lam), torch.from_numpy(mu))
    composite = cns.to_augmented_lagrangian(tprob, tm, torch.from_numpy(rho))
    assert isinstance(composite, cns.core.LaneObjective)
    xt = torch.from_numpy(x)
    v, g = composite.batched_value_and_grad(xt)
    np.testing.assert_allclose(composite.batched_value(xt).numpy(),
                               v.numpy(), rtol=0, atol=0)
    lg = cns.lagrangian_gradient(tprob, xt, tm)
    assert not np.allclose(v[0].item(), v[1].item())
    for k in range(3):
        one = cns.MultiplierState(tm.equality[k], tm.inequality[k])
        sv, sg = cns.to_augmented_lagrangian(
            tprob, one, float(rho[k])).value_and_grad(xt[k])
        assert float(v[k]) == float(sv)
        np.testing.assert_array_equal(g[k].numpy(), sg.numpy())
        jm = jcns.MultiplierState(jnp.asarray(lam[k]), jnp.asarray(mu[k]))
        jv, jg = jcns.to_augmented_lagrangian(
            jprob, jm, rho[k]).value_and_grad(jnp.asarray(x[k]))
        assert float(v[k]) == pytest.approx(float(jv), rel=TOL, abs=TOL)
        np.testing.assert_allclose(g[k].numpy(), np.asarray(jg), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(
            lg[k].numpy(),
            np.asarray(jcns.lagrangian_gradient(jprob, jnp.asarray(x[k]),
                                                jm)),
            rtol=TOL, atol=TOL)
    for k in range(3):
        tv = tpen.to_penalty(tprob, float(rho[k])).value(xt[k])
        assert float(tv) == pytest.approx(
            float(jpen.penalty_value(jprob, jnp.asarray(x[k]), rho[k])),
            rel=TOL, abs=TOL)


def test_auto_scaled_penalty_per_lane():
    x = np.array([[0.3, -1.2, 0.8], [2.0, 2.0, 2.0], [1e-3, 0.0, 0.0],
                  [40.0, -3.0, 1.0]])
    tprob, jprob = circle_with_ineq(cns), circle_with_ineq(jcns)
    got = cns.AugmentedLagrangian(inner_solver=cns.Lbfgs())\
        ._auto_scaled_penalty(tprob, torch.from_numpy(x)).numpy()
    jal = JaxAugmentedLagrangian(inner_solver=JaxLbfgs())
    want = np.asarray(jax.vmap(
        lambda z: jal._auto_scaled_penalty(jprob, z))(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=0)
    assert len(set(got.tolist())) == 4


def test_problem_counts_and_stacked_evaluations():
    tprob, jprob = circle_with_ineq(cns), circle_with_ineq(jcns)
    assert (tprob.num_equalities, tprob.num_inequalities) == (1, 2)
    assert tprob.has_general_constraints and tprob.mode == "first"
    assert not cns.ConstrainedProblem(half_squared_norm(cns))\
        .has_general_constraints
    x = np.array([0.7, -0.2, 1.1])
    for name in ("eval_equalities", "eval_inequalities"):
        np.testing.assert_allclose(
            getattr(tprob, name)(torch.from_numpy(x)).numpy(),
            np.asarray(getattr(jprob, name)(jnp.asarray(x))), rtol=TOL,
            atol=TOL)
    empty = cns.ConstrainedProblem(half_squared_norm(cns))
    assert empty.eval_equalities(torch.from_numpy(x)).shape == (0,)
    z = cns.MultiplierState.zeros(1, 2, batch_shape=(5,))
    assert z.equality.shape == (5, 1) and z.inequality.shape == (5, 2)
