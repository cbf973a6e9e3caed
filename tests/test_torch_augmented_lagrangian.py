"""The port's augmented-Lagrangian solver against the JAX package's, in
float64 on the CPU.

* The solve cases of tests/test_augmented_lagrangian.py:188-398, of
  tests/test_al_batched.py (batched equals sequential; a box per lane) and
  the AL guards of tests/test_fault_tolerance.py:115-156: each case's own
  assertions on the port's result, and the full-solve contract against the
  JAX package's same solve: status equal, x and multipliers within 1e-6.
* Short budgets (2 outer iterations of at most 5 inner ones, after the
  first outer iteration's 10-iteration warm-up), batched: status, nfev and
  num_iterations exact on every lane, x, multipliers and penalty within
  1e-12, with ``Lbfgs`` and ``Lbfgsb`` inside; four cases need a wider
  float bound, listed in ``SHORT_WIDER`` with their measured spread and its
  reason.

Outside the short-budget contract, measured and listed here
(``NOISE_FLOOR``): ``Lbfgsb`` inside on a quadratic composite (the
equality-and-inequality quadratic of the reference's constrained_simple
example).  L-BFGS-B reaches that composite's minimizer within the warm-up,
and its projected-gradient test fires one iteration late (on the norm
recorded at the start of the step, as in the reference), so one search runs
along a direction of size 1e-15 from a gradient of size 1e-14, where which
trial counts as a decrease is decided by the last bits of f: there the
packages' nfev part by up to 34 (JAX 51, the port 17, of 6 lanes), statuses
and iterations stay equal and x stays within 7e-10.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu import solvers as jsolvers
import cppnumericalsolvers_tpu_torch as cns

torch.set_num_threads(1)

KKT_PRIMAL = 1e-3
KKT_DUAL = 1e-2
FEASIBILITY = 1e-5
FULL_TOL = 1e-6
SHORT_TOL = 1e-12


def lib_mod(lib):
    return torch if lib is cns else jnp


# Problems, built once per package so that the JAX package compiles each
# solve once: name -> builder(lib) -> ConstrainedProblem.
def _half_squared_norm(lib, m):
    return lib.objective(lambda x: 0.5 * m.sum(x * x), mode="first")


def _target(lib, t):
    return lib.objective(lambda x: x[0] - t, mode="first")


def p_equality(lib, m):
    return lib.ConstrainedProblem(_half_squared_norm(lib, m),
                                  (_target(lib, 1.0),))


def p_inequality(lib, m):
    o = lib.objective
    return lib.ConstrainedProblem(
        o(lambda x: 0.5 * ((x[0] - 2.0) ** 2 + x[1] ** 2), mode="first"),
        (), (o(lambda x: 1.0 - x[0], mode="first"),))


def p_both(lib, m):
    o = lib.objective
    return lib.ConstrainedProblem(
        o(lambda x: (x[0] - 1.0) ** 2 + (x[1] - 2.0) ** 2, mode="first"),
        (_target(lib, 0.5),),
        (o(lambda x: 2.0 - (x[0] + x[1]), mode="first"),))


def p_zero_constraint(lib, m):
    return lib.ConstrainedProblem(
        _half_squared_norm(lib, m),
        (lib.objective(lambda x: 0.0 * x[0], mode="first"),))


def p_unconstrained(lib, m):
    return lib.ConstrainedProblem(_half_squared_norm(lib, m))


def p_hs024(lib, m):
    sqrt3 = math.sqrt(3.0)
    scale = 1.0 / (27.0 * sqrt3)
    o = lib.objective
    return lib.ConstrainedProblem(
        o(lambda x: ((x[0] - 3.0) ** 2 - 9.0) * x[1] ** 3 * scale,
          mode="first"), (),
        (o(lambda x: x[0] / sqrt3 - x[1], mode="first"),
         o(lambda x: x[0] + sqrt3 * x[1], mode="first"),
         o(lambda x: 6.0 - x[0] - sqrt3 * x[1], mode="first")))


def p_hs029(lib, m):
    o = lib.objective
    return lib.ConstrainedProblem(
        o(lambda x: -x[0] * x[1], mode="first"), (),
        (o(lambda x: 48.0 - x[0] ** 2 - 2.0 * x[1] ** 2, mode="first"),))


def p_box_pinned(lib, m):
    o = lib.objective
    return lib.ConstrainedProblem(
        o(lambda x: (x[0] - 1.0) ** 2 + 100.0 * (x[0] ** 2 - x[1]) ** 2,
          mode="first"), (),
        (o(lambda x: x[0] ** 2 + x[1], mode="first"),
         o(lambda x: x[0] + x[1] ** 2, mode="first")))


def p_circle(lib, m):
    o = lib.objective
    return lib.ConstrainedProblem(
        o(lambda x: x[0] + x[1], mode="second"),
        (o(lambda x: x[0] ** 2 + x[1] ** 2 - 2.0, mode="second"),))


def p_cubic(lib, m):
    o = lib.objective
    return lib.ConstrainedProblem(
        o(lambda x: x[0] ** 3, mode="first"), (),
        (o(lambda x: x[0], mode="first"),))


def p_example_quadratic(lib, m):
    """examples/constrained.py's first problem: x* = (0.5, 1.5)."""
    o = lib.objective
    return lib.ConstrainedProblem(
        o(lambda x: (x[0] - 1.0) ** 2 + (x[1] - 2.0) ** 2, mode="second"),
        (o(lambda x: x[0] + x[1] - 2.0, mode="second"),),
        (o(lambda x: x[1] - x[0] - 1.0, mode="second"),))


PROBLEMS = {f.__name__[2:]: f for f in (
    p_equality, p_inequality, p_both, p_zero_constraint, p_unconstrained,
    p_hs024, p_hs029, p_box_pinned, p_circle, p_cubic, p_example_quadratic)}


@functools.lru_cache(maxsize=None)
def problem(name, port):
    lib = cns if port else jcns
    return PROBLEMS[name](lib, lib_mod(lib))


# Inner solvers by name: (class, keyword arguments).
INNER = {
    "lbfgs": ("Lbfgs", {}),
    "lbfgsb_nonneg": ("Lbfgsb", {"lower": (0.0, 0.0),
                                 "upper": (1e20, 1e20)}),
    "lbfgsb_pinned": ("Lbfgsb", {"lower": (-0.5, -1e20),
                                 "upper": (0.5, 1.0)}),
    "lbfgsb": ("Lbfgsb", {}),
    "lbfgsb_box": ("Lbfgsb", {"lower": -5.0, "upper": 5.0}),
}


def inner(name, port):
    cls, kw = INNER[name]
    return getattr(cns if port else jsolvers, cls)(**kw)


# Single solves: name -> (problem, inner, x0, penalty, AL arguments, outer
# max_iterations or 0).
SOLVES = {
    "equality": ("equality", "lbfgs", (5.0, 5.0), 1.0, {}, 0),
    "inequality": ("inequality", "lbfgs", (5.0, 5.0), 1.0, {}, 0),
    "both": ("both", "lbfgs", (1.0, 1.0), 1.0, {}, 0),
    "feasible_start": ("zero_constraint", "lbfgs", (0.0, 0.0), 1.0, {}, 0),
    "unconstrained": ("unconstrained", "lbfgs", (5.0, 5.0), 1.0, {}, 0),
    "growth_disabled": ("equality", "lbfgs", (5.0, 5.0), 1.0,
                        {"penalty_growth_factor": 1.0}, 0),
    "hs024": ("hs024", "lbfgsb_nonneg", (1.0, 0.5), 0.0, {}, 0),
    "hs029": ("hs029", "lbfgs", (1.0, 1.0), 0.0, {}, 0),
    "box_pinned": ("box_pinned", "lbfgsb_pinned", (-2.0, 1.0), 0.0, {}, 0),
    "penalty_blowup": ("cubic", "lbfgs", (1.0,), 0.0, {}, 8),
}


@functools.lru_cache(maxsize=None)
def solve(name):
    prob, inn, x0, penalty, kw, cap = SOLVES[name]
    jal = jsolvers.AugmentedLagrangian(inner_solver=inner(inn, False), **kw)
    tal = cns.AugmentedLagrangian(inner_solver=inner(inn, True), **kw)
    js = jcns.default_stopping(jnp.float64)
    ts = cns.default_stopping(torch.float64)
    if cap:
        js, ts = js.replace(max_iterations=cap), ts.replace(
            max_iterations=cap)
    want = jal.minimize(problem(prob, False), jnp.asarray(x0),
                        penalty=penalty, stopping=js)
    got = tal.minimize(problem(prob, True),
                       torch.tensor(x0, dtype=torch.float64),
                       penalty=penalty, stopping=ts, device="cpu")
    return want, got


def assert_full_contract(got, want):
    np.testing.assert_array_equal(got.progress.status.numpy(),
                                  np.asarray(want.progress.status))
    np.testing.assert_allclose(got.state.x.numpy(), np.asarray(want.state.x),
                               rtol=0, atol=FULL_TOL)
    for side in ("equality", "inequality"):
        np.testing.assert_allclose(
            getattr(got.state.multipliers, side).numpy(),
            np.asarray(getattr(want.state.multipliers, side)), rtol=FULL_TOL,
            atol=FULL_TOL, err_msg=side)


def case_equality(r):
    x = r.state.x.numpy()
    assert x[0] == pytest.approx(1.0, abs=KKT_PRIMAL)
    assert x[1] == pytest.approx(0.0, abs=KKT_PRIMAL)
    assert abs(x[0] - 1.0) <= FEASIBILITY
    assert float(r.state.multipliers.equality[0]) == pytest.approx(
        -1.0, abs=KKT_DUAL)
    # The penalty grows only while the violation lags, and the KKT norm is
    # reported on the finished state.
    assert 1.0 <= float(r.state.penalty) <= 1e4
    assert int(r.progress.status) == int(cns.Status.FINISHED)
    assert float(r.state.max_lagrangian_gradient) <= 1e-2


def case_inequality(r):
    x = r.state.x.numpy()
    assert x[0] == pytest.approx(1.0, abs=KKT_PRIMAL)
    assert x[1] == pytest.approx(0.0, abs=KKT_PRIMAL)
    assert 1.0 - x[0] >= -FEASIBILITY
    mu = float(r.state.multipliers.inequality[0])
    assert mu >= -KKT_DUAL and mu == pytest.approx(1.0, abs=KKT_DUAL)


def case_both(r):
    x = r.state.x.numpy()
    assert x[0] == pytest.approx(0.5, abs=KKT_PRIMAL)
    assert x[1] == pytest.approx(1.5, abs=KKT_PRIMAL)
    assert abs(x[0] - 0.5) <= FEASIBILITY
    assert 2.0 - (x[0] + x[1]) >= -FEASIBILITY
    assert float(r.state.multipliers.inequality[0]) >= -KKT_DUAL


def case_feasible_start(r):
    assert float(r.state.x[0]) == pytest.approx(0.0, abs=KKT_PRIMAL)
    assert int(r.progress.status) == int(cns.Status.FINISHED)
    assert int(r.progress.num_iterations) <= 5
    # The penalty holds flat on a feasible problem.
    assert float(r.state.penalty) == 1.0


def case_unconstrained(r):
    np.testing.assert_allclose(r.state.x.numpy(), 0.0, atol=KKT_PRIMAL)
    assert int(r.progress.status) == int(cns.Status.FINISHED)


def case_growth_disabled(r):
    assert float(r.state.penalty) == 1.0


def case_hs024(r):
    x = r.state.x.numpy()
    assert x[0] == pytest.approx(3.0, abs=1e-1)
    assert x[1] == pytest.approx(math.sqrt(3.0), abs=1e-1)
    f = float(problem("hs024", True).objective.fn(r.state.x))
    assert f == pytest.approx(-1.0, abs=0.5)


def case_hs029(r):
    x = r.state.x.numpy()
    assert x[0] == pytest.approx(2.0 * math.sqrt(6.0), abs=2e-1)
    assert x[1] == pytest.approx(2.0 * math.sqrt(3.0), abs=2e-1)
    f = float(problem("hs029", True).objective.fn(r.state.x))
    assert f == pytest.approx(-12.0 * math.sqrt(2.0), abs=5e-1)


def case_box_pinned(r):
    assert int(r.progress.status) == int(cns.Status.FINISHED)
    assert int(r.progress.num_iterations) < 20
    assert float(r.state.x[0]) == pytest.approx(0.5, abs=1e-4)
    assert float(r.state.x[1]) == pytest.approx(0.25, abs=1e-4)


def case_penalty_blowup(r):
    # tests/test_fault_tolerance.py: the composite is unbounded below, the
    # outer loop hard-stops and installs the finite Pareto-best iterate.
    assert np.all(np.isfinite(r.state.x.numpy()))
    assert int(r.progress.status) != int(cns.Status.CONTINUE)


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_solve_matches_jax(name):
    want, got = solve(name)
    globals()[f"case_{name}"](got)
    assert_full_contract(got, want)
    assert int(got.progress.num_iterations) == int(
        want.progress.num_iterations)


def test_multiplier_nan_reset_and_clamp():
    # augmented_lagrangian.h:544-563: clamp to +/- multiplier_max (equality)
    # or [0, max] (inequality), then a non-finite candidate -> 0.
    tal = cns.AugmentedLagrangian(inner_solver=cns.Lbfgs())
    jal = jsolvers.AugmentedLagrangian(inner_solver=jsolvers.Lbfgs())
    for fn, cand, expect in (
            ("_clamp_eq", [np.nan, 1e30, -1e30, 5.0, np.inf],
             [0.0, 1e20, -1e20, 5.0, 0.0]),
            ("_clamp_ineq", [np.nan, 1e30, -3.0, 5.0, -np.inf],
             [0.0, 1e20, 0.0, 5.0, 0.0])):
        got = getattr(tal, fn)(torch.tensor(cand, dtype=torch.float64)).numpy()
        np.testing.assert_array_equal(got, expect)
        np.testing.assert_array_equal(
            got, np.asarray(getattr(jal, fn)(jnp.asarray(cand))))


def _circle_starts():
    return np.array([[2.0, 1.0], [0.5, 2.5], [-0.3, 1.7], [3.0, -2.0]])


def test_batched_matches_sequential_and_lane_by_lane():
    tprob, jprob = problem("circle", True), problem("circle", False)
    starts = _circle_starts()
    tal = cns.AugmentedLagrangian(inner_solver=cns.Lbfgs())
    batched = tal.minimize_batched(tprob, torch.from_numpy(starts),
                                   device="cpu")
    lane_by_lane = cns.AugmentedLagrangian(
        inner_solver=cns.Lbfgs(), batched_impl="vmap").minimize_batched(
            tprob, torch.from_numpy(starts), device="cpu")
    want = jsolvers.AugmentedLagrangian(
        inner_solver=jsolvers.Lbfgs()).minimize_batched(
            jprob, jnp.asarray(starts))
    assert tuple(batched.state.x.shape) == (4, 2)
    np.testing.assert_array_equal(batched.progress.status.numpy(),
                                  lane_by_lane.progress.status.numpy())
    np.testing.assert_array_equal(batched.state.nfev.numpy(),
                                  lane_by_lane.state.nfev.numpy())
    for lane in range(4):
        single = tal.minimize(tprob, torch.from_numpy(starts[lane]),
                              device="cpu")
        np.testing.assert_allclose(batched.state.x[lane].numpy(),
                                   single.state.x.numpy(), rtol=1e-12)
        np.testing.assert_allclose(
            float(batched.state.multipliers.equality[lane, 0]),
            float(single.state.multipliers.equality[0]), rtol=1e-12)
        np.testing.assert_allclose(lane_by_lane.state.x[lane].numpy(),
                                   single.state.x.numpy(), rtol=1e-12)
    np.testing.assert_allclose(batched.state.x.numpy(), -1.0, atol=1e-3)
    np.testing.assert_allclose(
        batched.state.multipliers.equality[:, 0].numpy(), 0.5, atol=1e-3)
    assert_full_contract(batched, want)
    np.testing.assert_array_equal(batched.state.nfev.numpy(),
                                  np.asarray(want.state.nfev))


def test_runtime_per_lane_bounds():
    """tests/test_al_batched.py:58: a floor per lane on x0 through
    ``inner_internals``; each lane's optimum is (floor, -sqrt(2 -
    floor^2)), and the projected KKT norm uses the lane's own box."""
    tprob, jprob = problem("circle", True), problem("circle", False)
    floors = np.array([-2.0, -0.5, 0.0])
    lowers = np.stack([[f, -10.0] for f in floors])
    uppers = np.full((3, 2), 10.0)
    starts = np.array([[2.0, -1.0]] * 3)
    tinner, jinner = cns.Lbfgsb(), jsolvers.Lbfgsb()
    tint = tinner.make_internals(2, torch.float64, torch.from_numpy(lowers),
                                 torch.from_numpy(uppers))
    jint = jax.vmap(lambda lo, up: jinner.make_internals(
        2, jnp.float64, lo, up))(jnp.asarray(lowers), jnp.asarray(uppers))
    ts = cns.default_stopping(torch.float64).replace(max_iterations=50)
    js = jcns.default_stopping(jnp.float64).replace(max_iterations=50)
    tal = cns.AugmentedLagrangian(inner_solver=tinner)
    got = tal.minimize_batched(tprob, torch.from_numpy(starts), stopping=ts,
                               inner_internals=tint, device="cpu")
    want = jsolvers.AugmentedLagrangian(inner_solver=jinner)\
        .minimize_batched(jprob, jnp.asarray(starts), stopping=js,
                          inner_internals=jint)
    assert_full_contract(got, want)
    for lane in range(3):
        single = tal.minimize(
            tprob, torch.from_numpy(starts[lane]), stopping=ts,
            inner_internals=tinner.make_internals(
                2, torch.float64, torch.from_numpy(lowers[lane]),
                torch.from_numpy(uppers[lane])), device="cpu")
        np.testing.assert_allclose(got.state.x[lane].numpy(),
                                   single.state.x.numpy(), rtol=1e-12,
                                   atol=1e-12)
        x = got.state.x[lane].numpy()
        assert np.all(x >= lowers[lane] - 1e-8)
        f = floors[lane]
        expect = [-1.0, -1.0] if f <= -1.0 else [f, -np.sqrt(2.0 - f * f)]
        np.testing.assert_allclose(x, expect, atol=1e-3)
        assert int(got.progress.status[lane]) == int(cns.Status.FINISHED)


# Short budgets, batched: (problem, inner solver, starts' box).
SHORT = {
    "both_lbfgs": ("both", "lbfgs", 3.0),
    "inequality_lbfgs": ("inequality", "lbfgs", 3.0),
    "circle_lbfgs": ("circle", "lbfgs", 2.0),
    "circle_lbfgsb": ("circle", "lbfgsb_box", 2.0),
    "hs029_lbfgsb": ("hs029", "lbfgsb_box", 3.0),
}
# Float bounds wider than SHORT_TOL, with the spread measured on this file's
# starts: (x, multipliers).  The auto-scaled penalty is 800-2,600 on these
# problems, so the composites are that ill-conditioned, and their 15 inner
# iterations amplify the last-bit differences between XLA's fused
# multiply-adds and PyTorch's; ``lambda += rho c`` multiplies what is left
# in c by rho.  Statuses, nfev and iterations stay exact.
SHORT_WIDER = {
    "both_lbfgs": (SHORT_TOL, 1e-11),     # multipliers 2.6e-12
    "circle_lbfgs": (1e-10, 3e-9),        # x 1.8e-11, lambda 9.6e-10
    "circle_lbfgsb": (1e-9, 1e-8),        # x 2.1e-10, lambda 3.2e-9
    "hs029_lbfgsb": (3e-8, 2e-8),         # x 1.05e-8, mu 6.5e-9
}
# Short budgets outside the exact contract (see the module docstring).
NOISE_FLOOR = {"example_quadratic_lbfgsb": ("example_quadratic",
                                            "lbfgsb_box", 2.0)}


def short_solves(prob, inn, box):
    x0 = np.random.default_rng(0).uniform(-box, box, (6, 2))
    jal = jsolvers.AugmentedLagrangian(inner_solver=inner(inn, False))
    tal = cns.AugmentedLagrangian(inner_solver=inner(inn, True))
    js = jcns.default_stopping(jnp.float64).replace(max_iterations=2)
    ts = cns.default_stopping(torch.float64).replace(max_iterations=2)
    jis = inner(inn, False).default_stopping(jnp.float64).replace(
        max_iterations=5)
    tis = inner(inn, True).default_stopping(torch.float64).replace(
        max_iterations=5)
    want = jal.minimize_batched(problem(prob, False), jnp.asarray(x0),
                                stopping=js, inner_stopping=jis)
    got = tal.minimize_batched(problem(prob, True), torch.from_numpy(x0),
                               stopping=ts, inner_stopping=tis, device="cpu")
    return want, got


@pytest.mark.parametrize("case", sorted(SHORT))
def test_short_budget_is_exact(case):
    want, got = short_solves(*SHORT[case])
    for name in ("status", "num_iterations"):
        np.testing.assert_array_equal(
            getattr(got.progress, name).numpy(),
            np.asarray(getattr(want.progress, name)), err_msg=name)
    np.testing.assert_array_equal(got.state.nfev.numpy(),
                                  np.asarray(want.state.nfev))
    x_tol, m_tol = SHORT_WIDER.get(case, (SHORT_TOL, SHORT_TOL))
    for name, a, b, tol in (
            ("x", got.state.x, want.state.x, x_tol),
            ("penalty", got.state.penalty, want.state.penalty, SHORT_TOL),
            ("equality", got.state.multipliers.equality,
             want.state.multipliers.equality, m_tol),
            ("inequality", got.state.multipliers.inequality,
             want.state.multipliers.inequality, m_tol)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                   atol=tol, err_msg=name)
    assert got.inner_iterations > 0 and got.trips > 0


@pytest.mark.parametrize("case", sorted(NOISE_FLOOR))
def test_short_budget_at_the_noise_floor(case):
    want, got = short_solves(*NOISE_FLOOR[case])
    for name in ("status", "num_iterations"):
        np.testing.assert_array_equal(
            getattr(got.progress, name).numpy(),
            np.asarray(getattr(want.progress, name)), err_msg=name)
    np.testing.assert_allclose(got.state.x.numpy(), np.asarray(want.state.x),
                               rtol=0, atol=FULL_TOL)


def test_jax_result_converts():
    """``convert.from_jax_numpy`` carries a JAX ``AlResult`` (its state with
    the multipliers nested, and the outer progress) into the port's
    records."""
    from cppnumericalsolvers_tpu_torch.convert import from_jax_numpy

    want, got = solve("both")
    conv = from_jax_numpy(jax.tree.map(np.asarray, want))
    assert isinstance(conv, cns.solvers.AlResult)
    assert isinstance(conv.state, cns.solvers.AugmentedLagrangeState)
    assert isinstance(conv.state.multipliers, cns.MultiplierState)
    assert conv.state.nfev.dtype == torch.int32
    assert conv.state.penalty_was_auto_scaled.dtype == torch.bool
    np.testing.assert_array_equal(conv.state.x.numpy(),
                                  np.asarray(want.state.x))
    assert int(conv.progress.status) == int(got.progress.status)
    assert_full_contract(got, conv)


def test_warm_multipliers_and_penalty_match_jax():
    """``minimize`` from given multipliers and penalty (a continuation, the
    reference's augmented_lagrangian.h:195-203), with a box given at run
    time for the inner L-BFGS-B."""
    tprob, jprob = problem("both", True), problem("both", False)
    x0 = np.array([2.0, -1.0])
    tinner, jinner = cns.Lbfgsb(), jsolvers.Lbfgsb()
    lo, up = np.array([-1.0, -1.0]), np.array([3.0, 3.0])
    got = cns.AugmentedLagrangian(inner_solver=tinner).minimize(
        tprob, torch.from_numpy(x0),
        multipliers=cns.MultiplierState(torch.tensor([0.4]),
                                        torch.tensor([0.7])),
        penalty=5.0,
        inner_internals=tinner.make_internals(2, torch.float64,
                                              torch.from_numpy(lo),
                                              torch.from_numpy(up)),
        device="cpu")
    want = jsolvers.AugmentedLagrangian(inner_solver=jinner).minimize(
        jprob, jnp.asarray(x0),
        multipliers=jcns.MultiplierState(jnp.asarray([0.4]),
                                         jnp.asarray([0.7])),
        penalty=5.0,
        inner_internals=jinner.make_internals(2, jnp.float64,
                                              jnp.asarray(lo),
                                              jnp.asarray(up)))
    assert_full_contract(got, want)
    case_both(got)
    assert not bool(got.state.penalty_was_auto_scaled)
