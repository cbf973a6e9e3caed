"""The port's flat batched L-BFGS solve against the JAX package.

The port's ``flat_lbfgs_solve`` runs here through its plain PyTorch trip
(``flat_trip_reference``, what ``flat_trip`` takes for CPU tensors).  It is
held to the parity contract of tests/test_flat_solve.py, in float64, against
both JAX lowerings on the CPU: the nested path that
``cppnumericalsolvers_tpu.minimize_batched`` takes here, and ``_flat_kernel``
in interpret mode.  Inputs are made with numpy from a seed.

Tolerances (tests/test_flat_solve.py:44-86): under a short budget status,
nfev and iteration counts are exact and iterates agree within 1e-12; full
solves agree on per-lane status, on mean nfev within 3 and on values within
1e-6, where ulp drift between two orders of summation compounds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu.ops.flat_solve import (
    flat_lbfgs_solve as jax_flat_solve,
)
from cppnumericalsolvers_tpu.solvers import Lbfgs as JaxLbfgs
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.convert import from_jax_numpy

torch.set_num_threads(1)


def jax_rosen(x):
    e, o = x[0::2], x[1::2]
    return jnp.sum(100.0 * (o - e**2) ** 2 + (1.0 - e) ** 2)


JOBJ = jcns.objective(jax_rosen, mode="first")
TOBJ = cns.models.pairwise_rosenbrock()


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def jax_nested(x0, stopping):
    return jcns.minimize_batched(JOBJ, jnp.asarray(x0), JaxLbfgs(), stopping)


def jax_flat(x0, stopping, obj=JOBJ):
    state0 = jax.vmap(lambda x: obj.evaluate(x, nfev=0))(jnp.asarray(x0))
    return jax_flat_solve(obj, state0, stopping, m=10, max_fev=20,
                          interpret=True)


def port(x0, stopping=None, obj=TOBJ):
    return cns.minimize_batched(obj, torch.from_numpy(np.asarray(x0)),
                                cns.Lbfgs(), stopping, device="cpu")


def jstop(**kw):
    return jcns.default_stopping(jnp.float64).replace(**kw)


def tstop(**kw):
    return cns.default_stopping(torch.float64).replace(**kw)


@functools.lru_cache(maxsize=None)
def short_budget():
    x0 = np.random.default_rng(1).uniform(-2, 2, (24, 20))
    return (x0, jax_nested(x0, jstop(max_iterations=8)),
            jax_flat(x0, jstop(max_iterations=8)),
            port(x0, tstop(max_iterations=8)))


@pytest.mark.parametrize("against", ["nested", "flat"])
def test_short_budget_trajectory_is_exact(against):
    x0, nested, flat, res = short_budget()
    if against == "nested":
        status, nfev = nested.progress.status, nested.state.nfev
        its, x = nested.progress.num_iterations, nested.state.x
    else:
        st, _, pr = flat
        status, nfev, its, x = pr.status, st.nfev, pr.num_iterations, st.x
    np.testing.assert_array_equal(res.progress.status.numpy(),
                                  np.asarray(status))
    np.testing.assert_array_equal(res.state.nfev.numpy(), np.asarray(nfev))
    np.testing.assert_array_equal(res.progress.num_iterations.numpy(),
                                  np.asarray(its))
    np.testing.assert_allclose(res.state.x.numpy(), np.asarray(x),
                               rtol=1e-12, atol=1e-12)
    assert res.trips > 0


@functools.lru_cache(maxsize=None)
def full_solve():
    x0 = np.random.default_rng(2).uniform(-2, 2, (16, 8))
    return x0, jax_nested(x0, jstop()), jax_flat(x0, jstop()), port(x0)


def test_full_solve_statuses_and_counts_match_nested():
    _, nested, _, res = full_solve()
    np.testing.assert_array_equal(res.progress.status.numpy(),
                                  np.asarray(nested.progress.status))
    assert abs(res.state.nfev.double().mean().item()
               - np.asarray(nested.state.nfev).mean()) < 3.0
    np.testing.assert_allclose(res.state.value.numpy(),
                               np.asarray(nested.state.value), atol=1e-6)


def _history_err(flat, res):
    """Per-lane max |history difference| against JAX's flat kernel, whose
    batch-minor history comes across through ``from_jax_numpy``."""
    st, (s_t, y_t, count, gamma), _ = flat
    b, n = st.x.shape
    theirs = from_jax_numpy(
        {"s_memory_t": s_t, "y_memory_t": y_t, "mem_count": count,
         "gamma": gamma}, n=n, m=10)
    assert isinstance(theirs, cns.solvers.LbfgsInternals)
    assert tuple(theirs.s_memory.shape) == (b, 10, n)
    mine = res.internals
    np.testing.assert_array_equal(mine.mem_count.numpy(),
                                  theirs.mem_count.numpy())
    s_err, y_err = (
        np.abs(a.numpy() - c.numpy()).reshape(b, -1).max(1)
        for a, c in ((mine.s_memory, theirs.s_memory),
                     (mine.y_memory, theirs.y_memory)))
    gamma_err = np.abs(mine.gamma.numpy() - theirs.gamma.numpy())
    return s_err, y_err, gamma_err


def test_short_budget_history_matches_flat_kernel():
    _, _, flat, res = short_budget()
    s_err, y_err, gamma_err = _history_err(flat, res)
    assert max(s_err.max(), y_err.max(), gamma_err.max()) <= 1e-10


def test_full_solve_history_matches_flat_kernel():
    """After a full solve nfev, the count and the progress record agree on
    every lane.  The iterates have drifted apart by then (up to ~1e-6 on
    some lanes here, from two orders of summation and PyTorch's CPU sqrt
    rounding), so the history is compared on the lanes whose final iterate
    agrees within 1e-12: s and gamma within 1e-10, and y = g1 - g0 within
    1e-8, since the Hessian (entries up to ~1e3 near this Rosenbrock's
    optimum) multiplies the iterate drift into y."""
    x0, _, flat, res = full_solve()
    st, _, pr = flat
    s_err, y_err, gamma_err = _history_err(flat, res)
    xerr = np.abs(res.state.x.numpy() - np.asarray(st.x)).max(1)
    close = xerr <= 1e-12
    assert close.sum() >= 4
    assert max(s_err[close].max(), gamma_err[close].max()) <= 1e-10
    assert y_err[close].max() <= 1e-8
    progress = from_jax_numpy(_np(pr))
    assert isinstance(progress, cns.ProgressState)
    for name in ("status", "num_iterations", "past_pos",
                 "x_delta_violations"):
        np.testing.assert_array_equal(getattr(res.progress, name).numpy(),
                                      getattr(progress, name).numpy())
    np.testing.assert_array_equal(res.state.nfev.numpy(),
                                  np.asarray(st.nfev))


def test_non_descent_start_aborts_like_jax():
    """A start at the optimum: the search never evaluates, x_delta fires."""
    x0 = np.ones((8, 6))
    nested = jax_nested(x0, jstop())
    st, _, pr = jax_flat(x0, jstop())
    res = port(x0)
    for status, nfev in ((nested.progress.status, nested.state.nfev),
                         (pr.status, st.nfev)):
        np.testing.assert_array_equal(res.progress.status.numpy(),
                                      np.asarray(status))
        np.testing.assert_array_equal(res.state.nfev.numpy(),
                                      np.asarray(nfev))
    np.testing.assert_array_equal(res.state.x.numpy(), x0)


def test_iteration_limit_respected():
    x0 = np.random.default_rng(3).uniform(-2, 2, (8, 10))
    off = dict(max_iterations=5, gradient_norm=0.0, x_delta=0.0,
               f_delta=0.0, past=0)
    res = port(x0, tstop(**off))
    assert (res.progress.num_iterations.numpy() == 6).all()
    assert (res.progress.status.numpy() == int(cns.Status.ITERATION_LIMIT)
            ).all()
    nested = jax_nested(x0, jstop(**off))
    np.testing.assert_array_equal(res.state.nfev.numpy(),
                                  np.asarray(nested.state.nfev))


def test_nan_lane_does_not_touch_other_lanes():
    """One lane whose objective is NaN everywhere; the others come out
    exactly as in a run without it (tests/test_fault_tolerance.py)."""

    def fn(x):
        e, o = x[0::2], x[1::2]
        f = torch.sum(100.0 * (o - e**2) ** 2 + (1.0 - e) ** 2)
        return torch.where(x[-1] > 50.0, torch.full_like(f, torch.nan), f)

    obj = cns.objective(fn)
    x0 = np.random.default_rng(4).uniform(-2, 2, (6, 8))
    x0[2, -1] = 100.0
    res = port(x0, obj=obj)
    keep = [0, 1, 3, 4, 5]
    alone = port(x0[keep], obj=obj)
    assert res.progress.status[2].item() != int(cns.Status.CONTINUE)
    assert np.isfinite(res.state.x.numpy()[keep]).all()
    for name in ("x", "value", "gradient", "nfev"):
        np.testing.assert_array_equal(
            getattr(res.state, name).numpy()[keep],
            getattr(alone.state, name).numpy())
    np.testing.assert_array_equal(res.progress.status.numpy()[keep],
                                  alone.progress.status.numpy())
    np.testing.assert_array_equal(res.internals.s_memory.numpy()[keep],
                                  alone.internals.s_memory.numpy())


def test_float32_statuses_match_on_well_conditioned_lanes():
    """float32 on convex quadratics of condition <= 100: every lane stops on
    the same test as JAX's nested path.  Values agree to 1e-5 relative
    (float32 eps is 1.2e-7; the two sum in different orders, and the stop
    lands a few iterations from the optimum where f is flat)."""
    rng = np.random.default_rng(5)
    scales = rng.uniform(1.0, 100.0, (12, 6))

    # Each lane's scales ride along as coordinates with no gradient.
    def jquad(z):
        x, c = z[:6], z[6:]
        return jnp.sum(jax.lax.stop_gradient(c) * x * x)

    def tquad(z):
        x, c = z[:6], z[6:]
        return torch.sum(c.detach() * x * x)

    x0 = np.concatenate([rng.uniform(-2, 2, (12, 6)), scales], axis=1)
    x0 = x0.astype(np.float32)
    jres = jcns.minimize_batched(jcns.objective(jquad, mode="first"),
                                 jnp.asarray(x0), JaxLbfgs(),
                                 jcns.default_stopping(jnp.float32))
    tres = cns.minimize_batched(cns.objective(tquad), torch.from_numpy(x0),
                                cns.Lbfgs(), device="cpu")
    assert tres.state.x.dtype == torch.float32
    np.testing.assert_array_equal(tres.progress.status.numpy(),
                                  np.asarray(jres.progress.status))
    np.testing.assert_allclose(tres.state.value.numpy(),
                               np.asarray(jres.state.value),
                               rtol=1e-5, atol=1e-6)


def test_infoc_carry_pinned_case():
    """ROADMAP C#1: a linear descent into a NaN pocket.  The second trial
    lands in the pocket (f NaN, g 0), cstep case 3 moves stx there with a
    zero slope, and the next cstep reports an input error (infoc 0).  The
    port carries infoc as MINPACK and JAX's nested path do, so the search
    stops with info 6 one evaluation later; JAX's flat kernel drops it and
    re-evaluates the pocket until max_fev."""
    jobj = jcns.objective(
        lambda x: jnp.where(x[0] > 1.5, jnp.nan, -x[0]), mode="first")
    tobj = cns.objective(lambda x: torch.where(
        x[0] > 1.5, torch.full_like(x[0], torch.nan), -x[0]))
    x0 = np.array([[0.0], [0.5], [-1.0], [1.0]])
    nested = jcns.minimize_batched(jobj, jnp.asarray(x0), JaxLbfgs(),
                                   jstop())
    st, _, pr = jax_flat(x0, jstop(), obj=jobj)
    res = port(x0, obj=tobj)
    np.testing.assert_array_equal(res.state.nfev.numpy(),
                                  np.asarray(nested.state.nfev))
    np.testing.assert_array_equal(res.progress.status.numpy(),
                                  np.asarray(nested.progress.status))
    np.testing.assert_array_equal(res.state.x.numpy(),
                                  np.asarray(nested.state.x))
    # The divergence from the flat kernel: it runs each search to max_fev.
    np.testing.assert_array_equal(np.asarray(st.nfev), [21, 21, 21, 21])
    assert (res.state.nfev.numpy() < np.asarray(st.nfev)).all()
