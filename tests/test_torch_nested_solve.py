"""The port's iteration-granular L-BFGS loop against the JAX package.

``minimize_batched(internals=...)``, ``minimize_batched(trace=K)`` and
``minimize(trace=K, callback=fn)`` take the loop of core/driver.py over
``Lbfgs.step_and_update`` (prologue -> batched search -> epilogue).  Here it
runs on the CPU through the plain versions and is held to
``cppnumericalsolvers_tpu.minimize_batched``, which takes its generic
batched loop on the CPU, under the parity contract of
tests/test_flat_solve.py: under a short budget status, nfev and iteration
counts are exact and iterates agree within 1e-12 (float64); full solves
agree on per-lane status, on mean nfev within 3 and on values within 1e-6.
Inputs are made with numpy from a seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu.solvers import Lbfgs as JaxLbfgs
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.convert import from_jax_numpy
from cppnumericalsolvers_tpu_torch.core.tree import tree_map

torch.set_num_threads(1)


def jax_rosen(x):
    e, o = x[0::2], x[1::2]
    return jnp.sum(100.0 * (o - e**2) ** 2 + (1.0 - e) ** 2)


JOBJ = jcns.objective(jax_rosen, mode="first")
TOBJ = cns.models.pairwise_rosenbrock()
SOLVER = cns.Lbfgs()


def jstop(**kw):
    return jcns.default_stopping(jnp.float64).replace(**kw)


def tstop(**kw):
    return cns.default_stopping(torch.float64).replace(**kw)


def fresh_internals(x0, m=10):
    """Empty internals for a batch: a warm start that starts cold."""
    x0 = torch.from_numpy(np.asarray(x0))
    return cns.Lbfgs(m=m).init_batched(TOBJ, TOBJ.evaluate(x0))


def port_nested(x0, stopping=None, **kw):
    kw.setdefault("internals", fresh_internals(x0))
    return cns.minimize_batched(TOBJ, torch.from_numpy(np.asarray(x0)),
                                SOLVER, stopping, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def short_budget():
    x0 = np.random.default_rng(1).uniform(-2, 2, (24, 20))
    ref = jcns.minimize_batched(JOBJ, jnp.asarray(x0), JaxLbfgs(),
                                jstop(max_iterations=8), trace=6)
    return x0, ref, port_nested(x0, tstop(max_iterations=8), trace=6)


def test_short_budget_trajectory_is_exact():
    _, ref, res = short_budget()
    np.testing.assert_array_equal(res.progress.status.numpy(),
                                  np.asarray(ref.progress.status))
    np.testing.assert_array_equal(res.state.nfev.numpy(),
                                  np.asarray(ref.state.nfev))
    np.testing.assert_array_equal(res.progress.num_iterations.numpy(),
                                  np.asarray(ref.progress.num_iterations))
    np.testing.assert_allclose(res.state.x.numpy(), np.asarray(ref.state.x),
                               rtol=1e-12, atol=1e-12)
    assert res.trips >= int(res.progress.num_iterations.max())


def test_short_budget_internals_match():
    """The history, its count and gamma, and the pending pair that the
    next iteration would push."""
    _, ref, res = short_budget()
    mine, theirs = res.internals, ref.internals
    for name in ("mem_count", "pending_valid"):
        np.testing.assert_array_equal(getattr(mine, name).numpy(),
                                      np.asarray(getattr(theirs, name)))
    for name in ("s_memory", "y_memory", "gamma", "s_pending", "y_pending"):
        np.testing.assert_allclose(
            getattr(mine, name).numpy(), np.asarray(getattr(theirs, name)),
            rtol=1e-10, atol=1e-10, err_msg=name)
    assert bool(mine.pending_valid.all())


def test_trace_buffers_match():
    _, ref, res = short_budget()
    assert tuple(res.trace.value.shape) == (24, 6)
    np.testing.assert_array_equal(res.trace.status.numpy(),
                                  np.asarray(ref.trace.status))
    for name in ("value", "gradient_norm", "x_delta", "f_delta"):
        np.testing.assert_allclose(
            getattr(res.trace, name).numpy(),
            np.asarray(getattr(ref.trace, name)), rtol=1e-10, atol=1e-12,
            err_msg=name)


def test_trace_of_a_short_solve_is_self_describing():
    """Unwritten entries stay NaN / -1 (lanes that start at the optimum stop
    after one iteration)."""
    x0 = np.ones((3, 4))
    x0[1] = [-1.2, 1.0, 0.7, 0.3]
    res = port_nested(x0, trace=5)
    ref = jcns.minimize_batched(JOBJ, jnp.asarray(x0), JaxLbfgs(), trace=5)
    np.testing.assert_array_equal(res.trace.status.numpy(),
                                  np.asarray(ref.trace.status))
    assert res.trace.status[0].tolist() == [2, -1, -1, -1, -1]
    assert bool(res.trace.value[0, 1:].isnan().all())
    assert bool(res.trace.value[1].isfinite().all())


@functools.lru_cache(maxsize=None)
def full_solve():
    x0 = np.random.default_rng(2).uniform(-2, 2, (16, 8))
    ref = jcns.minimize_batched(JOBJ, jnp.asarray(x0), JaxLbfgs())
    return x0, ref, port_nested(x0)


def test_full_solve_statuses_and_counts_match():
    _, ref, res = full_solve()
    np.testing.assert_array_equal(res.progress.status.numpy(),
                                  np.asarray(ref.progress.status))
    assert abs(res.state.nfev.double().mean().item()
               - np.asarray(ref.state.nfev).mean()) < 3.0
    np.testing.assert_allclose(res.state.value.numpy(),
                               np.asarray(ref.state.value), atol=1e-6)


def test_nested_and_flat_paths_are_the_same_algorithm():
    """The port's two loops agree bit for bit on the CPU, where both run
    the same plain arithmetic."""
    x0, _, nested = full_solve()
    flat = cns.minimize_batched(TOBJ, torch.from_numpy(x0), SOLVER,
                                device="cpu")
    assert flat.trace is None and nested.trace is None
    for name in ("x", "value", "gradient", "nfev"):
        assert torch.equal(getattr(flat.state, name),
                           getattr(nested.state, name)), name
    for name in ("status", "num_iterations", "past_ring", "past_pos"):
        assert torch.equal(getattr(flat.progress, name),
                           getattr(nested.progress, name)), name
    # The nested search trips once per evaluation of its slowest lane.
    assert nested.trips >= flat.trips


def test_trace_alone_takes_the_nested_loop():
    x0, _, nested = full_solve()
    res = cns.minimize_batched(TOBJ, torch.from_numpy(x0), SOLVER, trace=3,
                               device="cpu")
    assert tuple(res.trace.value.shape) == (16, 3)
    assert torch.equal(res.state.x, nested.state.x)
    assert res.internals.pending_valid.dtype == torch.bool


def test_warm_start_matches_jax():
    """The internals of a finished solve start a second solve from another
    point: JAX's ``internals=`` against the port's, with JAX's internals
    carried across by ``from_jax_numpy``."""
    x0, ref, _ = full_solve()
    x1 = np.random.default_rng(3).uniform(-1, 1, x0.shape)
    crit = dict(max_iterations=6)
    jwarm = jcns.minimize_batched(JOBJ, jnp.asarray(x1), JaxLbfgs(),
                                  jstop(**crit), internals=ref.internals)
    internals = from_jax_numpy(jax.tree.map(np.asarray, ref.internals))
    assert isinstance(internals, cns.solvers.LbfgsInternals)
    before = tree_map(torch.clone, internals)
    twarm = port_nested(x1, tstop(**crit), internals=internals)
    np.testing.assert_array_equal(twarm.progress.status.numpy(),
                                  np.asarray(jwarm.progress.status))
    np.testing.assert_array_equal(twarm.state.nfev.numpy(),
                                  np.asarray(jwarm.state.nfev))
    np.testing.assert_allclose(twarm.state.x.numpy(),
                               np.asarray(jwarm.state.x), rtol=1e-10,
                               atol=1e-10)
    # The caller's internals are not changed by the in-place loop.
    for name, v in vars(before).items():
        assert torch.equal(v, getattr(internals, name)), name
    # And a warm start differs from a cold one.
    cold = port_nested(x1, tstop(**crit))
    assert not torch.equal(cold.state.x, twarm.state.x)


def test_minimize_with_trace_and_callback_matches_jax():
    x0 = [-1.2, 1.0]
    seen = []
    ref = jcns.minimize(jcns.models.rosenbrock(), jnp.asarray(x0),
                        JaxLbfgs(), trace=50)
    res = cns.minimize(cns.models.rosenbrock(),
                       torch.tensor(x0, dtype=torch.float64), SOLVER, trace=50, callback=seen.append, device="cpu")
    its = int(res.progress.num_iterations)
    assert its == int(ref.progress.num_iterations)
    assert int(res.state.nfev) == int(ref.state.nfev)
    assert int(res.progress.status) == int(ref.progress.status)
    assert res.state.x.shape == (2,) and res.trace.value.shape == (50,)
    assert res.internals.s_memory.shape == (10, 2)
    np.testing.assert_array_equal(res.trace.status.numpy(),
                                  np.asarray(ref.trace.status))
    # Last-bit differences compound along a trajectory: the first
    # iterations are held tightly, the whole record loosely.
    np.testing.assert_allclose(res.trace.value.numpy()[:8],
                               np.asarray(ref.trace.value)[:8],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(res.trace.value.numpy()[:its],
                               np.asarray(ref.trace.value)[:its],
                               rtol=1e-3, atol=1e-6)
    # One host call per iteration, with that iteration's figures.
    assert [int(i["num_iterations"]) for i in seen] == list(range(1, its + 1))
    assert seen[-1]["value"].shape == ()
    assert float(seen[-1]["value"]) == float(res.state.value)
    assert int(seen[-1]["status"]) == int(res.progress.status)


def test_print_progress_prints_one_line_per_iteration(capsys):
    res = cns.minimize(cns.models.rosenbrock(), torch.tensor([-1.2, 1.0]),
                       SOLVER, tstop(max_iterations=3),
                       callback=cns.print_progress, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == int(res.progress.num_iterations) == 4
    assert lines[0].startswith("iter     1  f = ")


def test_done_lane_carry_is_bit_identical():
    """The freeze contract of tests/test_freeze_contract.py: one more
    iteration applied to a carry whose lane has a terminal status returns
    that lane's whole carry (state, internals, progress) bit for bit."""
    b, n = 8, 4
    obj = cns.objective(lambda x: torch.sum(
        5.0 * x[0::2] ** 2 + 100.0 * x[1::2] ** 2) + 5.0)
    solver = cns.Lbfgs(m=5)
    x0 = torch.from_numpy(np.random.default_rng(0).uniform(-2, 2, (b, n)))
    stopping = solver.default_stopping(x0.dtype)
    state = obj.evaluate(x0)
    internals = solver.init_batched(obj, state)
    progress = cns.init_progress((b,), x0.dtype)
    for _ in range(2):
        done = progress.status != 0
        solver.step_and_update(obj, state, internals, progress, stopping,
                               done)
    assert bool((internals.mem_count > 0).all())
    done = torch.arange(b) % 2 == 0
    progress.status[done] = int(cns.Status.FINISHED)
    before = [tree_map(torch.clone, t) for t in (state, internals, progress)]
    solver.step_and_update(obj, state, internals, progress, stopping, done)
    for old, new in zip(before, (state, internals, progress)):
        for name, v in vars(old).items():
            assert torch.equal(v[done], getattr(new, name)[done]), name
    # The live lanes did move.
    assert not torch.equal(before[0].x[~done], state.x[~done])
    assert bool((progress.num_iterations[~done] == 3).all())


def test_new_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the default device is usable")
    x0 = np.random.default_rng(5).uniform(-2, 2, (3, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        cns.minimize_batched(TOBJ, torch.from_numpy(x0), SOLVER, trace=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        cns.minimize_batched(TOBJ, torch.from_numpy(x0), SOLVER,
                             internals=fresh_internals(x0))
    with pytest.raises(RuntimeError, match="CUDA"):
        cns.minimize(TOBJ, torch.from_numpy(x0[0]), SOLVER,
                     callback=cns.print_progress)
    done = cns.minimize_batched(TOBJ, torch.from_numpy(x0), SOLVER,
                                device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        cns.resume(TOBJ, done, SOLVER)
