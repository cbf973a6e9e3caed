"""Checkpoint and resume in the port, against the JAX package.

All solver state is value state, so a checkpoint is the ``MinimizeResult``
itself.  A solve interrupted at iteration k and resumed must reproduce the
uninterrupted trajectory (tests/test_checkpoint_resume.py): bit for bit
within the port, and within the parity contract against JAX when a JAX
checkpoint is carried across by ``convert.from_jax_numpy`` (status, nfev and
iteration counts exact, iterates within 1e-12 in float64).  The port's flat
batched result must go back in through ``resume`` and ``internals=`` and
continue.

One thing a resumed run does not reproduce, in the port as in the JAX
package: the iteration on which the limit fires leaves the ladder before
the plateau ring is written (progress.h's early return), so the resumed
run's ring lacks that one value and stays one slot behind.
"""

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
X0 = np.random.default_rng(11).uniform(-2, 2, (12, 10))


def jstop(**kw):
    return jcns.default_stopping(jnp.float64).replace(**kw)


def tstop(**kw):
    return cns.default_stopping(torch.float64).replace(**kw)


def same_tree(a, b):
    for name, v in vars(a).items():
        assert torch.equal(v, getattr(b, name)), name


@pytest.mark.parametrize("k", [1, 7, 15])
def test_batched_resume_reproduces_the_uninterrupted_run(k):
    x0 = torch.from_numpy(X0)
    full = cns.minimize_batched(TOBJ, x0, SOLVER, trace=1, device="cpu")
    part = cns.minimize_batched(TOBJ, x0, SOLVER, tstop(max_iterations=k),
                                trace=1, device="cpu")
    limited = part.progress.status == int(cns.Status.ITERATION_LIMIT)
    assert bool(limited.any())
    assert bool((part.progress.num_iterations[limited] == k + 1).all())
    checkpoint = tree_map(torch.clone, part)
    res = cns.resume(TOBJ, part, SOLVER, device="cpu")
    same_tree(res.state, full.state)
    same_tree(res.internals, full.internals)
    for name in ("status", "num_iterations", "x_delta", "f_delta",
                 "gradient_norm", "x_delta_violations"):
        assert torch.equal(getattr(res.progress, name),
                           getattr(full.progress, name)), name
    # The ring holds the same values bar the one the cut iteration skipped.
    assert not torch.equal(res.progress.past_ring, full.progress.past_ring)
    # The checkpoint is not changed by the in-place loop.
    for name in ("state", "progress", "internals"):
        same_tree(getattr(part, name), getattr(checkpoint, name))


def test_single_resume_reproduces_the_uninterrupted_run():
    """tests/test_checkpoint_resume.py's case on the port's ``minimize``."""
    obj = cns.models.rosenbrock()
    x0 = torch.tensor([-1.2, 1.0], dtype=torch.float64)
    full = cns.minimize(obj, x0, SOLVER, trace=1, device="cpu")
    assert int(full.progress.num_iterations) > 10
    part = cns.minimize(obj, x0, SOLVER, tstop(max_iterations=7), trace=1,
                        device="cpu")
    assert int(part.progress.num_iterations) == 8  # limit fires at k+1
    seen = []
    res = cns.resume(obj, part, SOLVER, trace=40, callback=seen.append,
                     device="cpu")
    assert res.state.x.shape == (2,) and res.trace.value.shape == (40,)
    same_tree(res.state, full.state)
    assert int(res.progress.status) == int(full.progress.status)
    assert int(res.progress.num_iterations) == int(
        full.progress.num_iterations)
    # The resumed run keeps counting: its trace and callback start at 9.
    assert int(seen[0]["num_iterations"]) == 9 and seen[0]["value"].shape == ()
    assert bool(res.trace.value[:8].isnan().all())
    assert bool(res.trace.value[8].isfinite())


def test_resume_of_a_finished_solve_is_stable():
    obj = cns.models.rosenbrock()
    full = cns.minimize(obj, torch.tensor([-1.2, 1.0], dtype=torch.float64), SOLVER,
                        device="cpu")
    res = cns.resume(obj, full, SOLVER, device="cpu")
    np.testing.assert_allclose(res.state.x.numpy(), full.state.x.numpy(),
                               atol=1e-10)
    assert int(res.progress.num_iterations) <= int(
        full.progress.num_iterations) + 1


def test_jax_single_checkpoint_resumes_to_the_jax_result():
    jobj, tobj = jcns.models.rosenbrock(), cns.models.rosenbrock()
    x0 = jnp.array([-1.2, 1.0])
    full = jcns.minimize(jobj, x0, JaxLbfgs(), jstop())
    part = jcns.minimize(jobj, x0, JaxLbfgs(), jstop(max_iterations=7),
                         trace=4)
    checkpoint = from_jax_numpy(jax.tree.map(np.asarray, part))
    assert isinstance(checkpoint, cns.MinimizeResult)
    assert isinstance(checkpoint.state, cns.FunctionState)
    assert isinstance(checkpoint.trace, cns.IterationTrace)
    assert checkpoint.internals.s_pending.shape == (2,)
    assert checkpoint.state.nfev.dtype == torch.int32
    assert checkpoint.internals.pending_valid.dtype == torch.bool
    res = cns.resume(tobj, checkpoint, SOLVER, device="cpu")
    assert int(res.progress.status) == int(full.progress.status)
    assert int(res.state.nfev) == int(full.state.nfev)
    assert int(res.progress.num_iterations) == int(
        full.progress.num_iterations)
    np.testing.assert_allclose(res.state.x.numpy(), np.asarray(full.state.x),
                               rtol=1e-12, atol=1e-12)


def test_jax_batched_checkpoint_resumes_to_the_jax_result():
    """JAX cuts a batched solve at 6 iterations; the port resumes it under a
    short budget and lands where JAX's uninterrupted solve does."""
    x0 = jnp.asarray(X0)
    budget = jcns.minimize_batched(JOBJ, x0, JaxLbfgs(),
                                   jstop(max_iterations=12))
    part = jcns.minimize_batched(JOBJ, x0, JaxLbfgs(),
                                 jstop(max_iterations=6))
    checkpoint = from_jax_numpy(jax.tree.map(np.asarray, part))
    assert checkpoint.trace is None
    assert tuple(checkpoint.internals.s_memory.shape) == (12, 10, 10)
    res = cns.resume(TOBJ, checkpoint, SOLVER, tstop(max_iterations=12),
                     device="cpu")
    np.testing.assert_array_equal(res.progress.status.numpy(),
                                  np.asarray(budget.progress.status))
    np.testing.assert_array_equal(res.state.nfev.numpy(),
                                  np.asarray(budget.state.nfev))
    np.testing.assert_array_equal(
        res.progress.num_iterations.numpy(),
        np.asarray(budget.progress.num_iterations))
    np.testing.assert_allclose(res.state.x.numpy(),
                               np.asarray(budget.state.x), rtol=1e-12,
                               atol=1e-12)


def test_flat_result_round_trips_through_resume_and_internals():
    """ROADMAP C#2: the flat solve's result is the same type as the nested
    loop's, so it goes back in through ``resume`` and through
    ``minimize_batched(internals=...)`` and the solve continues.  The flat
    loop pushes each pair at the iteration boundary, so its result has no
    pending pair; the pair of a lane cut by the iteration limit is not kept,
    and the continued run is held to the uninterrupted one by status and
    value, not bit for bit."""
    x0 = torch.from_numpy(X0)
    full = cns.minimize_batched(TOBJ, x0, SOLVER, device="cpu")
    cut = cns.minimize_batched(TOBJ, x0, SOLVER, tstop(max_iterations=9),
                               device="cpu")
    assert cut.trace is None and cut.trips > 0  # the flat path
    it = cut.internals
    assert not bool(it.pending_valid.any()) and not bool(it.s_pending.any())
    assert bool((it.mem_count == 9).all())
    limited = cut.progress.status == int(cns.Status.ITERATION_LIMIT)
    assert bool(limited.all())

    res = cns.resume(TOBJ, cut, SOLVER, device="cpu")
    assert bool((res.progress.status != int(cns.Status.CONTINUE)).all())
    assert bool((res.progress.num_iterations
                 > cut.progress.num_iterations).all())
    # Two trajectories that stop on the same test near the optimum, where
    # this objective is about 1e-5.
    np.testing.assert_array_equal(res.progress.status.numpy(),
                                  full.progress.status.numpy())
    np.testing.assert_allclose(res.state.value.numpy(),
                               full.state.value.numpy(), atol=1e-4)
    assert bool((res.state.value <= cut.state.value).all())

    warm = cns.minimize_batched(TOBJ, cut.state.x, SOLVER,
                                internals=cut.internals, device="cpu")
    np.testing.assert_array_equal(warm.progress.status.numpy(),
                                  full.progress.status.numpy())
    np.testing.assert_allclose(warm.state.value.numpy(),
                               full.state.value.numpy(), atol=1e-4)
    # The history that came back in was used: a cold start from the same
    # point takes another path.
    cold = cns.minimize_batched(TOBJ, cut.state.x, SOLVER, trace=1,
                                device="cpu")
    assert not torch.equal(cold.state.nfev, warm.state.nfev)
    # The flat result itself was not changed.
    assert bool((cut.internals.mem_count == 9).all())
    assert bool((cut.progress.status == int(cns.Status.ITERATION_LIMIT)
                 ).all())


def test_from_jax_numpy_carries_the_records_across():
    part = jcns.minimize_batched(JOBJ, jnp.asarray(X0), JaxLbfgs(),
                                 jstop(max_iterations=3), trace=2)
    trace = from_jax_numpy(jax.tree.map(np.asarray, part.trace))
    assert isinstance(trace, cns.IterationTrace)
    assert tuple(trace.value.shape) == (12, 2)
    assert trace.status.dtype == torch.int32
    state = from_jax_numpy(jax.tree.map(np.asarray, part.state))
    assert isinstance(state, cns.FunctionState)
    np.testing.assert_array_equal(state.x.numpy(), np.asarray(part.state.x))
    with pytest.raises(ValueError, match="unrecognised"):
        from_jax_numpy({"x": np.zeros(3)})
