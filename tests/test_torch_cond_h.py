"""The Hessian-condition criterion and the generic L-BFGS step in the port,
against the JAX package.

``core/driver.py`` evaluates cond(H) for a second-mode objective whose
criterion is on (``stopping.condition_hessian > 0``), billed as one
evaluation per iteration, and ``update_progress`` fires ``HESSIAN_CONDITION_VIOLATION`` on
it; such a solve takes the generic loop body over ``Lbfgs.step``.  Inputs are
made with numpy from a seed and go through both packages on the CPU in
float64: statuses, nfev and iteration counts exact, floats within 1e-12
(1e-9 for cond(H) of one matrix, the product of two norms of an inverse;
1e-6 for cond(H) at the end of a solve, where it multiplies the iterates'
last-bit differences by the conditioning itself).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu.core.objective import (
    FunctionState as JaxFunctionState,
)
from cppnumericalsolvers_tpu.core.progress import (
    ProgressState as JaxProgressState,
    update_progress as jax_update_progress,
)
from cppnumericalsolvers_tpu.solvers import Lbfgs as JaxLbfgs
from cppnumericalsolvers_tpu.utils.linalg import (
    frobenius_condition as jax_frobenius_condition,
)
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.core.progress import update_progress
from cppnumericalsolvers_tpu_torch.core.tree import tree_map
from cppnumericalsolvers_tpu_torch.ops import two_loop as ttl
from cppnumericalsolvers_tpu_torch.utils import (
    condition_test_enabled,
    frobenius_condition,
)

torch.set_num_threads(1)

HCV = int(cns.Status.HESSIAN_CONDITION_VIOLATION)


def t(a):
    return torch.from_numpy(np.array(a))


def jstop(**kw):
    return jcns.default_stopping(jnp.float64).replace(**kw)


def tstop(**kw):
    return cns.default_stopping(torch.float64).replace(**kw)


def jax_rosen(x):
    e, o = x[0::2], x[1::2]
    return jnp.sum(100.0 * (o - e**2) ** 2 + (1.0 - e) ** 2)


def jax_ill(x):
    return 0.5 * (x[0] ** 2 + 1e8 * x[1] ** 2)


def torch_ill(x):
    return 0.5 * (x[0] ** 2 + 1e8 * x[1] ** 2)


# -- update_progress ---------------------------------------------------------


def progress_case(seed, b=12, n=5):
    rng = np.random.default_rng(seed)
    prev = dict(x=rng.standard_normal((b, n)), value=rng.standard_normal(b),
                gradient=rng.standard_normal((b, n)),
                nfev=np.ones(b, np.int32))
    cur = dict(x=prev["x"] + 0.1 * rng.standard_normal((b, n)),
               value=prev["value"] - np.abs(rng.standard_normal(b)),
               gradient=rng.standard_normal((b, n)),
               nfev=np.full(b, 3, np.int32))
    # Lanes 0-2 converge on the gradient-norm rung first: the Hessian rung
    # is the last of the ladder and must not overrule it.
    cur["gradient"][:3] *= 1e-9
    zi = np.zeros(b, np.int32)
    progress = dict(
        num_iterations=rng.integers(1, 5, b).astype(np.int32),
        x_delta=np.zeros(b), x_delta_violations=zi.copy(),
        f_delta=np.zeros(b), f_delta_violations=zi.copy(),
        gradient_norm=np.zeros(b), condition_hessian=np.zeros(b),
        status=zi.copy(), past_ring=rng.standard_normal((b, 8)),
        past_pos=rng.integers(0, 3, b).astype(np.int32),
    )
    cond = rng.uniform(1.0, 2e4, b)
    return prev, cur, progress, cond


@pytest.mark.parametrize("threshold", [0.0, 1e4])
def test_update_progress_condition_hessian_matches_jax(threshold):
    prev, cur, progress, cond = progress_case(3)
    want = jax.vmap(
        lambda p, a, c, h: jax_update_progress(
            p, a, c, jstop(condition_hessian=threshold), mode="second",
            condition_hessian=h)
    )(JaxProgressState(**{k: jnp.asarray(v) for k, v in progress.items()}),
      JaxFunctionState(**{k: jnp.asarray(v) for k, v in prev.items()}),
      JaxFunctionState(**{k: jnp.asarray(v) for k, v in cur.items()}),
      jnp.asarray(cond))
    got = update_progress(
        cns.ProgressState(**{k: t(v) for k, v in progress.items()}),
        cns.FunctionState(**{k: t(v) for k, v in prev.items()}),
        cns.FunctionState(**{k: t(v) for k, v in cur.items()}),
        tstop(condition_hessian=threshold), mode="second",
        condition_hessian=t(cond))
    for name, w in want._asdict().items():
        w = np.asarray(w)
        o = getattr(got, name).numpy()
        if w.dtype.kind in "ib":
            np.testing.assert_array_equal(o, w, err_msg=name)
        else:
            np.testing.assert_allclose(o, w, rtol=1e-12, atol=1e-12,
                                       err_msg=name)
    # The metric is stored whether or not the criterion is on.
    np.testing.assert_array_equal(got.condition_hessian.numpy(), cond)
    fired = got.status.numpy() == HCV
    if threshold > 0:
        np.testing.assert_array_equal(
            fired, (cond > threshold) & (np.arange(12) >= 3))
        assert fired.any() and not fired.all()
    else:
        assert not fired.any()


def test_update_progress_without_the_metric_stores_zero():
    prev, cur, progress, _ = progress_case(4)
    got = update_progress(
        cns.ProgressState(**{k: t(v) for k, v in progress.items()}),
        cns.FunctionState(**{k: t(v) for k, v in prev.items()}),
        cns.FunctionState(**{k: t(v) for k, v in cur.items()}),
        tstop(condition_hessian=1.0))
    assert not got.condition_hessian.any()
    assert not (got.status == HCV).any()


# -- frobenius_condition -----------------------------------------------------


def test_frobenius_condition_matches_jax_and_handles_singular():
    rng = np.random.default_rng(0)
    h = rng.standard_normal((6, 4, 4))
    h = h + np.swapaxes(h, 1, 2)
    h[1] = np.outer(np.arange(1.0, 5.0), np.arange(1.0, 5.0))  # rank one
    h[2] = 0.0
    want = np.asarray(jax.vmap(jax_frobenius_condition)(jnp.asarray(h)))
    got = frobenius_condition(t(h)).numpy()
    big = np.finfo(np.float64).max
    regular = [0, 3, 4, 5]
    np.testing.assert_allclose(got[regular], want[regular], rtol=1e-9)
    # A singular matrix has no finite inverse: the dtype's largest value
    # (exactly singular), or a figure beyond any usable criterion.
    assert got[2] == big == want[2]
    assert got[1] > 1e15 and want[1] > 1e15
    one = frobenius_condition(t(h[0]))
    assert one.shape == () and float(one) == got[0]
    f32 = frobenius_condition(torch.zeros((3, 3), dtype=torch.float32))
    assert f32.dtype == torch.float32
    assert float(f32) == float(np.finfo(np.float32).max)
    assert condition_test_enabled(tstop(condition_hessian=2.0))
    assert not condition_test_enabled(tstop())


def test_objective_hessian_matches_jax_and_needs_second_mode():
    x = np.random.default_rng(1).uniform(-2, 2, (5, 6))
    want = jax.vmap(jax.hessian(jax_rosen))(jnp.asarray(x))
    obj = cns.models.pairwise_rosenbrock()
    got = obj.hessian(t(x))
    assert tuple(got.shape) == (5, 6, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(obj.hessian(t(x[2])).numpy(),
                                  got[2].numpy())
    with pytest.raises(ValueError, match="second"):
        obj.with_mode("first").hessian(t(x))


# -- the criterion through the drivers ---------------------------------------


def test_hessian_condition_solver_independent_lbfgs_both_packages():
    """tests/test_progress.py's case: an L-BFGS solve of a second-mode
    objective with the criterion on ends on it in both packages, with the
    same status, nfev and iteration count; with the criterion off it costs
    no evaluation."""
    x0 = [1.0, 1.0]
    jobj = jcns.objective(jax_ill, mode="second")
    tobj = cns.objective(torch_ill, mode="second")
    ref = jcns.minimize(jobj, jnp.asarray(x0), JaxLbfgs(),
                        jstop(condition_hessian=1e4))
    res = cns.minimize(tobj, torch.tensor(x0, dtype=torch.float64),
                       cns.Lbfgs(), tstop(condition_hessian=1e4),
                       device="cpu")
    assert int(ref.progress.status) == HCV
    assert int(res.progress.status) == HCV
    assert float(res.progress.condition_hessian) > 1e4
    np.testing.assert_allclose(float(res.progress.condition_hessian),
                               float(ref.progress.condition_hessian),
                               rtol=1e-9)
    assert int(res.state.nfev) == int(ref.state.nfev)
    assert int(res.progress.num_iterations) == int(
        ref.progress.num_iterations)
    np.testing.assert_allclose(res.state.x.numpy(), np.asarray(ref.state.x),
                               rtol=1e-12, atol=1e-12)

    # Criterion off (the default): nfev of a first-mode solve, in both.
    x0t = torch.tensor(x0, dtype=torch.float64)
    off = cns.minimize(tobj, x0t, cns.Lbfgs(), device="cpu")
    first = cns.minimize(cns.objective(torch_ill, mode="first"), x0t,
                         cns.Lbfgs(), device="cpu")
    ref_off = jcns.minimize(jobj, jnp.asarray(x0), JaxLbfgs())
    assert int(off.state.nfev) == int(first.state.nfev)
    assert int(off.state.nfev) == int(ref_off.state.nfev)
    assert int(off.progress.status) != HCV
    assert int(off.progress.status) == int(ref_off.progress.status)
    assert float(off.progress.condition_hessian) == 0.0
    # A first-mode objective never pays for the criterion either.
    first_on = cns.minimize(cns.objective(torch_ill, mode="first"), x0t,
                            cns.Lbfgs(), tstop(condition_hessian=1e4),
                            device="cpu")
    assert int(first_on.state.nfev) == int(first.state.nfev)


X0 = np.random.default_rng(31).uniform(-2, 2, (24, 8))
THRESHOLD = 3e4  # between the lanes' cond(H) along their ways


def test_batched_criterion_fires_on_some_lanes_and_matches_jax():
    jobj = jcns.objective(jax_rosen, mode="second")
    tobj = cns.models.pairwise_rosenbrock()
    ref = jcns.minimize_batched(jobj, jnp.asarray(X0), JaxLbfgs(),
                                jstop(condition_hessian=THRESHOLD), trace=4)
    res = cns.minimize_batched(tobj, t(X0), cns.Lbfgs(),
                               tstop(condition_hessian=THRESHOLD), trace=4,
                               device="cpu")
    status = res.progress.status.numpy()
    fired = status == HCV
    assert fired.any() and not fired.all()
    np.testing.assert_array_equal(status, np.asarray(ref.progress.status))
    np.testing.assert_array_equal(res.state.nfev.numpy(),
                                  np.asarray(ref.state.nfev))
    np.testing.assert_array_equal(res.progress.num_iterations.numpy(),
                                  np.asarray(ref.progress.num_iterations))
    np.testing.assert_allclose(res.progress.condition_hessian.numpy(),
                               np.asarray(ref.progress.condition_hessian),
                               rtol=1e-6)
    assert (res.progress.condition_hessian.numpy()[fired] > THRESHOLD).all()
    # A solve run to its end: the full-solve contract (within 1e-6).
    np.testing.assert_allclose(res.state.x.numpy(), np.asarray(ref.state.x),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(res.trace.status.numpy(),
                                  np.asarray(ref.trace.status))
    # A fresh untraced solve with the criterion on takes the same loop, not
    # the flat solve, which knows nothing of the criterion.
    fresh = cns.minimize_batched(tobj, t(X0), cns.Lbfgs(),
                                 tstop(condition_hessian=THRESHOLD),
                                 device="cpu")
    assert fresh.trace is None
    np.testing.assert_array_equal(fresh.progress.status.numpy(), status)
    assert torch.equal(fresh.state.x, res.state.x)
    # resume carries the criterion through as well.
    cut = cns.minimize_batched(
        tobj, t(X0), cns.Lbfgs(),
        tstop(condition_hessian=THRESHOLD, max_iterations=2), device="cpu")
    again = cns.resume(tobj, cut, cns.Lbfgs(),
                       tstop(condition_hessian=THRESHOLD), device="cpu")
    assert (again.progress.status.numpy() == HCV).any()
    assert (again.state.nfev >= cut.state.nfev).all()


# -- Lbfgs.step --------------------------------------------------------------


def jax_batched_step(solver, jobj, state, internals, done):
    return jax.vmap(
        lambda s, i, d: solver.step(jobj, s, i, jstop(), done=d)
    )(state, internals, done)


def compare_step(jstate, jint, tstate, tint, tol=1e-12):
    for name in ("x", "value", "gradient"):
        np.testing.assert_allclose(
            getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)),
            rtol=tol, atol=tol, err_msg=name)
    np.testing.assert_array_equal(tstate.nfev.numpy(),
                                  np.asarray(jstate.nfev))
    for name in ("mem_count", "pending_valid"):
        np.testing.assert_array_equal(getattr(tint, name).numpy(),
                                      np.asarray(getattr(jint, name)),
                                      err_msg=name)
    for name in ("s_memory", "y_memory", "gamma", "s_pending", "y_pending"):
        np.testing.assert_allclose(
            getattr(tint, name).numpy(), np.asarray(getattr(jint, name)),
            rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("precond", [False, True])
def test_lbfgs_step_matches_jax_with_done_lanes(precond):
    b, n, m = 10, 6, 4
    x0 = np.random.default_rng(7).uniform(-2, 2, (b, n))
    # Lane 0 starts at the optimum: zero gradient, no descent direction
    # (the steepest-descent fallback), and a search that cannot move (the
    # stall reset).
    x0[0] = 1.0
    jobj = jcns.objective(jax_rosen, mode="second")
    tobj = cns.models.pairwise_rosenbrock()
    jsolver = JaxLbfgs(m=m, use_hessian_preconditioner=precond)
    tsolver = cns.Lbfgs(m=m, use_hessian_preconditioner=precond)
    jstate = jax.vmap(lambda x: jobj.evaluate(x, nfev=0))(jnp.asarray(x0))
    jint = jax.vmap(lambda s: jsolver.init(jobj, s))(jstate)
    tstate = tobj.evaluate(t(x0))
    tint = tsolver.init_batched(tobj, tstate)
    launches = ttl.lbfgs_push_and_direction.launches
    for it in range(6):
        # From the third iteration on, every third lane is done.
        done = (np.arange(b) % 3 == 1) & (it >= 2)
        before_state = tree_map(torch.clone, tstate)
        before = tree_map(torch.clone, tint)
        jnew, jint = jax_batched_step(jsolver, jobj, jstate, jint,
                                      jnp.asarray(done))
        tnew, tint, trips = tsolver.step(tobj, tstate, tint, tstop(),
                                         done=t(done))
        assert trips >= 1
        # The step does not change the state it was given.
        for name, v in vars(before_state).items():
            assert torch.equal(v, getattr(tstate, name)), name
        compare_step(jnew, jint, tnew, tint)
        # A done lane's internals come back bit-identical.
        for name, v in vars(before).items():
            assert torch.equal(v[done], getattr(tint, name)[done]), name
        # The minimize loop freezes the state of done lanes.
        jstate = jax.tree.map(
            lambda old, new: jnp.where(
                jnp.asarray(done).reshape((-1,) + (1,) * (old.ndim - 1)),
                old, new), jstate, jnew)
        tstate = cns.core.tree.tree_where(t(done), tstate, tnew)
    assert int(tint.mem_count.max()) == m
    assert int(tint.mem_count[0]) == 0  # the stalled lane's history is reset
    assert ttl.lbfgs_push_and_direction.launches == launches == 0


def test_hessian_preconditioner_solve_matches_jax():
    x0 = np.random.default_rng(8).uniform(-2, 2, (6, 4))
    jobj = jcns.objective(jax_rosen, mode="second")
    tobj = cns.models.pairwise_rosenbrock()
    crit = dict(max_iterations=6)
    ref = jcns.minimize_batched(
        jobj, jnp.asarray(x0), JaxLbfgs(use_hessian_preconditioner=True),
        jstop(**crit))
    res = cns.minimize_batched(
        tobj, t(x0), cns.Lbfgs(use_hessian_preconditioner=True),
        tstop(**crit), device="cpu")
    np.testing.assert_array_equal(res.progress.status.numpy(),
                                  np.asarray(ref.progress.status))
    np.testing.assert_array_equal(res.state.nfev.numpy(),
                                  np.asarray(ref.state.nfev))
    np.testing.assert_array_equal(res.progress.num_iterations.numpy(),
                                  np.asarray(ref.progress.num_iterations))
    np.testing.assert_allclose(res.state.x.numpy(), np.asarray(ref.state.x),
                               rtol=1e-10, atol=1e-10)
    # One Hessian per iteration is billed on top of the search's evaluations.
    plain = cns.minimize_batched(tobj, t(x0), cns.Lbfgs(), tstop(**crit),
                                 trace=1, device="cpu")
    assert not torch.equal(plain.state.x, res.state.x)
    with pytest.raises(ValueError, match="second-mode"):
        cns.minimize_batched(
            tobj.with_mode("first"), t(x0),
            cns.Lbfgs(use_hessian_preconditioner=True), device="cpu")
