"""The done-lane freeze contract of tests/test_freeze_contract.py, through
the port.

The port's iteration-granular loop runs one loop over batched carries and
applies its body to every lane; finished lanes are left alone only because
the body freezes them.  Applied to a carry whose lane is done, the body must
return that lane's whole carry (state, solver internals, progress)
bit-identical, for every solver: L-BFGS through its fused step (each of the
three searches) and through the generic step it freezes itself
(``freeze_in_step``, the Hessian-condition criterion's path), L-BFGS-B
through the generic body with its stopping hooks and the internals it
freezes itself, every other solver through the generic body's select of the
whole carry.

Two live iterations give the internals real content first.  The live lanes
are held to the JAX package's body (``core.driver._make_body``, vmapped) on
the same inputs, in float64 on the CPU: statuses and nfev exact, iterates
within 1e-11.  (The 5-iteration contract's 1e-12 is held in
tests/test_torch_solvers_parity.py; on this 20:1 scaled quadratic BFGS's
rank-2 updates take the last-bit differences between the packages' batched
matrix products to 1.5e-12 in three iterations.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppnumericalsolvers_tpu import objective as jax_objective
from cppnumericalsolvers_tpu import solvers as jsolvers
from cppnumericalsolvers_tpu.core.driver import _make_body
from cppnumericalsolvers_tpu.core.progress import (
    init_progress as jax_init_progress,
)
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.core.driver import _generic_iteration
from cppnumericalsolvers_tpu_torch.core.tree import tree_map

torch.set_num_threads(1)

B, N = 8, 4

# (id, class name, keyword arguments, cond(H) criterion on)
SOLVERS = [
    ("lbfgs", "Lbfgs", {"m": 5}, False),
    ("lbfgs_hz", "Lbfgs", {"m": 5, "line_search": "hager_zhang"}, False),
    ("lbfgs_armijo", "Lbfgs", {"m": 5, "line_search": "armijo"}, False),
    ("lbfgs_generic", "Lbfgs", {"m": 5}, True),
    ("bfgs", "Bfgs", {}, False),
    ("gd", "GradientDescent", {}, False),
    ("cg", "ConjugateGradientDescent", {}, False),
    ("newton", "NewtonDescent", {}, False),
    ("tr", "TrustRegionNewton", {}, False),
    ("tr_hessian_free", "TrustRegionNewton", {"hessian_free": True}, False),
    ("nm", "NelderMead", {}, False),
    ("lbfgsb", "Lbfgsb", {"m": 3, "lower": -1.5, "upper": 1.0}, False),
]


def jquad(x):
    return jnp.sum(5.0 * x[0::2] ** 2 + 100.0 * x[1::2] ** 2) + 5.0


def tquad(x):
    return torch.sum(5.0 * x[0::2] ** 2 + 100.0 * x[1::2] ** 2) + 5.0


def leaves(tree):
    out = []
    tree_map(lambda t: out.append(t), tree)
    return out


def port_body(obj, solver, stopping, cond_h):
    def body(state, internals, progress):
        done = progress.status != int(cns.Status.CONTINUE)
        if not cond_h and solver.supports_fused_update(obj):
            state, internals, progress, _ = solver.step_and_update(
                obj, state, internals, progress, stopping, done)
            return state, internals, progress
        state, internals, progress, _ = _generic_iteration(
            obj, solver, state, internals, progress,
            solver.transform_stopping(stopping), done, cond_h, stopping)
        return state, internals, progress

    return body


@pytest.mark.parametrize("sid,cls,kw,cond_h", SOLVERS,
                         ids=[s[0] for s in SOLVERS])
def test_done_lane_carry_bit_identical(sid, cls, kw, cond_h):
    tsolver = getattr(cns, cls)(**kw)
    jsolver = getattr(jsolvers, cls)(**kw)
    mode = "second" if (tsolver.mode == "second" or cond_h) else "first"
    tobj = cns.objective(tquad, mode=mode)
    jobj = jax_objective(jquad, mode=mode)
    x0 = np.random.default_rng(0).uniform(-2.0, 2.0, (B, N))
    extra = {"condition_hessian": 1e9} if cond_h else {}
    tstop = tsolver.default_stopping(torch.float64).replace(**extra)
    jstop = jsolver.default_stopping(jnp.float64).replace(**extra)

    body = port_body(tobj, tsolver, tstop, cond_h)
    state = tobj.evaluate(torch.tensor(x0))  # the steps work in place
    internals = tsolver.init_batched(tobj, state)
    progress = cns.init_progress((B,), torch.float64, torch.device("cpu"))
    carry = body(state, internals, progress)
    carry = body(*carry)
    state, internals, progress = carry
    done = torch.from_numpy(np.arange(B) % 2 == 0)
    progress.status = torch.where(
        done, torch.full_like(progress.status, int(cns.Status.FINISHED)),
        progress.status)
    before = tuple(tree_map(torch.clone, t)
                   for t in (state, internals, progress))
    out = body(state, internals, progress)
    before_leaves = leaves(before)
    out_leaves = leaves(tuple(out))
    assert len(before_leaves) == len(out_leaves) > 0
    for i, (a, b) in enumerate(zip(before_leaves, out_leaves)):
        assert torch.equal(a[done], b[done]), f"{sid} leaf {i} not frozen"

    # The same three applications of the JAX package's body.
    jbody = jax.jit(jax.vmap(_make_body(jobj, jsolver, jstop, None, cond_h)))
    jstate = jax.vmap(lambda x: jobj.evaluate(x, nfev=0))(jnp.asarray(x0))
    jint = jax.vmap(lambda s: jsolver.init(jobj, s))(jstate)
    jprog = jax.vmap(lambda _: jax_init_progress(jnp.float64))(jnp.arange(B))
    jcarry = jbody(jbody((jstate, jint, jprog, None)))
    jstate, jint, jprog, _ = jcarry
    jprog = jprog._replace(status=jnp.where(
        jnp.asarray(done.numpy()), jnp.int32(int(cns.Status.FINISHED)),
        jprog.status))
    jstate, _, jprog, _ = jbody((jstate, jint, jprog, None))
    got_state, _, got_progress = out
    np.testing.assert_array_equal(got_progress.status.numpy(),
                                  np.asarray(jprog.status))
    np.testing.assert_array_equal(got_state.nfev.numpy(),
                                  np.asarray(jstate.nfev))
    np.testing.assert_allclose(got_state.x.numpy(), np.asarray(jstate.x),
                               rtol=1e-11, atol=1e-11)
