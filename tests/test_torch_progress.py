"""The port's ``update_progress`` ladder against the JAX package's.

Each case feeds a seeded sequence of iterates, one per lane, through both
ladders step by step, with criteria that make one status fire.  Status and
counters must be equal at every step; the float records agree within 1e-15
(they are the same maxima and differences of the same float64 inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu.core.progress as jp
from cppnumericalsolvers_tpu import FunctionState as JState
from cppnumericalsolvers_tpu_torch import FunctionState, Status
from cppnumericalsolvers_tpu_torch.core import progress as tp

torch.set_num_threads(1)

B, N, STEPS = 16, 4, 12


def _sequence(kind, rng):
    """(STEPS + 1, B, N) iterates, (STEPS + 1, B) values and gradients."""
    x = np.empty((STEPS + 1, B, N))
    f = np.empty((STEPS + 1, B))
    x[0] = rng.uniform(-2, 2, (B, N))
    f[0] = rng.uniform(10, 20, B)
    g = rng.normal(0, 1, (STEPS + 1, B, N))
    for k in range(1, STEPS + 1):
        shrink = rng.uniform(0.05, 0.5, (B, 1)) ** k
        x[k] = x[k - 1] + shrink * rng.normal(0, 1, (B, N))
        f[k] = f[k - 1] - shrink[:, 0] * rng.uniform(0.1, 1, B)
    if kind == "f_delta_relative":
        f = f * 1e4
    if kind == "plateau":
        # Values stop moving after a few steps on half the lanes.
        f[4:, ::2] = f[4, ::2] + rng.uniform(0, 1e-9, (STEPS - 3, B // 2))
    if kind == "gradient_norm_relative":
        g = g * (0.3 ** np.arange(STEPS + 1))[:, None, None]
        x = x * 10.0
    return x, f, g


CRITERIA = {
    "iteration_limit": dict(max_iterations=5),
    "x_delta": dict(x_delta=1e-3, x_delta_violations=2),
    "f_delta_absolute": dict(f_delta=1e-3, f_delta_violations=1),
    "f_delta_relative": dict(f_delta=1e-6, f_delta_relative=True,
                             f_delta_violations=2),
    "plateau": dict(past=3, past_delta=1e-6),
    "gradient_norm_relative": dict(gradient_norm=1e-3,
                                   gradient_norm_relative=True),
}
FIRES = {
    "iteration_limit": Status.ITERATION_LIMIT,
    "x_delta": Status.X_DELTA_VIOLATION,
    "f_delta_absolute": Status.F_DELTA_VIOLATION,
    "f_delta_relative": Status.F_DELTA_VIOLATION,
    "plateau": Status.F_DELTA_VIOLATION,
    "gradient_norm_relative": Status.GRADIENT_NORM_VIOLATION,
}
OFF = dict(max_iterations=0, x_delta=0.0, f_delta=0.0, gradient_norm=0.0,
           past=0)


@pytest.mark.parametrize("kind", sorted(CRITERIA))
def test_ladder_matches_jax(kind):
    rng = np.random.default_rng(sorted(CRITERIA).index(kind))
    x, f, g = _sequence(kind, rng)
    fields = {**OFF, **CRITERIA[kind]}
    jcrit = jp.default_stopping(jnp.float64).replace(**fields)
    tcrit = tp.default_stopping(torch.float64).replace(**fields)

    jstep = jax.jit(jax.vmap(
        lambda pr, a, b: jp.update_progress(pr, a, b, jcrit)))
    jpr = jax.vmap(lambda _: jp.init_progress(jnp.float64))(jnp.zeros(B))
    tpr = tp.init_progress((B,), torch.float64)

    def jstate(k):
        return JState(x=jnp.asarray(x[k]), value=jnp.asarray(f[k]),
                      gradient=jnp.asarray(g[k]),
                      nfev=jnp.zeros(B, jnp.int32))

    def tstate(k):
        return FunctionState(x=torch.from_numpy(x[k]),
                             value=torch.from_numpy(f[k]),
                             gradient=torch.from_numpy(g[k]),
                             nfev=torch.zeros(B, dtype=torch.int32))

    fired = np.zeros(B, bool)
    for k in range(1, STEPS + 1):
        jpr = jstep(jpr, jstate(k - 1), jstate(k))
        tpr = tp.update_progress(tpr, tstate(k - 1), tstate(k), tcrit)
        for name in ("num_iterations", "x_delta_violations",
                     "f_delta_violations", "status", "past_pos"):
            np.testing.assert_array_equal(
                getattr(tpr, name).numpy(), np.asarray(getattr(jpr, name)),
                err_msg=f"{name} at step {k}")
        for name in ("x_delta", "f_delta", "gradient_norm", "past_ring"):
            np.testing.assert_allclose(
                getattr(tpr, name).numpy(), np.asarray(getattr(jpr, name)),
                rtol=1e-15, atol=0, err_msg=f"{name} at step {k}")
        fired |= tpr.status.numpy() == int(FIRES[kind])
    assert fired.any(), f"{kind} never fired"


def test_past_window_clamps_to_ring():
    crit = tp.default_stopping().replace(past=tp.PAST_RING_SIZE + 5)
    assert crit.past == tp.PAST_RING_SIZE == int(
        jp.default_stopping().replace(past=jp.PAST_RING_SIZE + 5).past)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_presets_match_jax(dtype):
    for name in ("default_stopping", "conservative_stopping"):
        j = getattr(jp, name)(getattr(jnp, dtype))
        t = getattr(tp, name)(getattr(torch, dtype))
        for field, value in j._asdict().items():
            want = np.asarray(value)
            got = getattr(t, field)
            if want.dtype.kind == "f":
                # The port keeps Python floats; a solve rounds them to its
                # dtype, as JAX stores them.
                assert np.asarray(got, want.dtype) == want, field
            else:
                assert got == want.item(), field
