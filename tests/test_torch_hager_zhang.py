"""The port's batched Hager-Zhang search against the JAX package's.

The cases of tests/test_hager_zhang.py (the reference's
src/test/hager_zhang_test.cc), plus the overflow recovery of
tests/test_fault_tolerance.py and a NaN pocket, go through the port as
lanes of ONE batched call and through the JAX package one instance at a
time, in float64 on the CPU.  nfev and the ok flag are exact per lane, alpha
and f agree within 1e-12.

A lane is a 1-D function embedded as ``x = (a, k)``: ``a`` is the search
variable and ``k`` picks the lane's function; the search direction is
``(sign, 0)``, so alpha indexes ``phi(alpha)`` directly.  Every function
reads ``a`` through a select of its own, so a lane that overflows cannot
reach another lane's value or gradient.  The lane that accepts its first
trial (one evaluation) sits next to the one whose first trial overflows to
inf, which runs on for dozens of batched passes: the first must come out as
its own instance does, which is what the per-lane masking of every loop is
for.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppnumericalsolvers_tpu.linesearch.hager_zhang import (
    hager_zhang as jax_hager_zhang,
)
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.linesearch import hager_zhang

torch.set_num_threads(1)

# (name, JAX phi, torch phi, start a, direction sign, alpha_init)
CASES = [
    ("convex", lambda a: a**2 - 2.0 * a, lambda a: a**2 - 2.0 * a,
     0.0, 1.0, 1.0),
    ("overflow", lambda a: jnp.exp(10.0 * a) - 20.0 * a,
     lambda a: torch.exp(10.0 * a) - 20.0 * a, 0.0, 1.0, 100.0),
    ("cubic", lambda a: a**3 - 3.0 * a + 2.0,
     lambda a: a**3 - 3.0 * a + 2.0, 0.0, 1.0, 1.0),
    ("ill_scaled", lambda a: 1e6 * a**2 - 1e6 * a + 2.5e5,
     lambda a: 1e6 * a**2 - 1e6 * a + 2.5e5, 0.0, 1.0, 1.0),
    ("flat_no_descent", lambda a: 1e-8 * a + a**4,
     lambda a: 1e-8 * a + a**4, 0.0, 1.0, 1.0),
    ("ascent", lambda a: a**2, lambda a: a**2, 1.0, 1.0, 1.0),
    ("convex_short_step", lambda a: a**2 - 2.0 * a,
     lambda a: a**2 - 2.0 * a, 0.0, 1.0, 0.1),
    ("cubic_long_step", lambda a: a**3 - 3.0 * a + 2.0,
     lambda a: a**3 - 3.0 * a + 2.0, 0.0, 1.0, 3.0),
    ("nan_pocket",
     lambda a: jnp.where(a > 1.5, jnp.nan, (a - 1.0) ** 2),
     lambda a: torch.where(a > 1.5, torch.nan, (a - 1.0) ** 2),
     -2.0, 1.0, 8.0),
    ("downhill_left", lambda a: (a + 3.0) ** 2 + 0.1 * a**4,
     lambda a: (a + 3.0) ** 2 + 0.1 * a**4, 1.0, -1.0, 1.0),
]
SAFE_A = 0.25  # what an unselected function reads


def lane_objective():
    """One objective whose lane k evaluates CASES[k]'s function of a."""

    def fn(x):
        a, k = x[0], x[1]
        out = torch.zeros_like(a)
        for j in reversed(range(len(CASES))):
            sel = k == float(j)
            aj = torch.where(sel, a, torch.full_like(a, SAFE_A))
            out = torch.where(sel, CASES[j][2](aj), out)
        return out

    return cns.objective(fn, mode="first")


def port_batch(cases=CASES):
    idx = [CASES.index(c) for c in cases]
    x0 = torch.tensor([[CASES[j][3], float(j)] for j in idx],
                      dtype=torch.float64)
    s = torch.tensor([[CASES[j][4], 0.0] for j in idx], dtype=torch.float64)
    alpha = torch.tensor([CASES[j][5] for j in idx], dtype=torch.float64)
    obj = lane_objective()
    f0, g0 = obj.batched_value_and_grad(x0)
    return obj, x0, f0, g0, s, alpha


@functools.lru_cache(maxsize=None)
def port_all():
    """The whole batch through the port, once for this module."""
    obj, x0, f0, g0, s, alpha = port_batch()
    return hager_zhang(obj.batched_value_and_grad, x0, f0, g0, s, alpha)


def jax_one(case):
    _, jfn, _, a0, sign, alpha = case
    vag = jax.value_and_grad(lambda x: jfn(x[0]))
    x = jnp.array([a0], dtype=jnp.float64)
    f0, g0 = vag(x)
    return jax_hager_zhang(vag, x, f0, g0,
                           jnp.array([sign], dtype=jnp.float64),
                           jnp.asarray(alpha, jnp.float64))


def test_every_case_as_a_lane_of_one_call():
    got = port_all()
    for k, case in enumerate(CASES):
        want = jax_one(case)
        name = case[0]
        assert int(got.nfev[k]) == int(want.nfev), name
        assert bool(got.ok[k]) == bool(want.ok), name
        np.testing.assert_allclose(float(got.alpha[k]), float(want.alpha),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(float(got.f[k]), float(want.f),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(float(got.x[k, 0]), float(want.x[0]),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    # The batch ran many passes for the overflowing lane, while the lane
    # next to it accepted its first trial with one evaluation.
    assert int(got.nfev[0]) == 1 and int(got.nfev[1]) > 10
    assert got.trips >= int(got.nfev.max())
    # The reference's observable behaviour on the fixtures
    # (hager_zhang_test.cc:102-151).
    names = [c[0] for c in CASES]
    a = dict(zip(names, got.alpha.tolist()))
    assert a["convex"] == pytest.approx(1.0, abs=1e-6)
    assert a["cubic"] == pytest.approx(1.0, abs=1e-6)
    assert a["ill_scaled"] == pytest.approx(0.5, abs=1e-6)
    assert not bool(got.ok[names.index("ascent")])
    assert a["ascent"] == 1.0
    over = names.index("overflow")
    assert np.isfinite(float(got.f[over])) and float(got.f[over]) < 1.0


def test_accepted_state_is_its_own_evaluation():
    obj, x0, f0, _, _, _ = port_batch()
    got = port_all()
    f_chk, g_chk = obj.batched_value_and_grad(got.x)
    ok = got.ok
    assert torch.equal(got.f[ok], f_chk[ok])
    assert torch.equal(got.g[ok], g_chk[ok])
    # A lane without a usable step returns its start.
    assert torch.equal(got.x[~ok], x0[~ok])
    assert torch.equal(got.f[~ok], f0[~ok])


def test_inactive_lanes_are_left_out_and_change_nothing():
    obj, x0, f0, g0, s, alpha = port_batch()
    full = port_all()
    # Out: every third lane, and the two no-descent lanes, which run the
    # whole machinery for thousands of evaluations before they give up (as
    # their instances do in the JAX package).
    names = [c[0] for c in CASES]
    active = torch.tensor([k % 3 != 1 and name not in ("flat_no_descent",
                                                         "ascent")
                           for k, name in enumerate(names)])
    part = hager_zhang(obj.batched_value_and_grad, x0, f0, g0, s, alpha,
                       active=active)
    for name in ("x", "f", "g", "alpha", "nfev", "ok"):
        assert torch.equal(getattr(part, name)[active],
                           getattr(full, name)[active]), name
    assert int(part.nfev[~active].abs().sum()) == 0
    assert part.trips <= full.trips
