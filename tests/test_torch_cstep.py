"""The port's ``cstep`` and trial setup against the JAX package's.

Both compute all four MINPACK interpolation cases and select, in the same
operation order.  The cases of tests/test_cstep.py and the input-error case
are bit-equal in float64 (tolerance 0), and so is the trial setup.

Seeded random inputs that reach every case, bracketed or not, are bit-equal
in the case codes and the bracket flag, and in the float fields on at least
99% of the inputs.  The rest differ by a few ulps, because PyTorch's float64
``sqrt`` on the CPU is not correctly rounded (about 0.8% of uniform inputs
come out one ulp away from IEEE ``sqrt``, which XLA and CUDA give); the
divisions after the sqrt in ``cstep`` amplify that one ulp, so the float
fields are held to 1e-13 relative to ``max(1, |value|)``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppnumericalsolvers_tpu.linesearch import cstep as jax_cstep
from cppnumericalsolvers_tpu.ops.fused_linesearch import (
    _trial_setup as jax_trial_setup,
)
from cppnumericalsolvers_tpu_torch.linesearch import cstep, trial_setup

torch.set_num_threads(1)

FIELDS = ("stx", "fx", "dx", "sty", "fy", "dy", "stp", "brackt", "info")

# (stx, fx, dx, sty, fy, dy, stp, fp, dp, brackt, stpmin, stpmax), the
# cases of tests/test_cstep.py.
CASES = {
    "case1_quadratic": (0.0, 0.0, -1.0, 0.0, 0.0, 0.0, 3.0, 1.5, 2.0,
                        False, 0.0, 10.0),
    "case2_sign_flip": (0.0, 2.0, -2.0, 0.0, 0.0, 0.0, 3.0, 0.5, 1.0,
                        False, 0.0, 10.0),
    "case3_not_bracketed": (0.0, 8.0, -4.0, 0.0, 0.0, 0.0, 1.0, 4.5, -3.0,
                            False, 0.0, 20.0),
    "case4_extrapolates": (0.0, 5.0, -1.0, 0.0, 0.0, 0.0, 1.0, 3.99, -1.03,
                           False, 0.0, 50.0),
    "clamp": (0.0, 0.0, -1.0, 0.0, 0.0, 0.0, 3.0, 1.5, 2.0,
              False, 0.1, 0.75),
    "safeguard_066": (0.0, 0.0, -1.0, 1.0, 0.5, 1.5, 0.99, 0.49, 1.4,
                      True, 0.0, 2.0),
    "input_error": (0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.5, 0.5,
                    False, 0.0, 10.0),
}


def _both(args):
    """Run both packages on numpy arrays of one shape; numpy results."""
    *floats, brackt, stpmin, stpmax = args
    j = jax_cstep(*(jnp.asarray(v) for v in floats), jnp.asarray(brackt),
                  jnp.asarray(stpmin), jnp.asarray(stpmax))
    t = cstep(*(torch.as_tensor(v) for v in floats), torch.as_tensor(brackt),
              torch.as_tensor(stpmin), torch.as_tensor(stpmax))
    return ({f: np.asarray(getattr(j, f)) for f in FIELDS},
            {f: getattr(t, f).numpy() for f in FIELDS})


def _assert_bit_equal(j, t):
    for f in FIELDS:
        np.testing.assert_array_equal(t[f], j[f], err_msg=f)
        if f not in ("brackt", "info"):
            assert t[f].dtype == np.float64


@pytest.mark.parametrize("name", sorted(CASES))
def test_cases_bit_equal(name):
    args = [np.asarray(v, np.float64) if not isinstance(v, bool)
            else np.asarray(v) for v in CASES[name]]
    j, t = _both(args)
    _assert_bit_equal(j, t)
    if name == "input_error":
        assert int(t["info"]) == 0 and float(t["stp"]) == 1.0


def _random_inputs(seed, size=4000):
    rng = np.random.default_rng(seed)
    stx = rng.uniform(-1, 1, size)
    stp = stx + rng.choice([-1.0, 1.0], size) * rng.uniform(1e-3, 2.0, size)
    sty = stx + rng.uniform(-2, 2, size)
    fx, fy, fp = (rng.normal(0, 1, size) for _ in range(3))
    # Slope at stx mostly of descent towards stp; some zero and some of the
    # wrong sign to reach sign(0) and the input-error path.
    dx = -np.sign(stp - stx) * rng.uniform(0, 3, size)
    dx[rng.uniform(size=size) < 0.05] = 0.0
    flip = rng.uniform(size=size) < 0.1
    dx[flip] = -dx[flip]
    dy, dp = rng.normal(0, 2, size), rng.normal(0, 2, size)
    dp[rng.uniform(size=size) < 0.05] = 0.0
    tie = rng.uniform(size=size) < 0.05
    fp[tie] = fx[tie]
    brackt = rng.uniform(size=size) < 0.5
    lo, hi = np.minimum(stx, sty), np.maximum(stx, sty)
    stpmin = np.where(brackt, lo, stx)
    stpmax = np.where(brackt, hi, stp + 4.0 * (stp - stx))
    return [stx, fx, dx, sty, fy, dy, stp, fp, dp, brackt, stpmin, stpmax]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_cases_match(seed):
    args = _random_inputs(seed)
    j, t = _both(args)
    same = np.ones(args[0].shape, bool)
    for f in FIELDS:
        if f in ("brackt", "info"):
            np.testing.assert_array_equal(t[f], j[f], err_msg=f)
            continue
        a, b = t[f], j[f]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
        ok = np.isnan(b) | (np.abs(a - b) <= 1e-13 * np.maximum(1, np.abs(b)))
        assert ok.all(), (f, np.flatnonzero(~ok)[:5])
        same &= (a == b) | np.isnan(b)
    assert same.mean() >= 0.99
    # The draw reaches every interpolation case and the input error.
    assert set(np.unique(t["info"])) == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("seed", [0, 1])
def test_trial_setup_bit_equal(seed):
    rng = np.random.default_rng(seed)
    size = 2000
    stp = rng.uniform(-1e-14, 3, size)
    stx = rng.uniform(0, 2, size)
    sty = rng.uniform(0, 2, size)
    brackt = rng.uniform(size=size) < 0.5
    nfev = rng.integers(0, 21, size).astype(np.int32)
    infoc = rng.integers(0, 5, size).astype(np.int32)
    j = jax_trial_setup(jnp.asarray(stp), jnp.asarray(stx), jnp.asarray(sty),
                        jnp.asarray(brackt), jnp.asarray(nfev),
                        jnp.asarray(infoc), 20)
    t = trial_setup(torch.as_tensor(stp), torch.as_tensor(stx),
                    torch.as_tensor(sty), torch.as_tensor(brackt),
                    torch.as_tensor(nfev), torch.as_tensor(infoc), 20)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
