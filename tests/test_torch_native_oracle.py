"""The port's numerics against the native C++ oracle, through the port's own
binding (``cppnumericalsolvers_tpu_torch/utils/native.py``): the
counterpart of tests/test_native_oracle.py.

The oracle (native/cppns_oracle.cc) reimplements MINPACK ``cstep`` and a
set of MGH gradients independently of both JAX and the port, so these
tests hold the port to the C++ reference directly, not through the JAX
package.  Tolerances are the JAX test's: cstep's float fields within rtol
1e-12 (the step within rtol 1e-10, atol 1e-12), the MGH values within rtol
1e-10 and the gradients within rtol 1e-8, atol 1e-10.
"""

import zlib

import numpy as np
import pytest
import torch

from cppnumericalsolvers_tpu_torch.linesearch.more_thuente import cstep
from cppnumericalsolvers_tpu_torch.models.suite import mgh_suite
from cppnumericalsolvers_tpu_torch.utils.native import (
    MGH_ORACLE_IDS,
    load_oracle,
)

torch.set_num_threads(1)

oracle = load_oracle()
pytestmark = pytest.mark.skipif(
    oracle is None, reason="no C++ toolchain for the native oracle"
)

FIELDS = ("stx", "sty", "fx", "fy", "dx", "dy")


def _random_cstep_inputs(rng):
    """A valid cstep input state (descent at stx, trial ordered): the JAX
    test's generator, draw for draw."""
    stx = rng.uniform(0.0, 1.0)
    dx = -rng.uniform(0.1, 2.0)
    stp = stx + rng.uniform(0.01, 2.0)
    fx = rng.uniform(-1.0, 1.0)
    fp = fx + rng.uniform(-0.5, 1.0)
    dp = rng.uniform(-2.0, 2.0)
    brackt = bool(rng.integers(0, 2))
    if brackt:
        sty = stp + rng.uniform(0.05, 1.0)
        stp = stx + rng.uniform(0.05, 0.95) * (sty - stx)
    else:
        sty = stx
    fy = rng.uniform(-1.0, 1.0) if brackt else fx
    dy = rng.uniform(-2.0, 2.0) if brackt else dx
    stpmin, stpmax = 0.0, 10.0
    return stx, fx, dx, sty, fy, dy, stp, fp, dp, brackt, stpmin, stpmax


def _port_cstep(args):
    *floats, brackt, stpmin, stpmax = args
    t = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    return cstep(*(t(v) for v in floats), torch.tensor(brackt), t(stpmin),
                 t(stpmax))


def test_cstep_matches_oracle_randomized():
    rng = np.random.default_rng(0)
    checked = 0
    for _ in range(500):
        args = _random_cstep_inputs(rng)
        info_c, out_c = oracle.cstep(*args)
        state = _port_cstep(args)
        assert info_c == int(state.info), (args, info_c, int(state.info))
        if info_c == 0:
            continue  # input error: both return the state untouched
        checked += 1
        for f in FIELDS:
            np.testing.assert_allclose(float(getattr(state, f)), out_c[f],
                                       rtol=1e-12, err_msg=f)
        np.testing.assert_allclose(float(state.stp), out_c["stp"],
                                   rtol=1e-10, atol=1e-12)
        assert bool(state.brackt) == out_c["brackt"]
    assert checked > 300  # the generator must mostly produce valid states


@pytest.mark.parametrize("name", sorted(MGH_ORACLE_IDS))
def test_mgh_gradients_match_oracle(name):
    """The port's suite objectives' values and ``torch.func`` gradients
    against the hand-derived C++ gradients, at ten points around the
    standard start (a seed from the name's CRC-32: the JAX test's
    ``hash(name)`` changes with every interpreter)."""
    problem = next(p for p in mgh_suite("float64") if p.name == name)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    for _ in range(10):
        x = problem.x0 * (1.0 + rng.uniform(-0.3, 0.3, problem.x0.shape))
        f_c, g_c = oracle.mgh(name, torch.from_numpy(x))
        xt = torch.from_numpy(x)
        f_t = float(problem.objective.value(xt))
        g_t = problem.objective.gradient(xt).numpy()
        np.testing.assert_allclose(f_t, f_c, rtol=1e-10)
        np.testing.assert_allclose(g_t, np.asarray(g_c), rtol=1e-8,
                                   atol=1e-10)


def test_mgh_rejects_a_wrong_width():
    with pytest.raises(ValueError, match="takes 2 values"):
        oracle.mgh("rosenbrock", np.zeros(3))
