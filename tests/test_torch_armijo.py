"""The port's batched Armijo backtracking against the JAX package's.

Each case goes through the port as a lane of ONE batched call and through
the JAX package's per-instance ``armijo`` alone, in float64 on the CPU: nfev
exact per lane, alpha within 1e-12.  The cases cover an immediate accept,
long backtracks, the alpha floor (about 175 steps), the ``max_iters`` cap of
the second-order variant (which has no floor), a trial that overflows to
inf next to lanes that accept at once, and a NaN trial (whose comparison is
false, so the lane stops).  A lane is the 1-D function of
``x = (a, k)`` that ``k`` picks, as in tests/test_torch_hager_zhang.py.

Also here: the value of ``Objective.batched_value`` equals the value of
``batched_value_and_grad`` to the bit (Armijo's trials are value-only, the
accepted point's evaluation is not).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cppnumericalsolvers_tpu.linesearch.armijo import armijo as jax_armijo
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.linesearch import armijo

torch.set_num_threads(1)

# (name, JAX phi, torch phi, start a, direction, alpha_init, curvature)
CASES = [
    ("accept_at_once", lambda a: a**2 - 2.0 * a, lambda a: a**2 - 2.0 * a,
     0.0, 1.0, 1.0, None),
    ("overflow", lambda a: jnp.exp(10.0 * a) - 20.0 * a,
     lambda a: torch.exp(10.0 * a) - 20.0 * a, 0.0, 1.0, 100.0, None),
    ("steep", lambda a: 1e6 * (a - 0.5) ** 2,
     lambda a: 1e6 * (a - 0.5) ** 2, 0.0, 1.0, 1.0, None),
    ("alpha_floor", lambda a: a**2, lambda a: a**2, 1.0, 1.0, 1.0, None),
    ("curvature", lambda a: 3.0 * a**2 - a, lambda a: 3.0 * a**2 - a,
     1.0, -5.0, 1.0, 6.0 * 25.0),
    ("cap_without_floor", lambda a: a**2, lambda a: a**2, 1.0, 1.0, 1.0,
     2.0),
    ("nan_trial", lambda a: jnp.where(a > 0.5, jnp.nan, a**2),
     lambda a: torch.where(a > 0.5, torch.nan, a**2), 0.0, 1.0, 1.0, None),
    ("accept_short", lambda a: (a - 2.0) ** 2, lambda a: (a - 2.0) ** 2,
     0.0, 1.0, 0.5, None),
]
SAFE_A = 0.25


def lane_objective():
    def fn(x):
        a, k = x[0], x[1]
        out = torch.zeros_like(a)
        for j in reversed(range(len(CASES))):
            sel = k == float(j)
            aj = torch.where(sel, a, torch.full_like(a, SAFE_A))
            out = torch.where(sel, CASES[j][2](aj), out)
        return out

    return cns.objective(fn, mode="first")


def jax_one(case, with_curvature):
    _, jfn, _, a0, d, alpha, curv = case
    vag = jax.value_and_grad(lambda x: jfn(x[0]))
    x = jnp.array([a0], dtype=jnp.float64)
    f0, g0 = vag(x)
    return jax_armijo(lambda x: jfn(x[0]), x, f0, g0,
                      jnp.array([d], dtype=jnp.float64), alpha,
                      curvature_term=curv if with_curvature else None)


@functools.lru_cache(maxsize=None)
def port_run(with_curvature: bool):
    """Every case as a lane of one call: with the second-order threshold
    (the lanes that have a curvature; the others are inactive) or without
    it (every lane, the curvature ignored)."""
    x0 = torch.tensor([[c[3], float(k)] for k, c in enumerate(CASES)],
                      dtype=torch.float64)
    d = torch.tensor([[c[4], 0.0] for c in CASES], dtype=torch.float64)
    alpha = torch.tensor([c[5] for c in CASES], dtype=torch.float64)
    obj = lane_objective()
    f0, g0 = obj.batched_value_and_grad(x0)
    kw = {}
    if with_curvature:
        kw["curvature_term"] = torch.tensor(
            [c[6] or 0.0 for c in CASES], dtype=torch.float64)
        kw["active"] = torch.tensor([c[6] is not None for c in CASES])
    return armijo(obj.batched_value, x0, f0, g0, d, alpha, **kw)


def check_lanes(with_curvature):
    got = port_run(with_curvature)
    for k, case in enumerate(CASES):
        if with_curvature and case[6] is None:
            assert int(got.nfev[k]) == 0, case[0]
            continue
        want = jax_one(case, with_curvature)
        assert int(got.nfev[k]) == int(want.nfev), case[0]
        np.testing.assert_allclose(float(got.alpha[k]), float(want.alpha),
                                   rtol=1e-12, atol=1e-12, err_msg=case[0])
    return got


def test_first_order_lanes_match_the_jax_package():
    got = check_lanes(False)
    nfev = dict(zip([c[0] for c in CASES], got.nfev.tolist()))
    assert nfev["accept_at_once"] == 1 and nfev["nan_trial"] == 1
    assert nfev["overflow"] > 40
    # 0.9^k falls below the 1e-8 floor after 175 steps.
    assert nfev["alpha_floor"] == 176
    assert got.trips == int(got.nfev.max())


def test_second_order_lanes_match_the_jax_package():
    got = check_lanes(True)
    nfev = dict(zip([c[0] for c in CASES], got.nfev.tolist()))
    # No floor: the cap of 200 backtracking steps ends the lane.
    assert nfev["cap_without_floor"] == 201
    assert nfev["curvature"] >= 1


def test_value_only_evaluation_equals_the_value_of_value_and_grad():
    obj = cns.models.pairwise_rosenbrock()
    x = torch.from_numpy(np.random.default_rng(4).uniform(-2, 2, (64, 10)))
    v, _ = obj.batched_value_and_grad(x)
    assert torch.equal(obj.batched_value(x), v)
    assert torch.equal(obj.value(x[3]), v[3])
