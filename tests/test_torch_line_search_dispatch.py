"""Pluggable line searches through the port, against the JAX package.

Every solver that takes a ``line_search`` runs with each of the three
searches (the reference's LineSearch template parameter, lbfgs.h:40-41,
bfgs.h:39-40, gradient_descent.h:37-38), in float64 on the CPU, and must
end as the JAX package's solve does: the same status, nfev within 3, the
value within 1e-6 (the full-solve contract).  L-BFGS and BFGS solve the
2-D Rosenbrock from (-1.2, 1), as tests/test_line_search_dispatch.py does.
Gradient descent solves a weighted quadratic from eight starts: on the
Rosenbrock valley its thousands of zigzag steps amplify the last-bit
differences between XLA's sums and PyTorch's (from (-1.2, 1) the port and
JAX end 5,573 against 3,702 evaluations apart with More-Thuente, 10,686
against 15,208 with Hager-Zhang, on the same status), and with Armijo it
takes 563,138 evaluations there, too many for this suite.

Also: the unknown-search error, and ``line_search_alpha``, the alpha-only
overload that evaluates the start itself and bills it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu import models as jmodels
from cppnumericalsolvers_tpu import solvers as jsolvers
from cppnumericalsolvers_tpu.linesearch import (
    line_search_alpha as jax_line_search_alpha,
)
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.linesearch import line_search_alpha
from cppnumericalsolvers_tpu_torch.ops import flat_solve as fs

torch.set_num_threads(1)

SEARCHES = ["more_thuente", "hager_zhang", "armijo"]


def jq2(x):
    return jnp.sum((x - 1.0) ** 2 * jnp.arange(1.0, x.shape[0] + 1))


def tq2(x):
    w = torch.arange(1.0, x.shape[0] + 1, dtype=x.dtype)
    return torch.sum((x - 1.0) ** 2 * w)


@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("solver_name", ["Lbfgs", "Bfgs", "GradientDescent"])
def test_solver_with_search_matches_the_jax_package(solver_name, search):
    jsolver = getattr(jsolvers, solver_name)(line_search=search)
    tsolver = getattr(cns, solver_name)(line_search=search)
    if solver_name == "GradientDescent":
        # Eight starts: Hager-Zhang's bisections near the optimum stop on a
        # test relative to machine epsilon, so single lanes may end a few
        # evaluations apart; the contract holds the mean.
        x0 = np.random.default_rng(2).uniform(-2.0, 2.0, (8, 2))
        want = jcns.minimize_batched(
            jcns.objective(jq2), jnp.asarray(x0), jsolver,
            jcns.conservative_stopping(jnp.float64))
        got = cns.minimize_batched(
            cns.objective(tq2), torch.from_numpy(x0), tsolver,
            cns.conservative_stopping(torch.float64), device="cpu")
    else:
        want = jcns.minimize(jmodels.rosenbrock(), jnp.asarray([-1.2, 1.0]),
                             jsolver)
        before = fs.flat_trip.launches
        got = cns.minimize(cns.models.rosenbrock(),
                           torch.tensor([-1.2, 1.0], dtype=torch.float64),
                           tsolver, device="cpu")
        assert fs.flat_trip.launches == before
        assert float(got.state.value) < 1e-4
    np.testing.assert_array_equal(got.progress.status.numpy(),
                                  np.asarray(want.progress.status))
    assert abs(float(got.state.nfev.double().mean())
               - float(np.asarray(want.state.nfev).mean())) <= 3
    np.testing.assert_allclose(got.state.value.numpy(),
                               np.asarray(want.state.value), rtol=0,
                               atol=1e-6)


def test_unknown_search_raises():
    with pytest.raises(ValueError, match="unknown line search"):
        cns.minimize(cns.models.rosenbrock(),
                     torch.tensor([-1.2, 1.0], dtype=torch.float64),
                     cns.Lbfgs(line_search="nope"), device="cpu")
    with pytest.raises(ValueError, match="unknown line search"):
        cns.minimize(cns.models.rosenbrock(),
                     torch.tensor([-1.2, 1.0], dtype=torch.float64),
                     cns.GradientDescent(line_search="nope"), device="cpu")


@pytest.mark.parametrize("search", SEARCHES)
def test_alpha_only_overload(search):
    """Only (x0, direction) are given: the start is evaluated and billed,
    the step decreases f, and (x, f, g) are at the accepted step; the
    batched call agrees with its single-instance form and with JAX's."""
    x0 = np.array([2.0, -3.0])

    def jquad_half(x):
        return 0.5 * jnp.sum(x * x)

    obj = cns.objective(lambda x: 0.5 * torch.sum(x * x))
    direction = -x0
    want = jax_line_search_alpha(search, jax.value_and_grad(jquad_half),
                                 jnp.asarray(x0), jnp.asarray(direction),
                                 alpha_init=1.0)
    got = line_search_alpha(search, obj.batched_value_and_grad,
                            torch.from_numpy(x0),
                            torch.from_numpy(direction), alpha_init=1.0)
    assert got.x.shape == (2,) and got.nfev.dim() == 0
    assert int(got.nfev) == int(want.nfev) >= 2
    np.testing.assert_allclose(float(got.alpha), float(want.alpha),
                               rtol=1e-12)
    assert float(got.f) < 0.5 * float(np.sum(x0 * x0))
    np.testing.assert_allclose(got.x.numpy(),
                               x0 + float(got.alpha) * direction,
                               rtol=0, atol=1e-12)
    batch = line_search_alpha(
        search, obj.batched_value_and_grad,
        torch.from_numpy(np.stack([x0, 2 * x0])),
        torch.from_numpy(np.stack([direction, 2 * direction])))
    assert torch.equal(batch.x[0], got.x)
    assert int(batch.nfev[0]) == int(got.nfev)
    assert batch.trips >= int(batch.nfev.max())
