"""The port's finite-difference checkers (``utils/derivatives.py``) against
the JAX package's, on the cases of tests/test_derivatives.py, in float64 on
the CPU: the 2-D Rosenbrock at (1.3, -0.7) and, wider, the pairwise
extended Rosenbrock at n = 8 from a numpy seed.

Both packages build the same evaluation points and evaluate the objective op
by op, so the finite gradients at accuracies 0-2 and both finite Hessians
agree with the JAX package's within 1e-12 (bit for bit here).  Accuracy 3
is the one wider bound: its 8-point sum of terms up to 672 f cancels to the
size of the gradient times 840 h, and XLA's dot product adds those eight
terms in another order than PyTorch's.  That moves every entry by the same
absolute amount, set by f and h, not by the entry: the two gradients end
4.8e-9 of their largest entry apart (the n = 8 case; 2.9e-9 on the 2-D
one), so accuracy 3 is held within 1e-8 of the largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu import utils as jutils
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch import utils as tutils

torch.set_num_threads(1)

TOL = 1e-12
GRADIENT_TOL = {0: TOL, 1: TOL, 2: TOL, 3: 1e-8}


def jpairwise(x):
    e, o = x[0::2], x[1::2]
    return jnp.sum(100.0 * (o - e**2) ** 2 + (1.0 - e) ** 2)


def tpairwise(x):
    e, o = x[0::2], x[1::2]
    return torch.sum(100.0 * (o - e**2) ** 2 + (1.0 - e) ** 2)


POINTS = {
    "rosenbrock_2d": (
        lambda: jcns.models.rosenbrock(), lambda: cns.models.rosenbrock(),
        np.array([1.3, -0.7])),
    "pairwise_rosenbrock_8": (
        lambda: jcns.objective(jpairwise, mode="second"),
        lambda: cns.objective(tpairwise, mode="second"),
        np.random.default_rng(0).uniform(-2.0, 2.0, 8)),
}


@pytest.mark.parametrize("point", sorted(POINTS))
@pytest.mark.parametrize("accuracy", [0, 1, 2, 3])
def test_finite_gradient_matches_jax_and_autodiff(point, accuracy):
    jmake, tmake, x0 = POINTS[point]
    jobj, tobj = jmake(), tmake()
    got = tutils.compute_finite_gradient(tobj.fn, torch.from_numpy(x0),
                                         accuracy).numpy()
    want = np.asarray(jutils.compute_finite_gradient(
        jobj.fn, jnp.asarray(x0), accuracy))
    tol = GRADIENT_TOL[accuracy]
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())
    np.testing.assert_allclose(
        got, tobj.gradient(torch.from_numpy(x0)).numpy(), rtol=1e-4,
        atol=1e-4)


@pytest.mark.parametrize("point", sorted(POINTS))
@pytest.mark.parametrize("accuracy", [0, 1])
def test_finite_hessian_matches_jax_and_autodiff(point, accuracy):
    jmake, tmake, x0 = POINTS[point]
    jobj, tobj = jmake(), tmake()
    got = tutils.compute_finite_hessian(tobj.fn, torch.from_numpy(x0),
                                        accuracy).numpy()
    want = np.asarray(jutils.compute_finite_hessian(
        jobj.fn, jnp.asarray(x0), accuracy))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got, got.T)
    np.testing.assert_allclose(
        got, tobj.hessian(torch.from_numpy(x0)).numpy(), rtol=1e-2,
        atol=1e-2)


@pytest.mark.parametrize("point", sorted(POINTS))
def test_checkers_accept_autodiff_as_jax_does(point):
    jmake, tmake, x0 = POINTS[point]
    jobj, tobj = jmake(), tmake()
    xt, xj = torch.from_numpy(x0), jnp.asarray(x0)
    assert tutils.is_gradient_correct(tobj, xt)
    assert tutils.is_hessian_correct(tobj, xt)
    for accuracy in range(4):
        assert tutils.is_gradient_correct(tobj, xt, accuracy) == \
            jutils.is_gradient_correct(jobj, xj, accuracy)


def test_checker_rejects_a_wrong_gradient():
    # An objective whose gradient is compared with the finite differences of
    # a different function (the reference's negative check).
    x0 = np.array([1.3, -0.7])
    fd = tutils.compute_finite_gradient(lambda x: torch.sum(x ** 3),
                                        torch.from_numpy(x0), 3)
    analytic = cns.objective(lambda x: torch.sum(x ** 2)).gradient(
        torch.from_numpy(x0))
    scale = torch.clamp(torch.maximum(fd.abs(), analytic.abs()), min=1.0)
    assert not bool(torch.all((fd - analytic).abs() <= 1e-2 * scale))
