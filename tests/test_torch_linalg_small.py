"""The port's unrolled Gauss-Jordan solves (``utils/linalg.py``) against the
JAX package's, on the cases of tests/test_linalg_small.py, batched.

Both eliminate with the same partial pivoting in the same order, so on the
same numpy-seeded float64 inputs they agree within 1e-12 (and with numpy's
LAPACK solve within the JAX tests' own tolerances).  The port takes a batch
of systems in one call, where the JAX package vmaps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppnumericalsolvers_tpu.utils.linalg import (
    invert_small as jax_invert_small,
    solve_small as jax_solve_small,
)
from cppnumericalsolvers_tpu_torch.utils.linalg import invert_small, solve_small

torch.set_num_threads(1)

TOL = 1e-12


def port(fn, *arrays):
    return fn(*(torch.from_numpy(np.asarray(a)) for a in arrays)).numpy()


@pytest.mark.parametrize("k", [1, 2, 5, 10, 20])
def test_solve_matches_jax_and_numpy(k):
    rng = np.random.default_rng(k)
    a = rng.standard_normal((k, k))
    b = rng.standard_normal((k,))
    got = port(solve_small, a, b)
    want = np.asarray(jax_solve_small(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, np.linalg.solve(a, b), rtol=1e-9,
                               atol=1e-10)


def test_solve_needs_pivoting():
    # A zero leading pivot: elimination without pivoting divides by zero.
    a = np.array([[0.0, 1.0], [1.0, 0.0]])
    b = np.array([2.0, 3.0])
    np.testing.assert_allclose(port(solve_small, a, b), [3.0, 2.0],
                               atol=1e-12)


def test_solve_multi_rhs_and_inverse():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((8, 8)) + 4.0 * np.eye(8)
    b = rng.standard_normal((8, 3))
    got = port(solve_small, a, b)
    want = np.asarray(jax_solve_small(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    inv = port(invert_small, a)
    np.testing.assert_allclose(
        inv, np.asarray(jax_invert_small(jnp.asarray(a))), rtol=TOL,
        atol=TOL)
    np.testing.assert_allclose(inv, np.linalg.inv(a), rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("rhs", ["vector", "matrix", "inverse"])
def test_batch_in_one_call_matches_vmapped_jax(rhs):
    # Rows with pivots in every position: each system of the batch takes
    # its own row swaps.
    rng = np.random.default_rng(4)
    a = rng.standard_normal((16, 6, 6)) + 3.0 * np.eye(6)
    a[::3] = a[::3, ::-1]
    if rhs == "inverse":
        got = port(invert_small, a)
        want = np.asarray(jax.vmap(jax_invert_small)(jnp.asarray(a)))
        np.testing.assert_allclose(got, np.linalg.inv(a), rtol=1e-8,
                                   atol=1e-9)
    else:
        b = rng.standard_normal((16, 6) if rhs == "vector" else (16, 6, 2))
        got = port(solve_small, a, b)
        want = np.asarray(jax.vmap(jax_solve_small)(jnp.asarray(a),
                                                    jnp.asarray(b)))
        lapack = (np.linalg.solve(a, b[..., None])[..., 0]
                  if rhs == "vector" else np.linalg.solve(a, b))
        np.testing.assert_allclose(got, lapack, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_singular_propagates_nonfinite():
    got = port(solve_small, np.zeros((3, 3)), np.ones((3,)))
    assert not np.isfinite(got).all()
    # One singular system of a batch leaves the others finite.
    a = np.stack([np.zeros((3, 3)), np.eye(3)])
    got = port(solve_small, a, np.ones((2, 3)))
    assert not np.isfinite(got[0]).all()
    np.testing.assert_array_equal(got[1], np.ones(3))
