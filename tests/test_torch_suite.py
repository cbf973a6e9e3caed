"""The port's MGH suite (``cppnumericalsolvers_tpu_torch/models/suite.py``)
against the JAX package's (``cppnumericalsolvers_tpu/models/suite.py``).

* The 376 benchmark instances: names, dimensions, ``f_star`` and every start
  equal bit for bit (both packages make the starts with the same numpy
  generator calls), in float64 and float32; the same for the 35-problem
  suite and its multistarts.
* Value and gradient of each of the 58 benchmark problems at every start,
  the port's ``torch.func`` evaluation against ``jax.value_and_grad``:
  float64 within rtol 1e-12 of JAX's, with an absolute floor of n * 1e-15,
  the rounding of a sum of n unit-size terms that a value near zero keeps
  (trigonometric20 at a seeded start has f = 3.85e-3, JAX's value 5.5e-15
  and the port's 4.6e-16 from the value in extended precision); float32
  within rtol 1e-5 of JAX's plus 4 times JAX's own float32 distance to its
  float64 value on the same start (at trigonometric20 float32's rounding
  alone parts the two by 5e-4).  Gradients are held per start on the scale
  of the gradient's largest entry.
* The port's counterparts of tests/test_suite.py's instance and value
  tests.

The solves are in tests/test_torch_suite_solve.py and
tests/test_torch_suite_sweeps.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppnumericalsolvers_tpu.models import suite as jsuite
from cppnumericalsolvers_tpu_torch import models
from cppnumericalsolvers_tpu_torch.models import suite as tsuite

torch.set_num_threads(1)

NAMES = [p.name for p, _ in jsuite.mgh_benchmark_instances()]
DTYPES = ["float64", "float32"]


def pairs(dtype_str):
    return zip(jsuite.mgh_benchmark_instances(dtype_str=dtype_str),
               tsuite.mgh_benchmark_instances(dtype_str=dtype_str))


@pytest.mark.parametrize("dtype_str", DTYPES)
def test_benchmark_instances_equal_jax_bit_for_bit(dtype_str):
    count = 0
    for (jp, jx), (tp, tx) in pairs(dtype_str):
        assert (tp.name, tp.f_star) == (jp.name, jp.f_star)
        assert tx.dtype == jx.dtype == np.dtype(dtype_str)
        np.testing.assert_array_equal(tp.x0, jp.x0)
        np.testing.assert_array_equal(tx, jx)
        count += tx.shape[0]
    assert count == 376
    for (jp, jx), (tp, tx) in zip(
            jsuite.suite_with_multistarts(dtype_str=dtype_str),
            tsuite.suite_with_multistarts(dtype_str=dtype_str)):
        assert (tp.name, tp.f_star) == (jp.name, jp.f_star)
        np.testing.assert_array_equal(tx, jx)
    assert [p.name for p in tsuite.mgh_suite(dtype_str)] == [
        p.name for p in jsuite.mgh_suite(dtype_str)]
    assert models.mgh_benchmark_instances is tsuite.mgh_benchmark_instances


def _value_and_grad_jax(problem, starts):
    fn = jax.jit(jax.vmap(jax.value_and_grad(problem.objective.fn)))
    f, g = fn(jnp.asarray(starts))
    return np.asarray(f), np.asarray(g)


def _value_and_grad_port(problem, starts):
    f, g = problem.objective.batched_value_and_grad(torch.from_numpy(starts))
    return f.numpy(), g.numpy()


@pytest.mark.parametrize("dtype_str", DTYPES)
@pytest.mark.parametrize("index", range(len(NAMES)), ids=NAMES)
def test_value_and_gradient_match_jax(index, dtype_str):
    (jp, jx), (tp, tx) = list(pairs(dtype_str))[index]
    jf, jg = _value_and_grad_jax(jp, jx)
    tf, tg = _value_and_grad_port(tp, tx)
    assert tf.dtype == tg.dtype == np.dtype(dtype_str)
    assert np.isfinite(tf).all() and np.isfinite(tg).all()
    n = jx.shape[1]
    if dtype_str == "float64":
        f_tol = 1e-12 * np.abs(jf) + n * 1e-15
        g_tol = 1e-12 * np.abs(jg).max(1) + n * 1e-15
    else:
        jp64 = jsuite.mgh_benchmark_instances()[index][0]
        jf64, jg64 = _value_and_grad_jax(jp64, jx.astype(np.float64))
        f_tol = 1e-5 * np.abs(jf) + 4 * np.abs(jf - jf64)
        g_tol = (1e-5 * np.abs(jg).max(1)
                 + 4 * np.abs(jg - jg64).max(1))
    np.testing.assert_array_less(np.abs(tf - jf), f_tol + 1e-300)
    np.testing.assert_array_less(np.abs(tg - jg).max(1), g_tol + 1e-300)


def test_benchmark_instances_shape_and_diversity():
    # tests/test_suite.py's: the 376 instances cover the full MGH set as
    # distinct problems, with the standard start first in every batch.
    insts = tsuite.mgh_benchmark_instances(376)
    assert sum(b.shape[0] for _, b in insts) == 376
    assert len(insts) >= 55  # 58 distinct (function, dimension) problems
    assert len({p.name for p, _ in insts}) == len(insts)
    fns = {
        p.objective.fn.func
        if isinstance(p.objective.fn, functools.partial)
        else p.objective.fn
        for p, _ in insts
    }
    assert len(fns) >= 35
    for problem, starts in insts:
        np.testing.assert_array_equal(starts[0], problem.x0)
        assert len({tuple(s.tolist()) for s in starts}) == starts.shape[0]
        assert problem.objective.mode == "second"
    with pytest.raises(ValueError, match="at least one"):
        tsuite.mgh_benchmark_instances(10)


def test_osborne2_and_linear_rank1_zero_values():
    # tests/test_suite.py's: values at the standard start against the MGH
    # residual definitions.
    by_name = {p.name: p for p in tsuite.mgh_suite("float64")}
    o2 = by_name["osborne2"]
    f0 = float(o2.objective.fn(torch.from_numpy(o2.x0)))
    assert 1.0 < f0 < 3.0
    lrz = by_name["linear_rank1_zero10"]
    expected = 2.0 + sum((44.0 * (i - 1) - 1.0) ** 2 for i in range(2, 20))
    f0 = float(lrz.objective.fn(torch.from_numpy(lrz.x0)))
    assert f0 == pytest.approx(expected, rel=1e-12)
