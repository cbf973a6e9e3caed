"""The port's two-loop ops against the JAX package.

``two_loop_direction`` and ``lbfgs_push_and_direction`` of
``cppnumericalsolvers_tpu_torch/ops/two_loop.py`` run on the CPU, where the
wrappers take their plain versions, on inputs made with numpy from a seed:

* float64, against ``two_loop_direction_xla``, ``push_history_xla`` and the
  JAX package's ``lbfgs_push_and_direction``: integer outputs exact, floats
  within rtol 1e-12 (the tolerance of tests/test_two_loop.py);
* float32, against ``two_loop_pallas_batched`` and
  ``push_two_loop_pallas_batched`` in interpret mode: integer outputs exact,
  floats within rtol 2e-4 / atol 2e-5 (two orders of summation, amplified
  by the recursion; the tolerance of tests_tpu/test_two_loop_tpu.py).

The fused op works in place; a lane with ``valid = False`` keeps every bit
of its history, count and gamma.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppnumericalsolvers_tpu.ops import two_loop as jtl
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.ops import _kernel
from cppnumericalsolvers_tpu_torch.ops import two_loop as ttl

torch.set_num_threads(1)

TOL = {np.float64: dict(rtol=1e-12, atol=0.0),
       np.float32: dict(rtol=2e-4, atol=2e-5)}
NAMES = ("direction", "s_memory", "y_memory", "mem_count", "gamma")


def t(a):
    return torch.from_numpy(np.array(a))


def history(rng, b, m, n, dtype):
    """Histories of mixed counts (0, partly filled, full), the rows below the
    count with positive curvature (``y`` near ``s``, as a solve's pairs are,
    so that float32 results stay comparable); lane 2's newest row has
    ``s.y = 0`` (a row the recursion must skip)."""
    counts = rng.integers(0, m + 1, b).astype(np.int32)
    counts[:3] = (0, m, max(m // 2, 1))
    s = np.zeros((b, m, n))
    y = np.zeros((b, m, n))
    for lane in range(b):
        for r in range(counts[lane]):
            s[lane, r] = 0.1 * rng.normal(size=n)
            y[lane, r] = s[lane, r] + 0.05 * rng.normal(size=n)
    y[2, counts[2] - 1] = 0.0
    return s.astype(dtype), y.astype(dtype), counts


def direction_case(seed, dtype, b=13, m=6, n=37):
    rng = np.random.default_rng(seed)
    s, y, counts = history(rng, b, m, n, dtype)
    g = rng.normal(size=(b, n)).astype(dtype)
    gamma = rng.uniform(0.5, 2.0, b).astype(dtype)
    return g, s, y, counts, gamma


def push_case(seed, dtype, b=11, m=6, n=37):
    """The inputs of tests/test_two_loop.py's fused test: mixed curvature
    signs (some lanes reject the pair), mixed validity, two zero pairs; lane
    1 is full and valid (its history shifts), lane 3 is invalid."""
    rng = np.random.default_rng(seed)
    g, s, y, counts, gamma = direction_case(seed, dtype, b, m, n)
    s_new = rng.normal(size=(b, n))
    y_new = rng.normal(size=(b, n))
    flip = rng.random(b) < 0.5
    flip[1] = True
    y_new[flip] = -np.sign(np.einsum("bn,bn->b", s_new, y_new))[
        flip, None] * y_new[flip]
    y_new[1] = np.abs(y_new[1]) * np.sign(s_new[1])
    valid = rng.random(b) < 0.8
    valid[1], valid[3] = True, False
    s_new[-2:] = 0.0
    y_new[-2:] = 0.0
    return (g, s, y, counts, gamma, s_new.astype(dtype),
            y_new.astype(dtype), valid)


def jax_direction(args):
    return jax.vmap(
        lambda g, s, y, c, ga: jtl.two_loop_direction_xla(g, s, y, c, ga,
                                                          None)
    )(*(jnp.asarray(a) for a in args))


def jax_push(args):
    def one(g, s, y, c, ga, sn, yn, v):
        s2, y2, c2, ga2 = jtl.push_history_xla(s, y, c, ga, sn, yn, v)
        return (jtl.two_loop_direction_xla(g, s2, y2, c2, ga2, None), s2, y2,
                c2, ga2)

    return jax.vmap(one)(*(jnp.asarray(a) for a in args))


def check_push(args, want, got, dtype):
    for name, w, o in zip(NAMES, want, got):
        w = np.asarray(w)
        if name == "mem_count":
            np.testing.assert_array_equal(o, w, err_msg=name)
        else:
            np.testing.assert_allclose(o, w, err_msg=name, **TOL[dtype])
    # valid = False: every bit of history, count and gamma stays.
    off = ~args[7]
    assert off.any()
    for k, name in ((1, "s_memory"), (2, "y_memory"), (3, "mem_count"),
                    (4, "gamma")):
        np.testing.assert_array_equal(got[NAMES.index(name)][off],
                                      args[k][off], err_msg=name)
    m = args[1].shape[1]
    assert got[3][1] == m  # the pinned full lane shifted and stayed full
    np.testing.assert_array_equal(got[1][1, -1], args[5][1])
    np.testing.assert_array_equal(got[1][1, 0], args[1][1, 1])


def run_push(args):
    ta = [t(a) for a in args]
    out = ttl.lbfgs_push_and_direction(*ta)
    # In place: the last four outputs are the tensors that went in.
    assert all(out[k] is ta[k] for k in (1, 2, 3, 4))
    return [o.numpy() for o in out]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_two_loop_direction_matches_jax_xla_float64(seed):
    args = direction_case(seed, np.float64)
    got = ttl.two_loop_direction(*(t(a) for a in args)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_direction(args)),
                               **TOL[np.float64])
    # Count 0: the direction is gamma * g.
    np.testing.assert_allclose(got[0], args[4][0] * args[0][0], rtol=1e-15)


@pytest.mark.parametrize("shape", [(13, 6, 37), (16, 10, 128), (8, 5, 64)])
def test_two_loop_direction_matches_pallas_interpret_float32(shape):
    args = direction_case(5, np.float32, *shape)
    want = jtl.two_loop_pallas_batched(*(jnp.asarray(a) for a in args),
                                       interpret=True)
    got = ttl.two_loop_direction(*(t(a) for a in args)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), **TOL[np.float32])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_push_and_direction_matches_jax_xla_float64(seed):
    args = push_case(seed, np.float64)
    check_push(args, jax_push(args), run_push(args), np.float64)


def test_push_and_direction_matches_jax_public_op_float64():
    args = push_case(4, np.float64)
    want = jax.vmap(jtl.lbfgs_push_and_direction)(
        *(jnp.asarray(a) for a in args))
    check_push(args, want, run_push(args), np.float64)


@pytest.mark.parametrize("shape", [(11, 6, 37), (16, 10, 128), (8, 5, 64)])
def test_push_and_direction_matches_pallas_interpret_float32(shape):
    args = push_case(7, np.float32, *shape)
    want = jtl.push_two_loop_pallas_batched(
        *(jnp.asarray(a) for a in args), interpret=True)
    got = run_push(args)
    assert got[0].dtype == np.float32
    check_push(args, want, got, np.float32)


def test_unbatched_calls_match_the_batched_lane():
    args = push_case(9, np.float64)
    want_d = ttl.two_loop_direction(*(t(a) for a in args[:5])).numpy()
    want = run_push(args)
    for lane in (0, 1, 3, 5):
        one = [t(a[lane]) for a in args]
        d = ttl.two_loop_direction(*one[:5])
        assert d.shape == (args[0].shape[1],)
        np.testing.assert_array_equal(d.numpy(), want_d[lane])
        ref = jtl.two_loop_direction(*(jnp.asarray(a[lane]) for a in
                                       args[:5]))
        np.testing.assert_allclose(d.numpy(), np.asarray(ref), rtol=1e-12)
        out = ttl.lbfgs_push_and_direction(*one)
        assert out[1] is one[1] and out[3] is one[3]  # in place
        for name, o, w in zip(NAMES, out, want):
            np.testing.assert_array_equal(o.numpy(), w[lane], err_msg=name)
        ref = jtl.lbfgs_push_and_direction(*(jnp.asarray(a[lane])
                                             for a in args))
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]),
                                   rtol=1e-12)
        assert int(out[3]) == int(ref[3])


def test_preconditioned_reference_matches_jax_xla():
    args = direction_case(6, np.float64)
    precond = np.random.default_rng(6).uniform(0.1, 3.0, args[0].shape)
    want = jax.vmap(jtl.two_loop_direction_xla)(
        *(jnp.asarray(a) for a in args), jnp.asarray(precond))
    got = ttl.two_loop_direction_reference(*(t(a) for a in args),
                                           t(precond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_wrappers_on_cpu_take_the_plain_versions_and_check_arguments():
    args = [t(a) for a in push_case(4, np.float64)]
    g, s, y, count, gamma, sn, yn, valid = args
    ref = ttl.two_loop_direction_reference(g, s, y, count, gamma)
    np.testing.assert_array_equal(
        ttl.two_loop_direction(g, s, y, count, gamma).numpy(), ref.numpy())
    assert ttl.two_loop_direction.launches == 0
    assert ttl.lbfgs_push_and_direction.launches == 0
    assert cns.solvers.two_loop_direction is ttl.two_loop_direction
    with pytest.raises(ValueError, match="mem_count"):
        ttl.two_loop_direction(g, s, y, count.long(), gamma)
    with pytest.raises(ValueError, match="contiguous"):
        ttl.two_loop_direction(
            g, s.transpose(1, 2).contiguous().transpose(1, 2), y, count,
            gamma)
    with pytest.raises(ValueError, match="valid"):
        ttl.lbfgs_push_and_direction(g, s, y, count, gamma, sn, yn,
                                     valid.to(torch.int32))
    with pytest.raises(ValueError, match="y_new"):
        ttl.lbfgs_push_and_direction(g, s, y, count, gamma, sn, yn[:, :4],
                                     valid)
    with pytest.raises(TypeError):
        ttl.two_loop_direction(g.half(), s.half(), y.half(), count,
                               gamma.half())
    # q (n values) and O(m) scratch must fit a block's shared memory.
    _kernel.check_smem("two_loop_direction", 10, 4096, 8)
    with pytest.raises(ValueError, match="shared memory"):
        _kernel.check_smem("two_loop_direction", 10, 40000, 8)
