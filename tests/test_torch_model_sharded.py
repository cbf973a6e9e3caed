"""The port's model-axis sharding (``parallel.minimize_model_sharded``) on
W = 1, 2 and 4 gloo ranks on the CPU, N = 512 float64: the counterpart of
tests/test_model_sharded.py.

The ranks run as processes of their own (tests/torch_parallel_ranks.py).
W ranks must reproduce the world of one: status and nfev exactly, x within
1e-8 and the value within rtol 1e-10 (the JAX test's own tolerances: a
distributed reduction only reorders sums).  The world of one is bit-equal
to the unsharded ``Lbfgs(two_loop_impl="xla")`` solve.  Inside the loop
only ``all_reduce``s of one scalar a lane may run for objectives DTensor
keeps sharded; the strided Rosenbrock all-gathers x, which is documented,
and checked here as such.
"""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu.parallel import (
    minimize_model_sharded as jax_model_sharded,
)
from cppnumericalsolvers_tpu.solvers import Lbfgs as JaxLbfgs
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.parallel.model_sharded import (
    _force_xla_two_loop,
)

import torch_parallel_ranks as ranks

torch.set_num_threads(1)

N = ranks.N_MODEL
WORLDS = (1, 2, 4)
SHARDED = (2, 4)
XTOL = 1e-8
VALUE_RTOL = 1e-10


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    where = tmp_path_factory.mktemp("model_ranks")
    return {w: ranks.run_ranks("model", w, str(where / f"w{w}"))
            for w in WORLDS}


def result(rec):
    return rec["result"] if "result" in rec else rec


def records(runs, world, case):
    return [result(r[case]) for r in runs[world]]


def assert_matches(got, want):
    for key in ("status", "nfev"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(np.asarray(got["x"]), np.asarray(want["x"]),
                               rtol=0, atol=XTOL)
    np.testing.assert_allclose(np.asarray(got["value"]),
                               np.asarray(want["value"]),
                               rtol=VALUE_RTOL, atol=1e-12)


def test_world_of_one_is_bit_equal_to_the_unsharded_solve(runs):
    want = ranks.summary(cns.minimize(
        cns.objective(ranks.rosenbrock_view),
        torch.full((N,), -1.2, dtype=torch.float64),
        cns.Lbfgs(m=10, two_loop_impl="xla"), device="cpu"))
    got = records(runs, 1, "rosen_view")[0]
    for key in ("status", "nfev", "iterations", "x", "value", "gradient"):
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("case",
                         ["rosen_view", "quadratic", "gd", "uneven", "tiny"])
@pytest.mark.parametrize("world", SHARDED)
def test_sharded_matches_the_world_of_one(runs, world, case):
    want = records(runs, 1, case)[0]
    for got in records(runs, world, case):
        assert_matches(got, want)


@functools.lru_cache(maxsize=None)
def jax_rosenbrock():
    def ext_rosenbrock(x):
        even, odd = x[0::2], x[1::2]
        return jnp.sum(100.0 * (odd - even**2) ** 2 + (1.0 - even) ** 2)

    res = jax_model_sharded(
        jcns.objective(ext_rosenbrock, mode="first"), jnp.full((N,), -1.2),
        JaxLbfgs(m=10), mesh=Mesh(np.asarray(jax.devices()), ("model",)))
    return {"status": res.progress.status, "nfev": res.state.nfev,
            "x": res.state.x, "value": res.state.value}


@pytest.mark.parametrize("world", WORLDS)
def test_rosenbrock_matches_jax(runs, world):
    assert_matches(records(runs, world, "rosen_view")[0], jax_rosenbrock())


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_solve_reaches_quadratic_optimum(runs, world):
    got = runs[world][0]["quadratic"]
    assert float(got["result"]["value"]) < 1e-8
    assert float(got["result"]["x"].abs().max()) < 1e-4


@pytest.mark.parametrize("world", WORLDS)
def test_trace_records_the_first_iterations(runs, world):
    """``trace=4`` of the quadratic: the first four iterations' values,
    the world of one's within rtol 1e-10."""
    got = runs[world][0]["quadratic"]["result"]["trace_value"]
    want = runs[1][0]["quadratic"]["result"]["trace_value"]
    assert tuple(got.shape) == (4,) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=VALUE_RTOL)


def test_an_empty_shard_is_solved_with_the_rest(runs):
    """n = 9 over 4 ranks: the last rank holds no element and the solve
    still reaches the optimum, as on one rank."""
    got = records(runs, 4, "tiny")[3]
    assert tuple(got["x"].shape) == (9,)
    np.testing.assert_allclose(got["x"].numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_non_two_loop_solver_passes_through(runs, world):
    assert float(records(runs, world, "gd")[0]["value"]) < 1e-6


def test_force_xla_two_loop():
    assert _force_xla_two_loop(cns.Lbfgs(m=5)) == cns.Lbfgs(
        m=5, two_loop_impl="xla")
    gd = cns.GradientDescent()
    assert _force_xla_two_loop(gd) is gd


def test_batch_plus_model_2d_mesh(runs):
    """(8, N) split over a 2 x 2 (batch, model) mesh: every lane reaches
    the Rosenbrock minimum, as in tests/test_model_sharded.py."""
    for got in records(runs, 4, "mesh_2d"):
        assert tuple(got["value"].shape) == (8,)
        assert (got["value"].numpy() < 1e-3).all()


def test_2d_mesh_with_a_batch_the_axis_does_not_divide(runs):
    """3 lanes over a batch axis of 2: every rank gets the 3 lanes back,
    each on its optimum."""
    for got in records(runs, 4, "mesh_2d_uneven"):
        assert tuple(got["x"].shape) == (3, 64)
        np.testing.assert_allclose(got["x"].numpy(), 1.0, atol=1e-6)


def test_2d_mesh_collective_signature(runs):
    """On the 2 x 2 mesh each model group solves 4 lanes: inside the loop
    only all-reduces of 4 scalars, one a lane."""
    for r in runs[4]:
        assert set(in_loop(r["mesh_2d"])) == {("all_reduce", 4)}


@pytest.mark.parametrize("world", WORLDS)
def test_shape_validation(runs, world):
    for r in runs[world]:
        assert r["shape_1d"].startswith("x0 must be (n,) without batch_axis")
        assert r["shape_2d"].startswith("x0 must be (B, n) with batch_axis")


@pytest.mark.parametrize("world", WORLDS)
def test_unshardable_solver_raises(runs, world):
    for r in runs[world]:
        assert "not model-sharded" in r["bfgs"]


def in_loop(rec):
    """The collectives issued before the loop's last predicate read, by
    (kind, elements)."""
    return collections.Counter(
        (e["kind"], e["numel"]) for e in rec["entries"]
        if e["reads"] < rec["reads1"])


@pytest.mark.parametrize("case", ["rosen_view", "quadratic"])
@pytest.mark.parametrize("world", SHARDED)
def test_model_axis_collective_signature(runs, world, case):
    """Inside the loop only all-reduces of one scalar per lane (B = 1):
    the partial dot products and norms, and the objective's value; never a
    gather of x or of the history, which stay sharded."""
    for r in runs[world]:
        counts = in_loop(r[case])
        assert set(counts) == {("all_reduce", 1)}, counts
        # The objective's value is one of them, at every evaluation.
        assert counts[("all_reduce", 1)] > int(r[case]["result"]["nfev"])


@pytest.mark.parametrize("world", SHARDED)
def test_strided_objective_all_gathers(runs, world):
    """``x[0::2]`` cannot be taken from a shard: DTensor all-gathers x
    (one rank's shard each) at every evaluation, as the module says."""
    shard = N // world
    for r in runs[world]:
        counts = in_loop(r["rosen_strided"])
        assert counts[("all_gather", shard)] >= 2
        assert set(counts) <= {("all_gather", shard), ("all_reduce", 1)}
