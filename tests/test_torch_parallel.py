"""The port's batch-sharded solve (``parallel.minimize_sharded``) on W = 2
and 4 gloo ranks on the CPU, float64: the counterpart of
tests/test_parallel.py and tests/test_scaling_efficiency.py.

Each rank is a process of its own (tests/torch_parallel_ranks.py, one
``FileStore`` rendezvous in a temporary directory, no TCP port), runs every
case and saves what it got.  The records are held:

* against the unsharded port per lane: status, nfev and iterations exact,
  x within 1e-12 (each rank solves its lanes with the same batched driver);
* against the JAX package's ``minimize_sharded`` on its 8-device CPU mesh,
  by the full-solve contract: per-lane status equal, mean nfev within 3,
  values within 1e-6;
* for the collectives: none inside the loop (every one is issued after the
  loop's last predicate read), then one ``all_gather`` a result leaf and
  one ``all_reduce`` of ``trips``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu import solvers as jsolvers
from cppnumericalsolvers_tpu.parallel import (
    aggregate_metrics as jax_metrics,
    make_mesh as jax_mesh,
    minimize_sharded as jax_sharded,
)
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.core.tree import tree_map
from cppnumericalsolvers_tpu_torch.parallel import aggregate_metrics

import torch_parallel_ranks as ranks

torch.set_num_threads(1)

WORLDS = (2, 4)
XTOL = 1e-12
FULL_TOL = 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    where = tmp_path_factory.mktemp("batch_ranks")
    return {w: ranks.run_ranks("batch", w, str(where / f"w{w}"))
            for w in WORLDS}


@functools.lru_cache(maxsize=None)
def unsharded(case):
    """The same solve without ranks."""
    if case == "lbfgs":
        return ranks.summary(cns.minimize_batched(
            cns.models.rosenbrock(), torch.from_numpy(ranks.batch_start()),
            cns.Lbfgs(), device="cpu"))
    return ranks.summary(cns.minimize_batched(
        cns.models.pairwise_rosenbrock(),
        torch.from_numpy(ranks.box_start()),
        cns.Lbfgsb(m=5, lower=0.5, upper=4.0), device="cpu"))


def assert_same_lanes(got, want):
    for key in ("status", "nfev", "iterations"):
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(),
                                      err_msg=key)
    np.testing.assert_allclose(got["x"].numpy(), want["x"].numpy(), rtol=0,
                               atol=XTOL)


def each_rank(runs, world, case):
    out = [r[case] for r in runs[world]]
    return [o["result"] if isinstance(o, dict) and "result" in o else o
            for o in out]


@pytest.mark.parametrize("case", ["lbfgs", "lbfgsb"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_unsharded_port(runs, world, case):
    for got in each_rank(runs, world, case):
        assert_same_lanes(got, unsharded(case))


def test_lbfgsb_lanes_stay_in_the_box(runs):
    x = each_rank(runs, 4, "lbfgsb")[0]["x"].numpy()
    assert (x >= 0.5).all() and (x <= 4.0).all()


@functools.lru_cache(maxsize=None)
def jax_result():
    return jax_sharded(jcns.models.rosenbrock(),
                       jnp.asarray(ranks.batch_start()), jsolvers.Lbfgs(),
                       mesh=jax_mesh(8))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_jax(runs, world):
    want = jax_result()
    got = each_rank(runs, world, "lbfgs")[0]
    np.testing.assert_array_equal(got["status"].numpy(),
                                  np.asarray(want.progress.status))
    assert abs(float(got["nfev"].double().mean())
               - float(np.asarray(want.state.nfev).mean())) <= 3.0
    np.testing.assert_allclose(got["value"].numpy(),
                               np.asarray(want.state.value), rtol=0,
                               atol=FULL_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_aggregate_metrics(runs, world):
    want = jax_metrics(jax_result())
    for got in (r["metrics"] for r in runs[world]):
        assert set(got) == set(want)
        assert got["converged_pct"] == want["converged_pct"] == 100.0
        assert got["total_instances"] == want["total_instances"] == 32
        assert abs(got["mean_nfev"] - want["mean_nfev"]) <= 3.0
        assert abs(got["mean_iterations"] - want["mean_iterations"]) <= 3.0


def test_aggregate_metrics_of_a_local_result():
    res = cns.minimize_batched(
        cns.models.rosenbrock(), torch.from_numpy(ranks.batch_start()),
        cns.Lbfgs(), device="cpu")
    m = aggregate_metrics(res)
    assert m["total_instances"] == 32 and m["converged_pct"] == 100.0
    assert m["mean_nfev"] == float(res.state.nfev.double().mean())


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_rejects_indivisible_batch(runs, world):
    for msg in each_rank(runs, world, "indivisible"):
        assert msg is not None and "not divisible" in msg


@pytest.mark.parametrize("world", WORLDS)
def test_per_lane_iteration_counts_are_independent(runs, world):
    for got in each_rank(runs, world, "easy_hard"):
        iters = got["iterations"].numpy()
        assert (iters[0::2] <= 2).all()  # easy lanes stop immediately
        assert (iters[1::2] > 5).all()  # hard lanes actually ran


def _leaves(res):
    """The tensor leaves a gathered result has, counted."""
    count = []
    tree_map(lambda t: count.append(t), res)
    return len(count)


@pytest.mark.parametrize("case", ["lbfgs", "lbfgsb"])
@pytest.mark.parametrize("world", WORLDS)
def test_no_collective_inside_the_loop(runs, world, case):
    solver = (cns.Lbfgs() if case == "lbfgs"
              else cns.Lbfgsb(m=5, lower=0.5, upper=4.0))
    x0 = (ranks.batch_start() if case == "lbfgs" else ranks.box_start())
    obj = (cns.models.rosenbrock() if case == "lbfgs"
           else cns.models.pairwise_rosenbrock())
    local = cns.minimize_batched(obj, torch.from_numpy(x0[:2]), solver,
                                 device="cpu")
    leaves = sum(_leaves(t) for t in (local.state, local.progress,
                                      local.internals))
    for rec in (r[case] for r in runs[world]):
        assert rec["reads1"] > rec["reads0"]  # the loop ran
        # Every collective comes after the loop's last predicate read.
        assert all(e["reads"] == rec["reads1"] for e in rec["entries"])
        kinds = [e["kind"] for e in rec["entries"]]
        assert kinds.count("all_gather") == leaves
        assert [e for e in rec["entries"] if e["kind"] != "all_gather"] == [
            {"kind": "all_reduce", "numel": 1, "reads": rec["reads1"]}]


def test_submesh_solves_on_its_ranks_only(runs):
    """A mesh of 2 of 4 ranks: its ranks get the whole result; the others,
    outside the mesh, get None (as the JAX submesh leaves devices idle)."""
    got = each_rank(runs, 4, "submesh")
    for r in (0, 1):
        assert_same_lanes(got[r], unsharded("lbfgs"))
    assert got[2] is None and got[3] is None
