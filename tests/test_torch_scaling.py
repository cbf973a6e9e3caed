"""The port's scaling harness (``benchmarks_torch/scaling.py``) on the CPU:
its three legs on W = 1, 2 and 4 gloo ranks against the JAX harness's legs
(``benchmarks/scaling.py``) on the conftest's virtual mesh of W devices,
and the harness run end to end as a user runs it.

The ranks are processes of their own (tests/torch_parallel_ranks.py, suite
"scaling"), each running the harness's leg functions at small widths, cut
at ten iterations, in float64, on the inputs the harness draws
(``default_rng(W)``, ``default_rng(100 + W)``, ``default_rng(7)``).
Tolerances:

* the objective: the view form against JAX's strided ``ext_rosenbrock``,
  value and gradient within 1e-12;
* the batch leg: status, nfev and iterations exact, x within 1e-12 (the
  short-budget parity contract);
* the model and 2-D legs: status and nfev exact, x within 1e-8 and the
  value within rtol 1e-10 (tests/test_torch_model_sharded.py's: a
  distributed reduction only reorders sums);
* a world of one: bit-equal to the unsharded port solve.
"""

import concurrent.futures
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from benchmarks import scaling as jax_scaling
from benchmarks_torch import scaling
from cppnumericalsolvers_tpu.core.progress import (
    default_stopping as jax_default_stopping,
)
from cppnumericalsolvers_tpu.parallel import (
    make_mesh as jax_make_mesh,
    minimize_model_sharded as jax_model_sharded,
    minimize_sharded as jax_sharded,
)
from cppnumericalsolvers_tpu.solvers import Lbfgs as JaxLbfgs
import cppnumericalsolvers_tpu_torch as cns

import torch_parallel_ranks as ranks

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "benchmarks_torch", "scaling.py")
WORLDS = (1, 2, 4)
OBJECTIVE_TOL = 1e-12
BATCH_XTOL = 1e-12
MODEL_XTOL = 1e-8
VALUE_RTOL = 1e-10

#: The keys of benchmarks/scaling.py's line (SCALING_r05.json) that the
#: port's line keeps, by the object they sit in, plus the port's own.
TOP_KEYS = {"metric", "value", "unit", "vs_baseline", "repeats",
            "host_physical_cores", "batch_axis", "model_axis",
            "mesh_2d_batch_x_model", "per_device_batch", "dim", "backend",
            "note", "device", "cards", "sizes"}
BATCH_KEYS = {"iters_per_s", "per_device_efficiency",
              "efficiency_noise_band"}
MODEL_KEYS = {"dim", "iters_per_s", "speedup_vs_1dev",
              "efficiency_vs_core_ceiling"}
MESH_2D_KEYS = {"lane_iters_per_s", "batch", "n", "mesh"}
STAT_KEYS = {"mean", "std", "min", "max"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world's records; the three worlds run side by side (their
    results do not depend on time)."""
    where = tmp_path_factory.mktemp("scaling_ranks")
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {w: pool.submit(ranks.run_ranks, "scaling", w,
                                  str(where / f"w{w}")) for w in WORLDS}
        return {w: f.result() for w, f in futures.items()}


def jax_stopping():
    """``_fixed_iter_stopping`` of benchmarks/scaling.py in float64, cut at
    the suite's iterations."""
    return jax_default_stopping(jnp.float64)._replace(
        max_iterations=jnp.int32(ranks.SCALING_CUT),
        x_delta=jnp.float64(0.0), f_delta=jnp.float64(0.0),
        gradient_norm=jnp.float64(0.0), past=jnp.int32(0))


def port_stopping():
    return scaling.fixed_iter_stopping(torch.float64, ranks.SCALING_CUT)


def jax_summary(res):
    return {"x": np.asarray(res.state.x), "value": np.asarray(res.state.value),
            "nfev": np.asarray(res.state.nfev),
            "status": np.asarray(res.progress.status),
            "iterations": np.asarray(res.progress.num_iterations)}


@functools.lru_cache(maxsize=None)
def jax_batch(world):
    x0 = scaling.batch_starts(world, ranks.scaling_sizes(), np.float64, 1)[0]
    return jax_summary(jax_sharded(
        jax_scaling._objective(), jnp.asarray(x0),
        JaxLbfgs(m=scaling.M, two_loop_impl="xla"), jax_stopping(),
        mesh=jax_make_mesh(world)))


@functools.lru_cache(maxsize=None)
def jax_model(world):
    x0 = scaling.model_starts(world, ranks.scaling_sizes(), np.float64, 1)[0]
    return jax_summary(jax_model_sharded(
        jax_scaling._objective(), jnp.asarray(x0), JaxLbfgs(m=scaling.M),
        jax_stopping(), mesh=jax_make_mesh(world, axis="model")))


def assert_close(got, want, xtol, exact=("status", "nfev"), rtol=None):
    for key in exact:
        np.testing.assert_array_equal(np.asarray(got[key]), want[key],
                                      err_msg=key)
    np.testing.assert_allclose(np.asarray(got["x"]), want["x"], rtol=0,
                               atol=xtol)
    if rtol is not None:
        np.testing.assert_allclose(np.asarray(got["value"]), want["value"],
                                   rtol=rtol, atol=1e-12)


def assert_bit_equal(got, want):
    for key in ("status", "nfev", "iterations", "x", "value"):
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("n", [16, 512])
def test_objective_matches_jax(n):
    x = np.random.default_rng(n).uniform(-2.0, 2.0, n)
    v, g = scaling.objective().value_and_grad(torch.from_numpy(x))
    jobj = jax_scaling._objective()
    np.testing.assert_allclose(float(v), float(jobj.fn(jnp.asarray(x))),
                               rtol=OBJECTIVE_TOL)
    np.testing.assert_allclose(g.numpy(),
                               np.asarray(jobj.gradient(jnp.asarray(x))),
                               rtol=OBJECTIVE_TOL, atol=OBJECTIVE_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_batch_leg_matches_jax(runs, world):
    want = jax_batch(world)
    for rec in runs[world]:  # every rank holds the whole result
        assert_close(rec["batch"], want, BATCH_XTOL,
                     exact=("status", "nfev", "iterations"))


def test_batch_world_of_one_is_bit_equal_to_the_unsharded_solve(runs):
    x0 = scaling.batch_starts(1, ranks.scaling_sizes(), np.float64, 1)[0]
    want = ranks.summary(cns.minimize_batched(
        scaling.objective(), torch.from_numpy(x0),
        cns.Lbfgs(m=scaling.M, two_loop_impl="xla"), port_stopping(),
        device="cpu"))
    assert_bit_equal(runs[1][0]["batch"], want)


@pytest.mark.parametrize("world", WORLDS)
def test_model_leg_matches_jax(runs, world):
    want = jax_model(world)
    for rec in runs[world]:
        assert_close(rec["model"], want, MODEL_XTOL, rtol=VALUE_RTOL)


def test_model_world_of_one_is_bit_equal_to_the_unsharded_solve(runs):
    x0 = scaling.model_starts(1, ranks.scaling_sizes(), np.float64, 1)[0]
    want = ranks.summary(cns.minimize(
        scaling.objective(), torch.from_numpy(x0),
        cns.Lbfgs(m=scaling.M, two_loop_impl="xla"), port_stopping(),
        device="cpu"))
    assert_bit_equal(runs[1][0]["model"], want)


def test_mesh_2d_leg_matches_jax(runs):
    rows, cols = ranks.SCALING_MESH_2D
    x0 = scaling.mesh_2d_start(ranks.scaling_sizes(), np.float64)
    mesh = Mesh(np.asarray(jax.devices()[:rows * cols]).reshape(rows, cols),
                ("batch", "model"))
    want = jax_summary(jax_model_sharded(
        jax_scaling._objective(), jnp.asarray(x0), JaxLbfgs(m=scaling.M),
        jax_stopping(), mesh=mesh, batch_axis="batch"))
    for rec in runs[rows * cols]:
        got = rec["mesh_2d"]
        assert tuple(got["x"].shape) == x0.shape
        assert bool(torch.isfinite(got["value"]).all())
        assert_close(got, want, MODEL_XTOL, rtol=VALUE_RTOL)


def run_script(*args, timeout=240):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, SCRIPT, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_harness_end_to_end_on_the_cpu():
    """The harness as a user runs it, at small widths: one JSON line with
    the JAX harness's keys and the port's, every rate finite and
    positive."""
    proc = run_script("--device", "cpu", "--sizes", "1,2", "--repeats", "2",
                      "--max-iters", "5", "--per-device-batch", "8",
                      "--model-dim", "512", "--mesh-2d", "1,2",
                      "--lanes-2d", "4", "--n-2d", "64")
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == TOP_KEYS
    assert set(out["batch_axis"]) == BATCH_KEYS
    assert set(out["model_axis"]) == MODEL_KEYS
    assert set(out["mesh_2d_batch_x_model"]) == MESH_2D_KEYS
    assert out["metric"] == "weak_scaling_efficiency_2dev"
    assert (out["backend"], out["device"], out["sizes"]) == (
        "gloo", "cpu", [1, 2])
    assert out["cards"] == torch.cuda.device_count()
    assert out["mesh_2d_batch_x_model"]["mesh"] == [1, 2]
    assert out["model_axis"]["dim"] == 512
    rates = [out["mesh_2d_batch_x_model"]["lane_iters_per_s"],
             out["value"], out["vs_baseline"]]
    for axis in ("batch_axis", "model_axis"):
        for w in ("1", "2"):
            stat = out[axis]["iters_per_s"][w]
            assert set(stat) == STAT_KEYS
            rates += [stat["mean"], stat["min"], stat["max"]]
    assert all(np.isfinite(r) and r > 0 for r in rates), rates
    assert out["batch_axis"]["per_device_efficiency"]["1"] == 1.0
    assert out["model_axis"]["speedup_vs_1dev"]["1"] == 1.0


@pytest.mark.parametrize("n, parts", [(1026, 2), (510, 2), (1024, 3),
                                      (513, 1)])
def test_an_odd_shard_raises(n, parts):
    with pytest.raises(ValueError, match="even number of coordinates"):
        scaling.check_shards(n, parts)


def test_an_even_shard_passes():
    scaling.check_shards(scaling.CARD_SIZES.model_dim, 8)
    scaling.check_shards(scaling.CPU_SIZES.model_dim, 8)


def test_odd_shards_stop_the_harness_before_any_rank():
    proc = run_script("--device", "cpu", "--sizes", "1,2", "--mesh-2d",
                      "1,2", "--model-dim", "1026", timeout=60)
    assert proc.returncode != 0
    assert "even number of coordinates" in proc.stderr
    assert proc.stdout == ""


def test_no_cpu_fallback_without_a_gpu():
    """The default device is the card; without one the harness stops with
    ``core.driver.resolve_device``'s message and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the harness would run on it")
    proc = run_script(timeout=60)
    assert proc.returncode != 0
    assert "No CUDA device is available" in proc.stderr
    assert proc.stdout == ""
