"""examples_torch/pod_scale.py and entry_torch.py on 1 and 2 gloo ranks on
the CPU, against the JAX package's examples/pod_scale.py and
__graft_entry__.py; and the examples' imports.

The ranks run as processes of their own (tests/torch_parallel_ranks.py,
suite "examples").  pod_scale's float32 solves of the extended Rosenbrock
at n = 16: the JAX example's printed converged share exactly and its mean
nfev and iterations within 3 (the parity contract on full solves); the
first 128 lanes, which every world draws alike from seed 0, against the
JAX package's single-device solve of them: every lane's status, the mean
nfev and iterations within 3, values within 1e-3 (float32 lanes stop a
few 1e-4 above the optimum's 0 at most).  The dry run's solves
against the JAX package's solves of the same draws, lane by lane: the
convergence flag and the value (see ``assert_lanes``; L-BFGS-B's flag
and its box only; its draws solved in float64 on the same mesh are
held as the parity contract holds solves, see
``test_dryrun_lbfgsb_float64_matches_jax``); ``entry()``'s step against
``__graft_entry__.entry()``'s within float32 tolerance.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu.solvers import Lbfgs as JaxLbfgs
from cppnumericalsolvers_tpu.solvers import Lbfgsb as JaxLbfgsb

import torch_examples as tex
import torch_parallel_ranks as ranks

WORLDS = (1, 2)
LANES = 128
NFEV_MEAN = 3.0
#: float32 lanes stop on the relative f-change test anywhere from 1e-6 to
#: a few 1e-4 above the optimum's 0, so the values agree to that scale.
VALUE_ATOL = 1e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    where = tmp_path_factory.mktemp("example_ranks")
    proc = tex.start_jax_example("pod_scale")
    recs = {w: ranks.run_ranks("examples", w, str(where / f"w{w}"))
            for w in WORLDS}
    return recs, tex.finish(proc)


def jax_rosenbrock(x):
    even, odd = x[0::2], x[1::2]
    return jnp.sum(100.0 * (odd - even ** 2) ** 2 + (1.0 - even) ** 2)


def jax_batch(x0, solver, cut=0):
    """JAX's batched solve of ``x0``, cut at ``cut`` iterations (0: to
    the solver's default stop)."""
    stop = None
    if cut:
        stop = solver.default_stopping(jnp.asarray(x0).dtype).replace(
            max_iterations=cut)
    res = jcns.minimize_batched(
        jcns.objective(jax_rosenbrock, mode="first"), jnp.asarray(x0),
        solver, stop)
    return {"x": np.asarray(res.state.x), "f": np.asarray(res.state.value),
            "nfev": np.asarray(res.state.nfev),
            "iterations": np.asarray(res.progress.num_iterations),
            "status": np.asarray(res.progress.status)}


def converged(status):
    return np.isin(status, jcns.CONVERGED_STATUSES)


def assert_lanes(got, want, few=False):
    """Full float32 solves: every lane's status, the mean nfev and
    iterations within 3, values within VALUE_ATOL.  ``few`` lanes (the dry
    run's 1-8) hold each lane's convergence flag and value only: a float32
    lane stops on whichever convergence rung its last bits reach first (as
    the MGH suite's lanes do), and on the 4-D Rosenbrock a float32
    trajectory parts from JAX's at roundoff (one L-BFGS-B lane took 52
    evaluations against JAX's 17), so a batch of a few lanes has no mean
    nfev to hold."""
    if few:
        np.testing.assert_array_equal(converged(got["status"].numpy()),
                                      converged(want["status"]))
    else:
        np.testing.assert_array_equal(got["status"].numpy(), want["status"])
        for key in ("nfev", "iterations"):
            assert abs(float(got[key].double().mean())
                       - float(want[key].mean())) <= NFEV_MEAN, key
    np.testing.assert_allclose(got["f"].numpy(), want["f"], rtol=0,
                               atol=VALUE_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_pod_scale_first_lanes_match_jax(runs, world):
    recs, _ = runs
    want = jax_batch(ranks_start(LANES), JaxLbfgs())
    for r in recs[world]:
        got = r["pod_scale"]
        assert tuple(got["x"].shape) == (LANES * world, 16)
        assert_lanes({k: v[:LANES] for k, v in got.items()
                      if isinstance(v, torch.Tensor)}, want)


def ranks_start(batch):
    from examples_torch import pod_scale

    return pod_scale.starts(batch)


def test_pod_scale_world_of_one_matches_the_jax_example(runs):
    recs, text = runs
    line = tex.line_with(text, "converged")
    conv, nfev, iters = tex.numbers(line)[:3]
    got = recs[1][0]["pod_scale"]["metrics"]
    assert tex.printed_close(got["converged_pct"], conv)
    assert abs(got["mean_nfev"] - float(nfev)) <= NFEV_MEAN
    assert abs(got["mean_iterations"] - float(iters)) <= NFEV_MEAN
    assert int(tex.numbers(tex.line_with(text, "solving"))[0]) == LANES


dryrun_draws = ranks.dryrun_draws
#: Iterate tolerances of the dry run's float64 L-BFGS-B solves: the parity
#: contract's 1e-12 after DRYRUN_SHORT iterations; to the end, the 4-D
#: Rosenbrock amplifies the last bit in which the port's sums and XLA's
#: differ (measured on the two-rank draws: 9e-16 after 5 iterations, 1e-9
#: after 10, 2e-7 after 30, 1.1e-7 at the end), so 1e-6.
SHORT_XTOL = 1e-12
FULL_XTOL = 1e-6


@pytest.mark.parametrize("case", ["lbfgs", "lbfgsb", "mesh_2d"])
@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_solves_match_jax(runs, world, case):
    recs, _ = runs
    if case == "mesh_2d" and world < 2:
        assert "mesh_2d" not in recs[world][0]["dryrun"]
        return
    x0 = dryrun_draws(world)[case].astype(np.float32)
    solver = {"lbfgs": JaxLbfgs(m=5), "mesh_2d": JaxLbfgs(m=5),
              "lbfgsb": JaxLbfgsb(m=5, lower=0.5, upper=4.0)}[case]
    want = jax_batch(x0, solver)
    for r in recs[world]:
        got = r["dryrun"][case]
        if case == "lbfgsb":
            # Float32 L-BFGS-B lanes stop on the factr test anywhere along
            # the valley, the port's and JAX's on different lanes (f up to
            # 0.72 on either): the flags and the box are what holds.
            np.testing.assert_array_equal(converged(got["status"].numpy()),
                                          converged(want["status"]))
        else:
            assert_lanes(got, want, few=True)
        if case == "lbfgsb":
            x = got["x"].numpy()
            assert (x >= 0.5 - 1e-5).all() and (x <= 4.0 + 1e-5).all()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("cut", [0, ranks.DRYRUN_SHORT])
def test_dryrun_lbfgsb_float64_matches_jax(runs, world, cut):
    """The dry run's L-BFGS-B draws in float64, on the dry run's batch
    mesh, lane by lane against JAX's solve of them: status, nfev and
    iterations exact; x within SHORT_XTOL after ``cut`` iterations, within
    FULL_XTOL at the end."""
    recs, _ = runs
    solver = JaxLbfgsb(m=5, lower=0.5, upper=4.0)
    want = jax_batch(dryrun_draws(world)["lbfgsb"], solver, cut)
    for r in recs[world]:
        got = r["dryrun_lbfgsb_float64" + ("_short" if cut else "")]
        assert got["x"].dtype == torch.float64
        for key in ("status", "nfev", "iterations"):
            np.testing.assert_array_equal(got[key].numpy(), want[key], key)
        np.testing.assert_allclose(got["x"].numpy(), want["x"], rtol=0,
                                   atol=SHORT_XTOL if cut else FULL_XTOL)


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_al_matches_jax(runs, world):
    recs, _ = runs
    from cppnumericalsolvers_tpu.solvers import AugmentedLagrangian

    problem = jcns.ConstrainedProblem(
        objective=jcns.objective(
            lambda x: jnp.sum((x - 1.0) ** 2).astype(x.dtype), mode="first"),
        equality_constraints=(
            jcns.objective(lambda x: jnp.sum(x) - 1.0, mode="first"),))
    x0 = dryrun_draws(world)["al"].astype(np.float32)
    res = AugmentedLagrangian(inner_solver=JaxLbfgs(m=5)).minimize_batched(
        problem, jnp.asarray(x0))
    for r in recs[world]:
        got = r["dryrun"]["al"]
        np.testing.assert_array_equal(got["status"].numpy(),
                                      np.asarray(res.progress.status))
        np.testing.assert_allclose(got["x"].numpy(), np.asarray(res.state.x),
                                   rtol=0, atol=1e-4)


def test_entry_step_matches_jax(runs):
    import __graft_entry__ as graft

    fn, args = graft.entry()
    want = np.asarray(jax.jit(fn)(*args))
    for w in WORLDS:
        for r in recs_of(runs, w):
            got = r["entry"].numpy()
            assert got.shape == (256, 32) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def recs_of(runs, world):
    return runs[0][world]


def imported_modules(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_no_example_imports_jax_or_the_jax_package():
    paths = [os.path.join(tex.ROOT, "entry_torch.py")]
    folder = os.path.join(tex.ROOT, "examples_torch")
    paths += [os.path.join(folder, f) for f in sorted(os.listdir(folder))
              if f.endswith(".py")]
    assert len(paths) >= 10
    for path in paths:
        for name in imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "cppnumericalsolvers_tpu"), (
                path, name)
