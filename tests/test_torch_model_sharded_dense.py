"""The port's model-axis sharding of the dense solvers: BFGS, Newton, the
trust region (dense and Hessian-free), Nelder-Mead and L-BFGS with the
Hessian-diagonal preconditioner, on W = 1, 2 and 4 gloo ranks on the CPU,
float64; the counterpart of what the JAX package's GSPMD solve accepts
(``cppnumericalsolvers_tpu/parallel/model_sharded.py``).

The ranks run as processes of their own (tests/torch_parallel_ranks.py,
suite "dense").  The contracts, tests/test_model_sharded.py's:

* a world of one is bit-equal to the unsharded port solve (status, nfev,
  iterations, x, value, gradient);
* W ranks against the world of one, and every case but BFGS on Rosenbrock
  against the JAX package's unsharded ``minimize``: status and nfev exact,
  x within 1e-8, the value within rtol 1e-10 (a distributed reduction only
  reorders sums);
* BFGS on Rosenbrock from -1.2 amplifies a sum's last bit about a
  thousandfold an iteration (GSPMD's reordered sums move JAX's own sharded
  BFGS there too): held to the world of one at two iterations, and to its
  end by status and value;
* the 2-D (batch, model) mesh against the unsharded batched solve;
* the collectives each solver issues inside its loop, per iteration;
* a sharded result has the unsharded layout: resumed unsharded it goes on
  as the uninterrupted unsharded solve.
"""

import collections
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
import cppnumericalsolvers_tpu_torch as cns

import torch_parallel_ranks as ranks

torch.set_num_threads(1)

WORLDS = (1, 2, 4)
SHARDED = (2, 4)
XTOL = 1e-8
VALUE_RTOL = 1e-10
CASES = {c[0]: c for c in ranks.dense_cases()}
#: Cases held to the world of one by status and value only (see above).
LOOSE = ("bfgs_rosen_full",)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    where = tmp_path_factory.mktemp("dense_ranks")
    return {w: ranks.run_ranks("dense", w, str(where / f"w{w}"))
            for w in WORLDS}


def result(rec):
    return rec["result"] if "result" in rec else rec


def records(runs, world, label):
    return [result(r[label]) for r in runs[world]]


def assert_matches(got, want):
    for key in ("status", "nfev"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(np.asarray(got["x"]), np.asarray(want["x"]),
                               rtol=0, atol=XTOL)
    np.testing.assert_allclose(np.asarray(got["value"]),
                               np.asarray(want["value"]),
                               rtol=VALUE_RTOL, atol=1e-12)


def problem(label):
    _, key, kind, n, cut, deltas = CASES[label]
    fn, mode, solver, stop = ranks.dense_problem(key, kind, cut, deltas)
    return cns.objective(fn, mode), solver, stop, ranks.dense_start(kind, n)


@functools.lru_cache(maxsize=None)
def unsharded(label):
    obj, solver, stop, x0 = problem(label)
    return ranks.summary(cns.minimize(obj, torch.from_numpy(x0), solver,
                                      stop, device="cpu"))


def jax_fn(kind):
    if kind == "rosen":
        def fn(x):
            even, odd = x[0::2], x[1::2]
            return jnp.sum(100.0 * (odd - even**2) ** 2 + (1.0 - even) ** 2)
    else:
        def fn(x):
            scale = 1.0 + jnp.arange(x.shape[-1], dtype=x.dtype) / x.shape[-1]
            return jnp.sum(scale * x * x)
    return fn


@functools.lru_cache(maxsize=None)
def jax_solve(label):
    """JAX's unsharded ``minimize`` of one case, float64 on the CPU."""
    _, key, kind, n, cut, deltas = CASES[label]
    cls, kw, mode = ranks.DENSE_SOLVERS[key]
    solver = getattr(jcns.solvers, cls)(**kw)
    stop = solver.default_stopping(jnp.float64)
    if cut:
        stop = stop.replace(max_iterations=cut)
    if not deltas:
        stop = stop.replace(x_delta=0.0, f_delta=0.0, past=0)
    res = jcns.minimize(jcns.objective(jax_fn(kind), mode=mode),
                        jnp.asarray(ranks.dense_start(kind, n)), solver,
                        stop)
    return {"status": res.progress.status, "nfev": res.state.nfev,
            "x": res.state.x, "value": res.state.value}


@pytest.mark.parametrize("label", sorted(CASES))
def test_world_of_one_is_bit_equal_to_the_unsharded_solve(runs, label):
    want = unsharded(label)
    got = records(runs, 1, label)[0]
    for key in ("status", "nfev", "iterations", "x", "value", "gradient"):
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("label", sorted(set(CASES) - set(LOOSE)))
@pytest.mark.parametrize("world", SHARDED)
def test_sharded_matches_the_world_of_one(runs, world, label):
    want = records(runs, 1, label)[0]
    for got in records(runs, world, label):
        assert_matches(got, want)


@pytest.mark.parametrize("label", sorted(
    set(CASES) - set(LOOSE) - {"bfgs_rosen"}))
@pytest.mark.parametrize("world", WORLDS)
def test_matches_jax(runs, world, label):
    """Every case but BFGS on Rosenbrock against the JAX package's
    unsharded solve, on every rank."""
    want = jax_solve(label)
    for got in records(runs, world, label):
        assert_matches(got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_bfgs_rosenbrock_to_its_end(runs, world):
    """BFGS on Rosenbrock to its end: the world of one's status and a value
    near the optimum on every rank, every rank holding the same result."""
    want = records(runs, 1, "bfgs_rosen_full")[0]
    recs = records(runs, world, "bfgs_rosen_full")
    for got in recs:
        assert int(got["status"]) == int(want["status"])
        assert float(got["value"]) < 1e-3
        assert torch.equal(got["x"], recs[0]["x"])


@pytest.mark.parametrize("world", WORLDS)
def test_an_empty_shard_has_no_hessian_column(runs, world):
    """n = 9 over 4 ranks leaves the last rank no coordinate: its Hessian
    part is (B, 9, 0), and Newton still reaches the optimum as on one
    rank."""
    want = records(runs, 1, "newton_tiny")[0]
    for got in records(runs, world, "newton_tiny"):
        assert_matches(got, want)
        np.testing.assert_allclose(got["x"].numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("key", sorted(ranks.DENSE_SOLVERS))
def test_2d_mesh(runs, key):
    """Three lanes over a 2 x 2 (batch, model) mesh (the batch axis does
    not divide them) against the unsharded batched solve, on every rank."""
    kind = "rosen" if key == "nm" else "quad"
    n = ranks.N_NM if key == "nm" else ranks.N_DENSE
    fn, mode, solver, stop = ranks.dense_problem(key, kind)
    want = ranks.summary(cns.minimize_batched(
        cns.objective(fn, mode),
        torch.from_numpy(ranks.dense_start(kind, n, lanes=3)), solver, stop,
        device="cpu"))
    for r in runs[4]:
        got = r[f"{key}_2d"]
        assert tuple(got["x"].shape) == (3, n)
        assert_matches(got, want)


def in_loop(rec):
    """The collectives issued before the loop's last predicate read, by
    (kind, elements)."""
    return collections.Counter(
        (e["kind"], e["numel"]) for e in rec["entries"]
        if e["reads"] < rec["reads1"])


def expected(label, n, w, its, counts):
    """What one rank of a logged case issues inside its loop beside the
    all-reduces of one scalar, by (kind, elements), B = 1: the dense trust
    region's and the Hessian-free form's per-product collectives are read
    from ``counts`` (one a CG step, more than one an iteration)."""
    products = {"tr_quad": ("all_reduce", n),
                "trhf_quad": ("all_gather", 2 * w)}.get(label)
    if products is not None:
        assert counts[products] > its
    return {
        "bfgs_quad": {("all_gather", w): 2 * its, ("all_gather", 2 * w): its},
        "newton_quad": {("all_gather", w): 2 * its,
                        ("all_gather", n * w): its},
        "tr_quad": {("all_gather", w): its, products: counts[products]},
        "trhf_quad": {products: counts[products]},
        "nm_long": {("all_reduce", n + 1): 3 * its, ("all_reduce", 4): its,
                    ("all_reduce", 2): its},
        "lbfgs_pre_quad": {("all_gather", w): its},
    }[label]


@pytest.mark.parametrize("label", ranks.DENSE_LOGGED)
@pytest.mark.parametrize("world", SHARDED)
def test_collective_signature(runs, world, label):
    """Inside the loop: BFGS gathers g, (y, s) and H y an iteration; Newton
    x (for its Hessian columns), the columns and g; the dense trust region
    x once an iteration and sums the product with its columns (``B n``
    values) once a product; the Hessian-free form gathers (x, v) once a
    product; preconditioned L-BFGS gathers x once an iteration; Nelder-Mead
    makes two all-reduces of its own an iteration (the vertices'
    distances, ``n + 1`` values, and the reflection's two) beside its three
    evaluations' (``n + 1``, ``n + 1`` and 4 values).  Every other
    collective is an all-reduce of one scalar, at least one an
    iteration."""
    n = CASES[label][3]
    for r in runs[world]:
        rec = r[label]
        its = int(rec["result"]["iterations"])
        counts = in_loop(rec)
        rest = {k: v for k, v in counts.items() if k != ("all_reduce", 1)}
        assert rest == expected(label, n, n // world, its, counts), counts
        assert counts[("all_reduce", 1)] >= its


@pytest.mark.parametrize("key", sorted(ranks.RESUME_CUT))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_result_resumes_unsharded(runs, world, key):
    """A sharded result cut by RESUME_CUT's budget has the unsharded
    layout, and resumed unsharded it goes on as the unsharded solve cut
    alike and resumed: bit for bit from a world of one, within the
    contract from W ranks."""
    kind = "rosen" if key == "nm" else "quad"
    n = ranks.N_NM if key == "nm" else ranks.N_MODEL
    fn, mode, solver, cut_stop = ranks.dense_problem(
        key, kind, ranks.RESUME_CUT[key])
    obj = cns.objective(fn, mode)
    x0 = torch.from_numpy(ranks.dense_start(kind, n))
    want = ranks.summary(cns.resume(
        obj, cns.minimize(obj, x0, solver, cut_stop, device="cpu"), solver,
        device="cpu"))
    for r in runs[world]:
        cut = r[f"{key}_cut"]
        assert int(cut.progress.status) == int(cns.Status.ITERATION_LIMIT)
        layout = (cut.internals.inverse_hessian if key == "bfgs"
                  else cut.internals.simplex)
        assert tuple(layout.shape) == (
            (n, n) if key == "bfgs" else (n + 1, n))
        got = ranks.summary(cns.resume(obj, cut, solver, device="cpu"))
        if world == 1:
            for k in ("status", "nfev", "iterations", "x", "value"):
                assert torch.equal(got[k], want[k]), k
        else:
            assert_matches(got, want)
            assert int(got["iterations"]) == int(want["iterations"])
