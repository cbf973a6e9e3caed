"""The port's L-BFGS-B against the JAX package's, in float64 on the CPU.

* The ten cases of tests/test_lbfgsb.py, each case's lanes in one batch per
  objective (a box per lane from ``make_internals``, which is how the JAX
  package runs its own per-lane boxes): every case's own assertions on the
  port's lanes, and the full-solve contract against the JAX package's same
  batch: status and nfev equal, values and x within 1e-6 (one lane's x
  wider, listed in ``X_TOL`` with its spread).
* A 5-iteration batch of the pairwise extended Rosenbrock under bench.py's
  box [-2, 0.9] (every odd coordinate pinned, so the Cauchy walk crosses
  real breakpoints) and under per-lane boxes: status, nfev and
  num_iterations exact, iterates and every float of the internals within
  1e-12 (``middle_inv`` relative to its largest entry).
* The breakpoint sort with ties: lanes whose breakpoints are all equal,
  and a lane with a zero gradient (every breakpoint ``finfo.max``), walked
  from a real history: the Cauchy point within 1e-12 of the JAX package's.
* The no-redundant-evaluation case (tests/test_lbfgsb.py:146) as an exact
  nfev.
* A JAX L-BFGS-B solve cut at 3 iterations, carried across by
  ``convert.from_jax_numpy`` and resumed in the port, ends as the JAX
  package's uninterrupted solve: statuses, nfev and iterations exact, x
  within 1e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu.solvers import Lbfgsb as JaxLbfgsb
from cppnumericalsolvers_tpu.solvers import lbfgsb as jlbfgsb
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.convert import from_jax_numpy
from cppnumericalsolvers_tpu_torch.solvers import lbfgsb as tlbfgsb

torch.set_num_threads(1)

BIG = np.finfo(np.float64).max
INF_BOX = (-BIG, BIG)

# Least squares with a box on the coefficients (tests/test_lbfgsb.py:80).
_LS_RNG = np.random.default_rng(1)
LS_A = _LS_RNG.standard_normal((30, 4))
LS_W = np.array([2.0, -1.5, 0.5, 3.0])
LS_Y = LS_A @ LS_W


def jsphere(x):
    return jnp.sum(x * x)


def tsphere(x):
    return torch.sum(x * x)


def jrosen2(x):
    return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2


def trosen2(x):
    return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2


def jls(w):
    return jnp.sum((jnp.asarray(LS_A) @ w - jnp.asarray(LS_Y)) ** 2)


def tls(w):
    a = torch.from_numpy(LS_A)
    return torch.sum((a @ w - torch.from_numpy(LS_Y)) ** 2)


OBJECTIVES = {"sphere": (jsphere, tsphere, 2), "rosenbrock": (
    jrosen2, trosen2, 2), "least_squares": (jls, tls, 4)}

# case -> (objective, [(start, lower, upper), ...]); None bounds are the
# unbounded box.
CASES = {
    "unbounded_rosenbrock_matrix": ("rosenbrock", [
        ([15.0, 8.0], None, None), ([-1.0, 2.0], None, None)]),
    "active_bound_optimum": ("sphere", [
        ([3.0, 4.0], (1.0, 1.0), (10.0, 10.0))]),
    "interior_optimum_with_bounds": ("sphere", [
        ([3.0, -4.0], (-5.0, -5.0), (5.0, 5.0))]),
    "infeasible_start_is_projected": ("sphere", [
        ([50.0, -50.0], (1.0, 1.0), (2.0, 2.0))]),
    "rosenbrock_bounded_away_from_optimum": ("rosenbrock", [
        ([0.0, 0.0], (-2.0, -2.0), (0.8, 2.0))]),
    "box_constrained_least_squares": ("least_squares", [
        ([0.0] * 4, (-5.0,) * 4, (5.0, 5.0, 5.0, 2.0)),
        ([0.0] * 4, (-5.0,) * 4, (5.0,) * 4)]),
    "batched_bounds": ("sphere", [
        ([3.0, 3.0], (0.5, -5.0), (5.0, 5.0)),
        ([-3.0, 2.5], (0.5, -5.0), (5.0, 5.0)),
        ([0.1, 0.2], (0.5, -5.0), (5.0, 5.0))]),
    "batched_heterogeneous_bounds": ("sphere", [
        ([3.0, 3.0], (0.5, 0.25), (5.0, 5.0)),
        ([4.0, 4.0], (1.0, 2.0), (5.0, 5.0)),
        ([3.0, 3.0], (-1.0, -1.0), (5.0, 5.0))]),
    "runtime_bounds_single_solve": ("sphere", [
        ([3.0, 4.0], (1.0, 1.0), (10.0, 10.0))]),
    "no_redundant_eval_when_step_inside_box": ("sphere", [
        ([3.0, 4.0], None, None), ([3.0, 4.0], (-1e6, -1e6), (1e6, 1e6))]),
}


def _lanes(objective):
    """The lanes of every case on ``objective``: (case, lane index in the
    batch) and the batch's starts and boxes."""
    index, starts, lowers, uppers = {}, [], [], []
    for case, (obj, lanes) in CASES.items():
        if obj != objective:
            continue
        n = OBJECTIVES[obj][2]
        for start, lo, up in lanes:
            index.setdefault(case, []).append(len(starts))
            starts.append(start)
            lowers.append(np.broadcast_to(INF_BOX[0] if lo is None else lo,
                                          (n,)))
            uppers.append(np.broadcast_to(INF_BOX[1] if up is None else up,
                                          (n,)))
    return index, np.array(starts), np.array(lowers), np.array(uppers)


@functools.lru_cache(maxsize=None)
def solve_cases(objective):
    jfn, tfn, n = OBJECTIVES[objective]
    index, x0, lo, up = _lanes(objective)
    jsolver, tsolver = JaxLbfgsb(), cns.Lbfgsb()
    jint = jax.vmap(
        lambda a, b: jsolver.make_internals(n, jnp.float64, a, b)
    )(jnp.asarray(lo), jnp.asarray(up))
    want = jcns.minimize_batched(jcns.objective(jfn), jnp.asarray(x0),
                                 jsolver, internals=jint)
    tint = tsolver.make_internals(n, torch.float64, torch.from_numpy(lo),
                                  torch.from_numpy(up))
    got = cns.minimize_batched(cns.objective(tfn), torch.from_numpy(x0),
                               tsolver, internals=tint, device="cpu")
    return index, want, got


def case_assertions(case, x, status, nfev, iters):
    """The assertions of tests/test_lbfgsb.py on the port's lanes."""
    gnv = int(cns.Status.GRADIENT_NORM_VIOLATION)
    if case == "unbounded_rosenbrock_matrix":
        for xi in x:
            assert trosen2(torch.from_numpy(xi)) == pytest.approx(
                0.0, abs=1e-4)
    elif case == "active_bound_optimum":
        np.testing.assert_allclose(x[0], [1.0, 1.0], atol=1e-6)
        assert status[0] == gnv
    elif case == "interior_optimum_with_bounds":
        np.testing.assert_allclose(x[0], [0.0, 0.0], atol=1e-5)
    elif case in ("infeasible_start_is_projected",
                  "runtime_bounds_single_solve"):
        np.testing.assert_allclose(x[0], [1.0, 1.0], atol=1e-6)
    elif case == "rosenbrock_bounded_away_from_optimum":
        assert x[0, 0] == pytest.approx(0.8, abs=1e-4)
        assert x[0, 1] == pytest.approx(0.64, abs=1e-3)
    elif case == "box_constrained_least_squares":
        assert x[0, 3] == pytest.approx(2.0, abs=1e-5)
        np.testing.assert_allclose(x[1], LS_W, atol=1e-4)
    elif case == "batched_bounds":
        np.testing.assert_allclose(x[:, 0], 0.5, atol=1e-6)
        np.testing.assert_allclose(x[:, 1], 0.0, atol=1e-5)
    elif case == "batched_heterogeneous_bounds":
        np.testing.assert_allclose(x[0], [0.5, 0.25], atol=1e-6)
        np.testing.assert_allclose(x[1], [1.0, 2.0], atol=1e-6)
        np.testing.assert_allclose(x[2], [0.0, 0.0], atol=1e-5)
    elif case == "no_redundant_eval_when_step_inside_box":
        assert nfev[0] == nfev[1]
        np.testing.assert_allclose(x[0], x[1])
        assert nfev[0] <= 2 * iters[0] + 1
    else:
        raise AssertionError(case)


# x bounds wider than the contract's 1e-6, with their measured spread: from
# (15, 8) the unbounded Rosenbrock stops on the relative f-delta test at f
# near 1e-9, where the valley leaves x determined to about sqrt(f); the two
# packages' last-bit differences move the lane's end 3.0e-5 along it (f
# within 1e-9).
X_TOL = {"unbounded_rosenbrock_matrix": 1e-4}


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_matches_jax(case):
    index, want, got = solve_cases(CASES[case][0])
    lanes = index[case]
    x = got.state.x.numpy()[lanes]
    status = got.progress.status.numpy()[lanes]
    nfev = got.state.nfev.numpy()[lanes]
    iters = got.progress.num_iterations.numpy()[lanes]
    case_assertions(case, x, status, nfev, iters)
    np.testing.assert_array_equal(
        status, np.asarray(want.progress.status)[lanes])
    np.testing.assert_array_equal(nfev, np.asarray(want.state.nfev)[lanes])
    np.testing.assert_allclose(got.state.value.numpy()[lanes],
                               np.asarray(want.state.value)[lanes], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(x, np.asarray(want.state.x)[lanes], rtol=0,
                               atol=X_TOL.get(case, 1e-6))


def jpairwise(x):
    e, o = x[0::2], x[1::2]
    return jnp.sum(100.0 * (o - e**2) ** 2 + (1.0 - e) ** 2)


def tpairwise(x):
    e, o = x[0::2], x[1::2]
    return torch.sum(100.0 * (o - e**2) ** 2 + (1.0 - e) ** 2)


def assert_internals_close(got, want, tol):
    want = from_jax_numpy(jax.tree.map(np.asarray, want))
    for f in dataclasses.fields(got):
        a = getattr(got, f.name).numpy()
        b = getattr(want, f.name).numpy()
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            continue
        scale = 1.0
        if f.name == "middle_inv":
            # Its entries reach 1/(s.y) of a small pair: held relative to
            # each lane's largest entry.
            scale = np.maximum(np.abs(b).max(axis=(-2, -1), keepdims=True),
                               1.0)
        np.testing.assert_allclose(a / scale, b / scale, rtol=tol, atol=tol,
                                   err_msg=f.name)


@pytest.mark.parametrize("boxes", ["bench_box", "per_lane_boxes"])
def test_five_iterations_are_exact(boxes):
    b, n = 12, 6
    x0 = np.random.default_rng(3).uniform(-2.0, 2.0, (b, n))
    if boxes == "bench_box":
        jsolver = JaxLbfgsb(m=5, lower=-2.0, upper=0.9)
        tsolver = cns.Lbfgsb(m=5, lower=-2.0, upper=0.9)
        jint = tint = None
    else:
        jsolver, tsolver = JaxLbfgsb(m=3), cns.Lbfgsb(m=3)
        rng = np.random.default_rng(5)
        lo = -rng.uniform(0.5, 2.5, (b, n))
        up = rng.uniform(0.2, 1.5, (b, n))
        jint = jax.vmap(lambda a, c: jsolver.make_internals(
            n, jnp.float64, a, c))(jnp.asarray(lo), jnp.asarray(up))
        tint = tsolver.make_internals(n, torch.float64, torch.from_numpy(lo),
                                      torch.from_numpy(up))
    js = jsolver.default_stopping(jnp.float64).replace(max_iterations=5)
    ts = tsolver.default_stopping(torch.float64).replace(max_iterations=5)
    want = jcns.minimize_batched(jcns.objective(jpairwise), jnp.asarray(x0),
                                 jsolver, js, internals=jint)
    tlbfgsb.generalized_cauchy_point.passes = 0
    got = cns.minimize_batched(cns.objective(tpairwise),
                               torch.from_numpy(x0), tsolver, ts,
                               internals=tint, device="cpu")
    passes = tlbfgsb.generalized_cauchy_point.passes
    for name in ("status", "num_iterations"):
        np.testing.assert_array_equal(
            getattr(got.progress, name).numpy(),
            np.asarray(getattr(want.progress, name)), err_msg=name)
    np.testing.assert_array_equal(got.state.nfev.numpy(),
                                  np.asarray(want.state.nfev))
    for name in ("x", "value", "gradient"):
        np.testing.assert_allclose(
            getattr(got.state, name).numpy(),
            np.asarray(getattr(want.state, name)), rtol=1e-12, atol=1e-12,
            err_msg=name)
    assert_internals_close(got.internals, want.internals, 1e-12)
    # The walks crossed breakpoints, and coordinates are pinned.
    x = got.state.x.numpy()
    up_box = 0.9 if boxes == "bench_box" else up
    assert passes > 5 and (x == up_box).any()


def test_breakpoint_ties_are_walked_in_index_order():
    """Ties in the breakpoint sort: lanes whose coordinates share one
    breakpoint, and a lane with a zero gradient, walked from a real
    history; ``torch.argsort`` must be stable as ``jnp.argsort`` is."""
    n, m = 8, 5
    jsolver, tsolver = JaxLbfgsb(m=m), cns.Lbfgsb(m=m)
    rng = np.random.default_rng(11)
    start = rng.uniform(-2.0, 2.0, (1, n))
    run = jcns.minimize_batched(
        jcns.objective(jpairwise), jnp.asarray(start), jsolver,
        jsolver.default_stopping(jnp.float64).replace(max_iterations=4))
    hist = jax.tree.map(lambda a: np.repeat(np.asarray(a), 4, axis=0),
                        run.internals)
    lower = np.full((4, n), -1.0)
    upper = np.full((4, n), 1.0)
    x = np.zeros((4, n))
    g = np.zeros((4, n))
    x[0], g[0] = 0.5, 1.0            # every breakpoint 1.5
    x[1], g[1] = 0.25, -2.0          # every breakpoint 0.375 (upper side)
    x[2, ::2], g[2, ::2] = 0.5, 1.0  # half tied, half zero gradient
    x[3] = rng.uniform(-0.5, 0.5, n)  # zero gradient: all finfo.max
    jint = jlbfgsb.LbfgsbInternals(**{
        **{k: jnp.asarray(v) for k, v in hist._asdict().items()},
        "lower": jnp.asarray(lower), "upper": jnp.asarray(upper)})
    w = jax.vmap(jlbfgsb._build_w)(jint)
    want = jax.vmap(jlbfgsb._generalized_cauchy_point)(
        jnp.asarray(x), jnp.asarray(g), jint.lower, jint.upper, w,
        jint.middle_inv, jint.theta)
    tint = from_jax_numpy(jax.tree.map(np.asarray, jint))
    got = tlbfgsb.generalized_cauchy_point(
        torch.from_numpy(x), torch.from_numpy(g), tint.lower, tint.upper,
        tlbfgsb._build_w(tint), tint.middle_inv, tint.theta)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)
    # The tied lanes were walked past more than one breakpoint.
    assert not np.array_equal(got[0].numpy()[0], x[0])


def test_no_redundant_evaluation_is_an_exact_nfev():
    """tests/test_lbfgsb.py:146 as an exact count: on an unbounded quadratic
    nothing is clipped, so nfev is the start's evaluation plus the
    searches', equal with no box and with a wide one, and equal to the JAX
    package's."""
    x0 = np.array([3.0, 4.0])
    counts = []
    for lo, up in ((None, None), (-1e6, 1e6)):
        want = jcns.minimize(jcns.objective(jsphere), jnp.asarray(x0),
                             JaxLbfgsb(lower=lo, upper=up))
        got = cns.minimize(cns.objective(tsphere), torch.from_numpy(x0),
                           cns.Lbfgsb(lower=lo, upper=up), device="cpu")
        assert int(got.state.nfev) == int(want.state.nfev)
        assert int(got.progress.num_iterations) == int(
            want.progress.num_iterations)
        counts.append(int(got.state.nfev))
    assert counts[0] == counts[1]


def test_jax_solve_cut_and_resumed_in_the_port():
    b, n, cut = 8, 6, 3
    x0 = np.random.default_rng(9).uniform(-2.0, 2.0, (b, n))
    jsolver = JaxLbfgsb(m=5, lower=-2.0, upper=0.9)
    tsolver = cns.Lbfgsb(m=5, lower=-2.0, upper=0.9)
    jobj = jcns.objective(jpairwise)
    js = jsolver.default_stopping(jnp.float64)
    whole = jcns.minimize_batched(jobj, jnp.asarray(x0), jsolver, js)
    part = jcns.minimize_batched(jobj, jnp.asarray(x0), jsolver,
                                 js.replace(max_iterations=cut))
    ck = from_jax_numpy(jax.tree.map(np.asarray, part))
    assert isinstance(ck.internals, tlbfgsb.LbfgsbInternals)
    got = cns.resume(cns.objective(tpairwise), ck, tsolver,
                     tsolver.default_stopping(torch.float64), device="cpu")
    np.testing.assert_array_equal(got.progress.status.numpy(),
                                  np.asarray(whole.progress.status))
    np.testing.assert_array_equal(got.progress.num_iterations.numpy(),
                                  np.asarray(whole.progress.num_iterations))
    np.testing.assert_array_equal(got.state.nfev.numpy(),
                                  np.asarray(whole.state.nfev))
    np.testing.assert_allclose(got.state.x.numpy(),
                               np.asarray(whole.state.x), rtol=0, atol=1e-6)


def test_five_iterations_are_exact_at_long_rows():
    """The short-budget contract where the per-lane products sum rows of
    n = 130 in a fixed order (``core.tree.fixed_sum``: chunks of 32,
    zero-padded, summed, and their sums summed) and the history is full
    after five iterations
    (m = 3): status, nfev and num_iterations exact, iterates and the
    internals within 1e-12 of the JAX package's matrix products."""
    b, n = 6, 130
    x0 = np.random.default_rng(8).uniform(-2.0, 2.0, (b, n))
    jsolver = JaxLbfgsb(m=3, lower=-2.0, upper=0.9)
    tsolver = cns.Lbfgsb(m=3, lower=-2.0, upper=0.9)
    js = jsolver.default_stopping(jnp.float64).replace(max_iterations=5)
    ts = tsolver.default_stopping(torch.float64).replace(max_iterations=5)
    want = jcns.minimize_batched(jcns.objective(jpairwise), jnp.asarray(x0),
                                 jsolver, js)
    got = cns.minimize_batched(cns.objective(tpairwise),
                               torch.from_numpy(x0), tsolver, ts,
                               device="cpu")
    for name in ("status", "num_iterations"):
        np.testing.assert_array_equal(
            getattr(got.progress, name).numpy(),
            np.asarray(getattr(want.progress, name)), err_msg=name)
    np.testing.assert_array_equal(got.state.nfev.numpy(),
                                  np.asarray(want.state.nfev))
    np.testing.assert_allclose(got.state.x.numpy(), np.asarray(want.state.x),
                               rtol=1e-12, atol=1e-12)
    assert_internals_close(got.internals, want.internals, 1e-12)
    assert int(got.internals.count.min()) == 3


def test_per_lane_products_match_jax():
    """The middle matrix (``S^T Y``, ``S^T S``) and the subspace step
    (``W_F^T r``, ``W_F^T W_F``, ``MM^-1 N``), now per-lane contractions,
    against the JAX package's matrix products on a real history at n =
    130: within 1e-12 of each result's largest entry."""
    b, n, m = 4, 130, 3
    start = np.random.default_rng(9).uniform(-2.0, 2.0, (b, n))
    jsolver = JaxLbfgsb(m=m, lower=-2.0, upper=0.9)
    run = jcns.minimize_batched(
        jcns.objective(jpairwise), jnp.asarray(start), jsolver,
        jsolver.default_stopping(jnp.float64).replace(max_iterations=4))
    jint = run.internals
    tint = from_jax_numpy(jax.tree.map(np.asarray, jint))

    def close(a, b):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=0,
                                   atol=1e-12)

    close(tlbfgsb._build_middle(tint.s_history, tint.y_history, tint.count,
                                tint.theta, m),
          jax.vmap(lambda s, y, c, t: jlbfgsb._build_middle(s, y, c, t, m))(
              jint.s_history, jint.y_history, jint.count, jint.theta))
    x = np.array(run.state.x)
    g = np.array(run.state.gradient)
    w = jax.vmap(jlbfgsb._build_w)(jint)
    xc, c = jax.vmap(jlbfgsb._generalized_cauchy_point)(
        jnp.asarray(x), jnp.asarray(g), jint.lower, jint.upper, w,
        jint.middle_inv, jint.theta)
    want = jax.vmap(jlbfgsb._subspace_minimization)(
        jnp.asarray(x), jnp.asarray(g), xc, c, jint.lower, jint.upper, w,
        jint.middle_inv, jint.theta)
    got = tlbfgsb._subspace_minimization(
        torch.from_numpy(x), torch.from_numpy(g),
        torch.from_numpy(np.array(xc)), torch.from_numpy(np.array(c)),
        tint.lower, tint.upper, tlbfgsb._build_w(tint), tint.middle_inv,
        tint.theta)
    close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_a_lane_solves_alike_in_any_batch(dtype):
    """A lane's L-BFGS-B solve does not depend on the batch it is solved
    in: 16 lanes (n = 100, the two-rank case's box [0.5, 4] from starts in
    [1, 3]) against the same lanes as two blocks of 8, status, nfev and x
    bit-equal per lane.  Every product is a per-lane contraction in an
    order fixed by its length (a batched ``matmul``'s library may pick its
    algorithm by the batch count; on the card it did, C#12)."""
    x0 = torch.from_numpy(
        np.random.default_rng(0).uniform(1.0, 3.0, (16, 100))).to(dtype)
    solver = cns.Lbfgsb(m=5, lower=0.5, upper=4.0)
    obj = cns.models.pairwise_rosenbrock()

    def solve(x):
        return cns.minimize_batched(obj, x, solver, device="cpu")

    whole = solve(x0)
    blocks = [solve(x0[:8]), solve(x0[8:])]
    for name, get in (("status", lambda r: r.progress.status),
                      ("nfev", lambda r: r.state.nfev),
                      ("x", lambda r: r.state.x)):
        assert torch.equal(get(whole), torch.cat([get(r) for r in blocks])), \
            name
    assert int(whole.progress.num_iterations.max()) > 5


@pytest.mark.parametrize("k", [1, 2, 5, 10, 20, 63, 64, 130, 4097])
def test_fixed_orders_do_not_depend_on_the_batch(k):
    """``core.tree.fixed_sum`` and ``strided_sum``, the sums of the per-lane
    products: a row's sum has the same bits alone and in a batch, is within
    rounding of ``torch.sum``, and ``fixed_sum`` of a row shorter than 64 is
    ``torch.sum``'s bit for bit."""
    from cppnumericalsolvers_tpu_torch.core.tree import fixed_sum, strided_sum

    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((9, k))
                         * np.exp(3 * rng.standard_normal((9, k))))
    want = x.sum(-1)
    for total in (fixed_sum, strided_sum):
        got = total(x)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(x.abs().sum(-1).max()))
        for lane in (0, 4, 8):
            assert torch.equal(total(x[lane:lane + 1]), got[lane:lane + 1])
        assert torch.equal(total(x[None])[0], got)
    if k < 64:
        assert torch.equal(fixed_sum(x), want)


@pytest.mark.parametrize("cap", [1, 64, 1000])
@pytest.mark.parametrize("r,s,k", [(10, 10, 130), (20, 20, 4097), (3, 7, 5)])
def test_sliced_products_equal_the_whole(cap, r, s, k, monkeypatch):
    """``core.tree.lane_matvec`` and ``lane_gram`` take their rows in slices
    whose elementwise product holds at most ``_PRODUCT_VALUES`` values (so
    ``W_F^T W_F`` at a large n never materialises (B, 2m, 2m, n)); a slice
    of any size gives every row the bits of the product taken whole, with
    both sums, and they are within rounding of ``matmul``."""
    from cppnumericalsolvers_tpu_torch.core import tree

    rng = np.random.default_rng(r * k)
    a = torch.from_numpy(rng.standard_normal((4, r, k)))
    b = torch.from_numpy(rng.standard_normal((4, s, k)))
    v = torch.from_numpy(rng.standard_normal((4, k)))
    totals = (tree.fixed_sum,) + ((tree.strided_sum,) if k < 24 else ())
    whole = {t: (tree.lane_matvec(a, v, t), tree.lane_gram(a, b, t))
             for t in totals}
    monkeypatch.setattr(tree, "_PRODUCT_VALUES", cap)
    for t in totals:
        assert torch.equal(tree.lane_matvec(a, v, t), whole[t][0])
        assert torch.equal(tree.lane_gram(a, b, t), whole[t][1])
    np.testing.assert_allclose(whole[tree.fixed_sum][0].numpy(),
                               (a @ v[..., None])[..., 0].numpy(),
                               rtol=1e-12, atol=1e-12 * k)
    np.testing.assert_allclose(whole[tree.fixed_sum][1].numpy(),
                               (a @ b.transpose(-1, -2)).numpy(),
                               rtol=1e-12, atol=1e-12 * k)
