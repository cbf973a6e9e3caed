"""The port's batch-minor prologue and loop against the JAX package.

Inputs are made with numpy from a seed and go through the JAX function and
its counterpart in the port, on the CPU, where ``lbfgs_prologue_t`` runs its
plain version (``lbfgs_prologue_t_reference``).

* float64, against ``_prologue_xla_single`` under ``jax.vmap`` (the oracle of
  tests/test_fused_step_t.py) at that file's shapes: the count exact, floats
  within 1e-12.
* float32, against ``prologue_t_pallas_batched(interpret=True)``: the count
  exact, floats within rtol 2e-4 / atol 2e-5 (two orders of summation,
  amplified by the two-loop recursion).
* The batch-minor loop (``Lbfgs.batched_step_and_update``, forced by setting
  the class attribute that routes it) against the batch-major loop and
  against JAX's ``minimize_batched(trace=1)``, under the parity contract of
  tests/test_flat_solve.py: under a short budget status, nfev and iteration
  counts exact and iterates within 1e-12 (float64); full solves equal in
  status, mean nfev within 3, values within 1e-6.

As in tests/test_torch_fused_step.py, a done lane gets the zero direction
with ``dginit = 0`` and ``alpha_init = 1`` in the port, so those outputs are
compared on live lanes only; a done lane's history, count and gamma come
back bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu.ops import fused_step_t as jft
from cppnumericalsolvers_tpu.ops.fused_step import _prologue_xla_single
from cppnumericalsolvers_tpu.solvers import Lbfgs as JaxLbfgs
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.convert import from_jax_numpy
from cppnumericalsolvers_tpu_torch.core.tree import tree_map
from cppnumericalsolvers_tpu_torch.ops import fused_step as fstep
from cppnumericalsolvers_tpu_torch.ops import fused_step_t as ft
from cppnumericalsolvers_tpu_torch.solvers import lbfgs as lb

torch.set_num_threads(1)

TOL = {np.float64: dict(rtol=1e-12, atol=1e-12),
       np.float32: dict(rtol=2e-4, atol=2e-5)}
OUT = ["ls_dir", "alpha_init", "dginit", "s_memory", "y_memory",
       "mem_count", "gamma"]
SHAPES = [(24, 10, 20), (16, 5, 8), (136, 10, 32)]


def t(a):
    return torch.from_numpy(np.array(a))


def random_case(b, m, n, dtype, seed=0):
    """The inputs of tests/test_fused_step_t.py; lane 0 is full, valid and
    live (its history shifts), lane 1 has a zero gradient (no descent
    direction: its history resets)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n))
    g = rng.standard_normal((b, n))
    s = rng.standard_normal((b, m, n)) * 0.1
    y = s + 0.05 * rng.standard_normal((b, m, n))
    count = rng.integers(0, m + 1, b).astype(np.int32)
    gamma = rng.uniform(0.5, 2.0, b)
    sn = rng.standard_normal((b, n)) * 0.1
    yn = sn + 0.02 * rng.standard_normal((b, n))
    valid = rng.integers(0, 2, b).astype(bool)
    done = rng.integers(0, 4, b) == 0
    count[0], valid[0], done[0] = m, True, False
    g[1], count[1], done[1] = 0.0, m, False
    # Chronological contract: rows at or above the count are zero.
    mask = np.arange(m)[None, :, None] < count[:, None, None]
    f = dtype
    return (x.astype(f), g.astype(f), (s * mask).astype(f),
            (y * mask).astype(f), count, gamma.astype(f), sn.astype(f),
            yn.astype(f), valid, done)


def run_prologue_t(args):
    x, g, s, y, count, gamma, sn, yn, valid, done = (t(a) for a in args)
    m, n = s.shape[1:]
    st, yt = ft.history_rows_to_t(s), ft.history_rows_to_t(y)
    out = ft.lbfgs_prologue_t(x, g, st, yt, count, gamma, sn, yn, valid,
                              done)
    # In place: the last four outputs are the tensors that went in.
    assert out[3] is st and out[4] is yt and out[5] is count
    assert out[6] is gamma
    out = list(out)
    out[3] = ft.history_t_to_rows(st, m, n)
    out[4] = ft.history_t_to_rows(yt, m, n)
    return [o.numpy() for o in out]


def check(args, want, got, dtype):
    done = args[9]
    live = ~done
    for name, w, o in zip(OUT, want, got):
        w = np.asarray(w)
        if name == "mem_count":
            np.testing.assert_array_equal(o, w, err_msg=name)
        elif name in ("ls_dir", "alpha_init", "dginit"):
            np.testing.assert_allclose(o[live], w[live], err_msg=name,
                                       **TOL[dtype])
        else:
            np.testing.assert_allclose(o, w, err_msg=name, **TOL[dtype])
    for k, name in ((2, "s_memory"), (3, "y_memory"), (4, "mem_count"),
                    (5, "gamma")):
        np.testing.assert_array_equal(got[OUT.index(name)][done],
                                      args[k][done], err_msg=name)
    assert done.any()
    assert not got[0][done].any() and not got[2][done].any()
    assert (got[1][done] == 1.0).all()
    m = args[2].shape[1]
    assert got[5][0] == m and got[5][1] == 0
    np.testing.assert_array_equal(got[0][1], -args[1][1])


@pytest.mark.parametrize("b,m,n", SHAPES)
def test_prologue_t_matches_jax_oracle_float64(b, m, n):
    args = random_case(b, m, n, np.float64, seed=b + n)
    want = jax.vmap(_prologue_xla_single)(*(jnp.asarray(a) for a in args))
    check(args, want, run_prologue_t(args), np.float64)


@pytest.mark.parametrize("b,m,n", SHAPES)
def test_prologue_t_matches_pallas_kernel_interpret_float32(b, m, n):
    args = random_case(b, m, n, np.float32, seed=b + n)
    x, g, s, y, count, gamma, sn, yn, valid, done = (
        jnp.asarray(a) for a in args)
    out = jft.prologue_t_pallas_batched(
        x, g, jft.history_rows_to_t(s, m, n), jft.history_rows_to_t(y, m, n),
        count, gamma, sn, yn, valid, done, interpret=True)
    want = list(out)
    want[3] = jft.history_t_to_rows(out[3], b, m, n)
    want[4] = jft.history_t_to_rows(out[4], b, m, n)
    got = run_prologue_t(args)
    assert got[0].dtype == np.float32
    check(args, want, got, np.float32)


def test_prologue_t_equals_the_batch_major_prologue():
    """One plain arithmetic behind both layouts on the CPU."""
    args = random_case(24, 10, 20, np.float64, seed=3)
    got = run_prologue_t(args)
    ref = fstep.lbfgs_prologue(*(t(a) for a in args))
    for name, o, r in zip(OUT, got, ref):
        np.testing.assert_allclose(o, r.numpy(), rtol=1e-14, atol=1e-14,
                                   err_msg=name)
    assert ft.lbfgs_prologue_t.launches == 0


def test_layout_helpers_round_trip_and_match_jax():
    b, m, n = 7, 4, 5
    hist = np.random.default_rng(0).standard_normal((b, m, n))
    ht = ft.history_rows_to_t(t(hist))
    assert tuple(ht.shape) == (m * n, b) and ht.is_contiguous()
    assert float(ht[2 * n + 3, 4]) == hist[4, 2, 3]
    back = ft.history_t_to_rows(ht, m, n)
    assert back.is_contiguous()
    np.testing.assert_array_equal(back.numpy(), hist)
    empty = ft.make_history_t(b, m, n, torch.float32)
    assert tuple(empty.shape) == (m * n, b) and not empty.any()
    assert empty.dtype == torch.float32
    # The JAX package pads to (m * n8, B_pad); the padding stripped, the
    # two layouts hold the same numbers in the same order.
    jt = np.asarray(jft.history_rows_to_t(jnp.asarray(hist), m, n))
    assert jt.shape == (m * 8, 128)
    np.testing.assert_array_equal(
        jt.reshape(m, 8, 128)[:, :n, :b].reshape(m * n, b), ht.numpy())


def test_from_jax_numpy_carries_batch_minor_internals():
    b, m, n = 6, 4, 5
    rng = np.random.default_rng(1)
    s, y = rng.standard_normal((2, b, m, n))
    jit = jcns.solvers.lbfgs.LbfgsInternalsT(
        s_memory_t=jft.history_rows_to_t(jnp.asarray(s), m, n),
        y_memory_t=jft.history_rows_to_t(jnp.asarray(y), m, n),
        mem_count=jnp.asarray(rng.integers(0, m + 1, b), jnp.int32),
        gamma=jnp.asarray(rng.uniform(0.5, 2.0, b)),
        s_pending=jnp.asarray(rng.standard_normal((b, n))),
        y_pending=jnp.asarray(rng.standard_normal((b, n))),
        pending_valid=jnp.asarray(rng.integers(0, 2, b).astype(bool)),
    )
    got = from_jax_numpy(jax.tree.map(np.asarray, jit), n=n, m=m)
    assert isinstance(got, cns.solvers.LbfgsInternalsT)
    assert tuple(got.s_memory_t.shape) == (m * n, b)
    np.testing.assert_array_equal(
        ft.history_t_to_rows(got.s_memory_t, m, n).numpy(), s)
    np.testing.assert_array_equal(
        ft.history_t_to_rows(got.y_memory_t, m, n).numpy(), y)
    assert got.mem_count.dtype == torch.int32
    np.testing.assert_array_equal(got.pending_valid.numpy(),
                                  np.asarray(jit.pending_valid))
    np.testing.assert_array_equal(got.s_pending.numpy(),
                                  np.asarray(jit.s_pending))
    rows = cns.Lbfgs(m=m).to_rows(got)
    assert isinstance(rows, cns.solvers.LbfgsInternals)
    np.testing.assert_array_equal(rows.s_memory.numpy(), s)


def test_launch_plan_and_argument_checks():
    # The grid is sized by B x n: a tile of 8 lanes spread over a cluster
    # of 4 two-warp blocks at n = 32 (the batch-major kernel's warp per
    # lane, one element a thread) ...
    plan = ft.prologue_t_launch_plan(1024, 10, 32, 4)
    assert plan == {"lane_tile": 8, "threads_per_lane": 32,
                    "warps_per_block": 2, "cluster": 4, "ept": 1,
                    "threads": 64, "blocks": 512, "warps": 1024,
                    "smem_bytes": (2 * 5 * 8 * (8 + 4) + 3 * 10 * 8) * 4}
    # ... one block per tile where the batch alone fills the card ...
    wide = ft.prologue_t_launch_plan(8192, 10, 32, 4)
    assert (wide["cluster"], wide["warps_per_block"]) == (1, 8)
    # ... and eight 256-thread blocks per tile at (512, 2048), whose
    # batch-major kernel gives a lane 256 threads of 8 elements.
    big = ft.prologue_t_launch_plan(512, 10, 2048, 8)
    assert (big["threads_per_lane"], big["warps_per_block"], big["cluster"],
            big["ept"]) == (256, 8, 8, 8)
    assert big["smem_bytes"] == (2 * 5 * 8 * (64 + 2) + 3 * 10 * 8) * 8
    assert ft.prologue_t_launch_plan(4, 10, 3, 8)["threads_per_lane"] == 32
    args = [t(a) for a in random_case(8, 3, 4, np.float64)]
    x, g, s, y, count, gamma, sn, yn, valid, done = args
    st, yt = ft.history_rows_to_t(s), ft.history_rows_to_t(y)
    with pytest.raises(ValueError, match="s_memory_t"):
        ft.lbfgs_prologue_t(x, g, s, yt, count, gamma, sn, yn, valid, done)
    with pytest.raises(ValueError, match="y_memory_t"):
        ft.lbfgs_prologue_t(x, g, st, yt[:, :4], count, gamma, sn, yn, valid,
                            done)
    with pytest.raises(ValueError, match="contiguous"):
        ft.lbfgs_prologue_t(x, g, st, y.reshape(8, 12).t(), count, gamma, sn,
                            yn, valid, done)
    with pytest.raises(ValueError, match="done"):
        ft.lbfgs_prologue_t(x, g, st, yt, count, gamma, sn, yn, valid,
                            done.to(torch.int32))
    with pytest.raises(TypeError):
        ft.lbfgs_prologue_t(x.half(), g.half(), st.half(), yt.half(), count,
                            gamma.half(), sn.half(), yn.half(), valid, done)


# -- the batch-minor loop ----------------------------------------------------


def jax_rosen(x):
    e, o = x[0::2], x[1::2]
    return jnp.sum(100.0 * (o - e**2) ** 2 + (1.0 - e) ** 2)


JOBJ = jcns.objective(jax_rosen, mode="first")
TOBJ = cns.models.pairwise_rosenbrock()
SOLVER = cns.Lbfgs()
X0 = np.random.default_rng(21).uniform(-2, 2, (20, 12))


def jstop(**kw):
    return jcns.default_stopping(jnp.float64).replace(**kw)


def tstop(**kw):
    return cns.default_stopping(torch.float64).replace(**kw)


@pytest.fixture
def layout(monkeypatch):
    """Force the layout of the iteration-granular loop, as one sets a class
    attribute, and count the calls of the two prologues."""
    calls = {"rows": 0, "t": 0}

    def counting(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(lb, "lbfgs_prologue",
                        counting("rows", lb.lbfgs_prologue))
    monkeypatch.setattr(lb, "lbfgs_prologue_t",
                        counting("t", lb.lbfgs_prologue_t))

    def force(batch_minor):
        if batch_minor is not None:  # None: the shipped routing rule
            monkeypatch.setattr(cns.Lbfgs, "_TRANSPOSED_B_MIN", 1)
            monkeypatch.setattr(cns.Lbfgs, "_TRANSPOSED_N_MAX",
                                1 << 20 if batch_minor else 0)
        calls["rows"] = calls["t"] = 0
        return calls

    return force


def solve(stopping=None, x0=X0, **kw):
    kw.setdefault("trace", 1)
    return cns.minimize_batched(TOBJ, torch.from_numpy(x0), SOLVER, stopping,
                                device="cpu", **kw)


def same_counts(a, b):
    for rec, name in (("progress", "status"), ("state", "nfev"),
                      ("progress", "num_iterations")):
        assert torch.equal(getattr(getattr(a, rec), name),
                           getattr(getattr(b, rec), name)), name


def test_batch_minor_loop_matches_batch_major_loop(layout):
    calls = layout(False)
    rows = solve(tstop(max_iterations=8))
    assert calls["t"] == 0 and calls["rows"] == 9
    calls = layout(True)
    minor = solve(tstop(max_iterations=8))
    assert calls["rows"] == 0 and calls["t"] == 9
    same_counts(rows, minor)
    np.testing.assert_allclose(minor.state.x.numpy(), rows.state.x.numpy(),
                               rtol=1e-12, atol=1e-12)
    # The result is batch-major whatever layout the loop ran on.
    assert isinstance(minor.internals, cns.solvers.LbfgsInternals)
    assert tuple(minor.internals.s_memory.shape) == (20, 10, 12)
    for name, v in vars(rows.internals).items():
        np.testing.assert_allclose(getattr(minor.internals, name).numpy(),
                                   v.numpy(), rtol=1e-12, atol=1e-12,
                                   err_msg=name)


def test_batch_minor_loop_matches_jax_short_budget(layout):
    layout(True)
    ref = jcns.minimize_batched(JOBJ, jnp.asarray(X0), JaxLbfgs(),
                                jstop(max_iterations=8), trace=1)
    res = solve(tstop(max_iterations=8))
    np.testing.assert_array_equal(res.progress.status.numpy(),
                                  np.asarray(ref.progress.status))
    np.testing.assert_array_equal(res.state.nfev.numpy(),
                                  np.asarray(ref.state.nfev))
    np.testing.assert_array_equal(res.progress.num_iterations.numpy(),
                                  np.asarray(ref.progress.num_iterations))
    np.testing.assert_allclose(res.state.x.numpy(), np.asarray(ref.state.x),
                               rtol=1e-12, atol=1e-12)


def test_batch_minor_loop_matches_jax_full_solve(layout):
    layout(True)
    # The starts of tests/test_torch_nested_solve.py's full solve.
    x0 = np.random.default_rng(2).uniform(-2, 2, (16, 8))
    ref = jcns.minimize_batched(JOBJ, jnp.asarray(x0), JaxLbfgs(), trace=1)
    res = solve(x0=x0)
    np.testing.assert_array_equal(res.progress.status.numpy(),
                                  np.asarray(ref.progress.status))
    assert abs(res.state.nfev.double().mean().item()
               - np.asarray(ref.state.nfev).mean()) < 3.0
    np.testing.assert_allclose(res.state.value.numpy(),
                               np.asarray(ref.state.value), atol=1e-6)


def test_warm_start_and_resume_through_the_batch_minor_loop(layout):
    layout(False)
    want_cut = solve(tstop(max_iterations=5))
    want_full = solve()
    want_warm = solve(tstop(max_iterations=6), internals=want_full.internals)
    calls = layout(True)
    cut = solve(tstop(max_iterations=5))
    assert isinstance(cut.internals, cns.solvers.LbfgsInternals)
    kept = tree_map(torch.clone, cut.internals)
    res = cns.resume(TOBJ, cut, SOLVER, device="cpu")
    assert calls["t"] > 6 and calls["rows"] == 0
    assert isinstance(res.internals, cns.solvers.LbfgsInternals)
    # The checkpoint is not changed by the loop's in-place kernels.
    for name, v in vars(kept).items():
        assert torch.equal(v, getattr(cut.internals, name)), name
    same_counts(cut, want_cut)
    # The same trajectory as the batch-major loop, cut and resumed.
    rows_res = None
    layout(False)
    rows_res = cns.resume(TOBJ, want_cut, SOLVER, device="cpu")
    same_counts(res, rows_res)
    np.testing.assert_allclose(res.state.x.numpy(), rows_res.state.x.numpy(),
                               rtol=1e-12, atol=1e-12)
    # A result of either loop feeds internals= of the other.
    layout(True)
    warm = solve(tstop(max_iterations=6), internals=want_full.internals)
    assert isinstance(warm.internals, cns.solvers.LbfgsInternals)
    same_counts(warm, want_warm)
    np.testing.assert_allclose(warm.state.x.numpy(),
                               want_warm.state.x.numpy(), rtol=1e-12,
                               atol=1e-12)
    layout(False)
    again = solve(tstop(max_iterations=6), internals=warm.internals)
    assert bool(again.state.value.isfinite().all())


def test_batched_step_and_update_freezes_done_lanes_bit_for_bit():
    """The freeze contract on the batch-minor carry, started from
    ``init_batched(batch_minor=True)``: one more iteration returns a done
    lane's whole carry (state, internals, progress) bit for bit, and the
    live lanes walk the batch-major step's way."""
    b, n = 8, 6
    solver = cns.Lbfgs(m=4)
    x0 = torch.from_numpy(np.random.default_rng(0).uniform(-2, 2, (b, n)))
    stopping = solver.default_stopping(x0.dtype)
    carries = []
    for minor in (True, False):
        state = TOBJ.evaluate(x0.clone())
        internals = solver.init_batched(TOBJ, state, batch_minor=minor)
        progress = cns.init_progress((b,), x0.dtype)
        step = (solver.batched_step_and_update if minor
                else solver.step_and_update)
        for _ in range(3):
            step(TOBJ, state, internals, progress, stopping,
                 progress.status != 0)
        carries.append((state, internals, progress, step))
    state, internals, progress, step = carries[0]
    assert isinstance(internals, cns.solvers.LbfgsInternalsT)
    assert tuple(internals.s_memory_t.shape) == (4 * n, b)
    assert bool((internals.mem_count > 0).all())
    np.testing.assert_allclose(state.x.numpy(), carries[1][0].x.numpy(),
                               rtol=1e-12, atol=1e-12)
    done = torch.arange(b) % 2 == 0
    progress.status[done] = int(cns.Status.FINISHED)
    before = [tree_map(torch.clone, t) for t in (state, internals, progress)]
    step(TOBJ, state, internals, progress, stopping, done)
    for old, new in zip(before, (state, internals, progress)):
        for name, v in vars(old).items():
            w = getattr(new, name)
            if name.endswith("_t"):  # the lanes are the minor dimension
                v, w = v.t(), w.t()
            assert torch.equal(v[done], w[done]), name
    assert not torch.equal(before[0].x[~done], state.x[~done])
    assert bool((progress.num_iterations[~done] == 4).all())


def test_routing_rule_reads_the_class_attributes(monkeypatch):
    x = torch.zeros((256, 64), dtype=torch.float64)
    monkeypatch.setattr(cns.Lbfgs, "_TRANSPOSED_N_MAX", 64)
    monkeypatch.setattr(cns.Lbfgs, "_TRANSPOSED_B_MIN", 128)
    assert SOLVER.supports_batched_native(TOBJ, x)
    assert SOLVER.supports_batched_native(TOBJ, x.float())
    assert not SOLVER.supports_batched_native(TOBJ, x[:100])
    assert not SOLVER.supports_batched_native(
        TOBJ, torch.zeros((256, 66), dtype=torch.float64))
    assert not cns.Lbfgs(use_hessian_preconditioner=True
                         ).supports_batched_native(TOBJ, x)
    monkeypatch.setattr(cns.Lbfgs, "_TRANSPOSED_N_MAX", 0)
    assert not SOLVER.supports_batched_native(TOBJ, x)


def test_routed_path_runs_at_a_routed_shape(layout):
    """Under the shipped class attributes the loop takes the layout they
    name for this shape and returns batch-major internals."""
    x0 = np.random.default_rng(5).uniform(-2, 2, (130, 4))
    routed = SOLVER.supports_batched_native(TOBJ, torch.from_numpy(x0))
    calls = layout(None)
    res = solve(tstop(max_iterations=3), x0=x0)
    assert calls["t" if routed else "rows"] == 4
    assert calls["rows" if routed else "t"] == 0
    assert isinstance(res.internals, cns.solvers.LbfgsInternals)
