"""The batch-minor loop's ring-indexed history and the launch plans of the
two kernels redesigned with it (``lbfgs_prologue_t``, ``mt_trip``).

* The ring under wrap-around, op by op: a sequence of float64 prologue calls
  with ``m = 3`` (more accepted pairs than rows, pairs the curvature gate
  rejects, lanes whose descent check resets the history, done lanes) goes
  through the port's plain version twice, once on a ring (``head`` given)
  and once chronological (no head: the history shifts), and through the JAX
  package's ``_prologue_xla_single`` under ``jax.vmap``.  Every output is
  equal to the chronological version's, and the ring gathered by age
  (``gather_rows``) is the shifting version's history bit for bit; against
  JAX the count is exact and floats agree within 1e-12.
* The batch-minor loop with ``m = 3`` against the batch-major loop and the
  JAX package under a short budget (float64): status, nfev and iterations
  exact, iterates within 1e-12, and the returned history equal to the
  batch-major loop's within 1e-12.
* ``convert.from_jax_numpy`` of JAX's ``LbfgsInternalsT`` starts the ring at
  head 0 and round-trips through ``to_rows``.
* The launch plans (pure Python): ``prologue_t_launch_plan`` and
  ``lane_mapping("mt_trip", ...)`` fill the card (at least 2 x 132 blocks,
  or 16 warps per SM) and fit a block's shared memory at the routing and
  nested shapes in both dtypes; the plan raises where nothing fits; the
  build declares the changed C entry points as their sources define them.
"""

import re
from pathlib import Path

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
from cppnumericalsolvers_tpu_torch.ops import _build, _kernel
from cppnumericalsolvers_tpu_torch.ops import fused_step_t as ft

torch.set_num_threads(1)

M = 3
STEPS = 9


def t(a):
    return torch.from_numpy(np.array(a))


def step_inputs(rng, b, n, k):
    """Inputs of call ``k`` of the op sequence: pairs with ``y`` near ``s``
    (accepted), a pair with negative curvature on lanes ``i % 5 == k % 5``
    (rejected), a zero gradient on lane ``k % b`` (no descent: reset), and
    done lanes ``i % 7 == 3``."""
    x = rng.standard_normal((b, n))
    g = rng.standard_normal((b, n))
    sn = 0.1 * rng.standard_normal((b, n))
    yn = sn + 0.02 * rng.standard_normal((b, n))
    lanes = np.arange(b)
    yn[lanes % 5 == k % 5] *= -1.0
    g[k % b] = 0.0
    valid = lanes % 11 != (k % 11)
    done = lanes % 7 == 3
    return x, g, sn, yn, valid, done


def test_ring_wraps_around_and_gathers_to_the_shifting_history():
    b, n = 12, 6
    rng = np.random.default_rng(7)
    chrono = [torch.zeros((M * n, b), dtype=torch.float64) for _ in range(2)]
    ring = [torch.zeros((M * n, b), dtype=torch.float64) for _ in range(2)]
    jax_s = jnp.zeros((b, M, n))
    jax_y = jnp.zeros((b, M, n))
    count_c = torch.zeros(b, dtype=torch.int32)
    count_r = torch.zeros(b, dtype=torch.int32)
    jax_count = jnp.zeros(b, jnp.int32)
    gamma_c = torch.ones(b, dtype=torch.float64)
    gamma_r = torch.ones(b, dtype=torch.float64)
    jax_gamma = jnp.ones(b)
    head = torch.zeros(b, dtype=torch.int32)
    resets = wraps = 0
    for k in range(STEPS):
        x, g, sn, yn, valid, done = step_inputs(rng, b, n, k)
        args = [t(a) for a in (x, g)]
        rest = [t(a) for a in (sn, yn, valid, done)]
        before = count_r.clone()
        want = ft.lbfgs_prologue_t(*args, *chrono, count_c, gamma_c, *rest)
        got = ft.lbfgs_prologue_t(*args, *ring, count_r, gamma_r, *rest,
                                  head=head)
        jout = jax.vmap(_prologue_xla_single)(
            jnp.asarray(x), jnp.asarray(g), jax_s, jax_y, jax_count,
            jax_gamma, jnp.asarray(sn), jnp.asarray(yn), jnp.asarray(valid),
            jnp.asarray(done))
        jax_s, jax_y, jax_count, jax_gamma = jout[3:7]
        for w, o in zip(want[:3], got[:3]):
            assert torch.equal(w, o)
        assert torch.equal(count_c, count_r)
        assert torch.equal(gamma_c, gamma_r)
        for hist_c, hist_r in zip(chrono, ring):
            assert torch.equal(ft.gather_rows(hist_r, head, M, n),
                               ft.history_t_to_rows(hist_c, M, n))
        live = ~done
        np.testing.assert_allclose(got[0].numpy()[live],
                                   np.asarray(jout[0])[live], rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_array_equal(count_r.numpy(), np.asarray(jax_count))
        np.testing.assert_allclose(
            ft.gather_rows(ring[0], head, M, n).numpy(), np.asarray(jax_s),
            rtol=1e-12, atol=1e-12)
        # A done lane keeps its head.
        assert not head[torch.from_numpy(done)].any()
        resets += int(((count_r == 0) & (before > 0) & t(live)).sum())
        wraps = max(wraps, int(head.max()))
    # More than m pairs were accepted (heads wrapped), and some lanes reset.
    assert wraps == M - 1 and resets > 0
    assert len(set(head.tolist())) > 1  # lanes' rings are out of step


def test_op_without_head_keeps_the_chronological_contract():
    """No head: the op's history shifts, as the batch-major plain version's
    does, and equals the JAX package's chronological history."""
    b, n = 10, 5
    rng = np.random.default_rng(3)
    hist = [torch.zeros((M * n, b), dtype=torch.float64) for _ in range(2)]
    count = torch.zeros(b, dtype=torch.int32)
    gamma = torch.ones(b, dtype=torch.float64)
    js = jy = jnp.zeros((b, M, n))
    jc, jg = jnp.zeros(b, jnp.int32), jnp.ones(b)
    for k in range(M + 3):
        x, g, sn, yn, valid, done = step_inputs(rng, b, n, k)
        ft.lbfgs_prologue_t(t(x), t(g), *hist, count, gamma,
                            *(t(a) for a in (sn, yn, valid, done)))
        out = jax.vmap(_prologue_xla_single)(
            *(jnp.asarray(a) for a in (x, g)), js, jy, jc, jg,
            *(jnp.asarray(a) for a in (sn, yn, valid, done)))
        js, jy, jc, jg = out[3:7]
    np.testing.assert_allclose(ft.history_t_to_rows(hist[0], M, n).numpy(),
                               np.asarray(js), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(count.numpy(), np.asarray(jc))


# -- the batch-minor loop with m = 3 -----------------------------------------


def jax_rosen(x):
    e, o = x[0::2], x[1::2]
    return jnp.sum(100.0 * (o - e**2) ** 2 + (1.0 - e) ** 2)


JOBJ = jcns.objective(jax_rosen, mode="first")
TOBJ = cns.models.pairwise_rosenbrock()
X0 = np.random.default_rng(31).uniform(-2, 2, (24, 8))
BUDGET = 11


@pytest.fixture
def batch_minor(monkeypatch):
    def force(on):
        monkeypatch.setattr(cns.Lbfgs, "_TRANSPOSED_B_MIN", 1)
        monkeypatch.setattr(cns.Lbfgs, "_TRANSPOSED_N_MAX",
                            1 << 20 if on else 0)
    return force


def solve(**kw):
    stop = cns.default_stopping(torch.float64).replace(
        max_iterations=BUDGET)
    return cns.minimize_batched(TOBJ, torch.from_numpy(X0), cns.Lbfgs(m=M),
                                stop, device="cpu", trace=1, **kw)


def test_batch_minor_ring_loop_matches_batch_major_loop_and_jax(
        batch_minor, monkeypatch):
    heads = []
    real = cns.Lbfgs.to_rows

    def spy(self, internals):
        heads.append(internals.head.clone())
        return real(self, internals)

    monkeypatch.setattr(cns.Lbfgs, "to_rows", spy)
    batch_minor(True)
    minor = solve()
    batch_minor(False)
    major = solve()
    ref = jcns.minimize_batched(
        JOBJ, jnp.asarray(X0), JaxLbfgs(m=M),
        jcns.default_stopping(jnp.float64).replace(max_iterations=BUDGET),
        trace=1)
    # The loop ran on the ring, and the rings wrapped.
    assert len(heads) == 1 and bool((heads[0] != 0).any())
    for other in (major, None):
        for rec, name in (("progress", "status"), ("state", "nfev"),
                          ("progress", "num_iterations")):
            got = getattr(getattr(minor, rec), name).numpy()
            want = (getattr(getattr(other, rec), name).numpy() if other
                    else np.asarray(getattr(getattr(ref, rec), name)))
            np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_allclose(minor.state.x.numpy(), major.state.x.numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(minor.state.x.numpy(), np.asarray(ref.state.x),
                               rtol=1e-12, atol=1e-12)
    for name in ("s_memory", "y_memory", "mem_count", "gamma"):
        np.testing.assert_allclose(
            getattr(minor.internals, name).numpy(),
            getattr(major.internals, name).numpy(), rtol=1e-12, atol=1e-12,
            err_msg=name)


def test_from_jax_numpy_starts_the_ring_at_head_zero_and_round_trips():
    b, m, n = 6, 4, 5
    rng = np.random.default_rng(2)
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
    assert got.head.dtype == torch.int32 and not got.head.any()
    solver = cns.Lbfgs(m=m)
    rows = solver.to_rows(got)
    np.testing.assert_array_equal(rows.s_memory.numpy(), s)
    np.testing.assert_array_equal(rows.y_memory.numpy(), y)
    back = solver.to_batch_minor(rows)
    assert not back.head.any()
    assert torch.equal(back.s_memory_t, got.s_memory_t)
    # A ring with heads gathers by age.
    got.head = torch.arange(b, dtype=torch.int32) % m
    rolled = solver.to_rows(got).s_memory.numpy()
    for i in range(b):
        np.testing.assert_array_equal(rolled[i], np.roll(s[i], -(i % m), 0))


# -- launch plans ------------------------------------------------------------

ROUTING_SHAPES = [(1024, 32), (1024, 256), (1024, 1024), (512, 2048)]
NESTED_SHAPES = [(1024, 1024), (256, 4096), (1000, 32), (1024, 100)]
FILL_BLOCKS, FILL_WARPS = 2 * 132, 16 * 132


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("b,n", ROUTING_SHAPES + [(1000, 32), (1024, 100)])
def test_prologue_t_plan_fills_the_card_and_fits(b, n, itemsize):
    plan = ft.prologue_t_launch_plan(b, 10, n, itemsize)
    assert plan["blocks"] >= FILL_BLOCKS or plan["warps"] >= FILL_WARPS
    assert plan["smem_bytes"] <= _kernel.SMEM_LIMIT
    # The batch-major kernel's threads of a lane, 8 real warps to each of
    # its warps, spread over the cluster.
    tpl = plan["threads_per_lane"]
    assert tpl == _kernel.lane_threads(n)
    assert plan["warps_per_block"] * plan["cluster"] == 8 * tpl // 32
    assert plan["lane_tile"] == 8 and 1 <= plan["cluster"] <= 8
    assert plan["threads"] == 32 * plan["warps_per_block"] <= 256
    assert -(-n // tpl) <= plan["ept"] <= 16
    assert plan["blocks"] == -(-b // 8) * plan["cluster"]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("b,n", ROUTING_SHAPES + NESTED_SHAPES)
def test_mt_trip_mapping_fills_the_card(b, n, itemsize):
    mp = _kernel.lane_mapping("mt_trip", b, n, 10, itemsize)
    warps = mp.blocks * mp.lanes_per_block * mp.threads_per_lane // 32 if (
        mp.threads_per_lane == 32) else mp.blocks * mp.threads_per_lane // 32
    assert mp.blocks >= FILL_BLOCKS or warps >= FILL_WARPS
    assert mp.rows == _kernel.ROWS_DIRECT
    assert mp.smem_bytes <= _kernel.SMEM_LIMIT
    if n <= 64:
        assert mp.threads_per_lane == 32 and 1 <= mp.lanes_per_block <= 8
        assert (mp.blocks - 1) * mp.lanes_per_block < b
        assert mp.blocks * mp.lanes_per_block >= b
    else:
        assert mp.lanes_per_block == 1 and mp.blocks == b
        # About 8 elements a thread, in registers.
        assert n <= 8 * mp.threads_per_lane or mp.threads_per_lane == 512
        assert 64 <= mp.threads_per_lane <= 512


def test_mt_trip_mapping_choices():
    def pick(b, n):
        mp = _kernel.lane_mapping("mt_trip", b, n, 10, 4)
        return mp.lanes_per_block, mp.threads_per_lane, mp.blocks

    assert pick(1024, 32) == (3, 32, 342)
    assert pick(1000, 32) == (3, 32, 334)
    assert pick(1024, 100) == (1, 64, 1024)
    assert pick(1024, 1024) == (1, 128, 1024)
    assert pick(512, 2048) == (1, 256, 512)
    assert pick(256, 4096) == (1, 512, 256)


def test_prologue_t_plan_raises_where_nothing_fits():
    with pytest.raises(ValueError, match="elements a thread"):
        ft.prologue_t_launch_plan(512, 10, 9000, 4)
    with pytest.raises(ValueError, match="shared memory"):
        ft.prologue_t_launch_plan(1024, 2000, 1024, 8)
    # n = 8192 still fits: 16 elements to each of 512 virtual threads, in 8
    # blocks of 16 warps.
    wide = ft.prologue_t_launch_plan(256, 10, 8192, 8)
    assert (wide["ept"], wide["warps_per_block"]) == (16, 16)


def _c_entry(name):
    """``(pointers, ints)`` of the C entry point that ``csrc/<name>.cu``
    defines (its ``extern "C"`` macro), the stream counted as a pointer."""
    src = (Path(_build.__file__).parent / "csrc" / f"{name}.cu").read_text()
    found = re.search(r'extern "C" int NAME\((.*?)\)\s*\{', src, re.S)
    params = [p.strip() for p in found.group(1).replace("\\", " ").split(",")]
    ptrs = sum("*" in p for p in params)
    ints = sum(p.startswith("int ") for p in params)
    assert ptrs + ints == len(params)
    return ptrs, ints


@pytest.mark.parametrize("name", ["mt_trip", "lbfgs_prologue_t"])
def test_build_declares_the_changed_entry_points(name):
    """Both take the mapping's three ints after ``b, n`` and ``max_fev`` or
    ``m``; the prologue also takes the ring's head."""
    sig = _build.KERNELS[name]
    assert _c_entry(name) == (sig.count(_build._P), sig.count(_build._I))
    assert sig.count(_build._I) == 6
    assert sig.count(_build._P) == {"mt_trip": 9,
                                    "lbfgs_prologue_t": 15}[name]
