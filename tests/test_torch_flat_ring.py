"""The flat solve's ring-indexed history and the lane mapping of the
redesigned kernels.

* The ring under wrap-around: a float64 solve with ``m = 3`` and a budget of
  10 iterations goes through the port's plain trip (``flat_trip_reference``,
  what ``flat_trip`` takes for CPU tensors), whose history is a ring inside
  the loop, and through the JAX package's ``_flat_kernel`` in interpret mode,
  whose history shifts.  Statuses, nfev and iterations are exact, iterates
  agree within 1e-12, and the exit history (gathered into chronological
  order) and gamma within 1e-10, as tests/test_torch_flat_solve.py holds the
  short-budget solve.
* The mapping helper (``ops/_kernel.py::lane_mapping``): every shape the
  card runs, ragged ones too, in both dtypes, gets a mapping whose shared
  memory fits a Hopper block, for each of the five kernels that take one;
  the history kernels reach n = 28,760 in float64 and 57,816 in float32 at
  m = 10 (rows read in place) and raise beyond.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu.ops.flat_solve import (
    flat_lbfgs_solve as jax_flat_solve,
)
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.convert import from_jax_numpy
from cppnumericalsolvers_tpu_torch.ops import _build, _kernel
from cppnumericalsolvers_tpu_torch.ops import flat_solve as fs

torch.set_num_threads(1)

M = 3
BUDGET = 10


def jax_rosen(x):
    e, o = x[0::2], x[1::2]
    return jnp.sum(100.0 * (o - e**2) ** 2 + (1.0 - e) ** 2)


@functools.lru_cache(maxsize=None)
def wrapped():
    """Both solves from one start; the port's loop also reports the heads
    its ring ended on."""
    x0 = np.random.default_rng(11).uniform(-2, 2, (12, 10))
    jobj = jcns.objective(jax_rosen, mode="first")
    jstop = jcns.default_stopping(jnp.float64).replace(
        max_iterations=BUDGET)
    state0 = jax.vmap(lambda x: jobj.evaluate(x, nfev=0))(jnp.asarray(x0))
    theirs = jax_flat_solve(jobj, state0, jstop, m=M, max_fev=20,
                            interpret=True)

    tobj = cns.models.pairwise_rosenbrock()
    tstop = cns.default_stopping(torch.float64).replace(
        max_iterations=BUDGET)
    heads = []

    def trip(st, *args):
        fs.flat_trip_reference(st, *args)
        heads.append(st.si[:, fs._I_HEAD].clone())

    mine = fs.flat_lbfgs_solve(
        tobj, tobj.evaluate(torch.from_numpy(x0)), tstop, m=M, max_fev=20,
        trip=trip)
    return x0, theirs, mine, torch.stack(heads)


def test_ring_wraps_around():
    _, _, mine, heads = wrapped()
    # More accepted pairs than rows: the head moved off 0 and back.
    assert int(mine.progress.num_iterations.min()) > M
    assert int(heads.max()) == M - 1
    assert bool((heads[-1] != 0).any())
    assert bool((mine.count == M).all())


def test_ring_trajectory_matches_jax_flat_kernel():
    _, (st, _, pr), mine, _ = wrapped()
    np.testing.assert_array_equal(mine.progress.status.numpy(),
                                  np.asarray(pr.status))
    np.testing.assert_array_equal(mine.state.nfev.numpy(),
                                  np.asarray(st.nfev))
    np.testing.assert_array_equal(mine.progress.num_iterations.numpy(),
                                  np.asarray(pr.num_iterations))
    np.testing.assert_allclose(mine.state.x.numpy(), np.asarray(st.x),
                               rtol=1e-12, atol=1e-12)


def test_ring_exit_history_is_chronological():
    x0, (st, (s_t, y_t, count, gamma), _), mine, _ = wrapped()
    b, n = x0.shape
    theirs = from_jax_numpy(
        {"s_memory_t": s_t, "y_memory_t": y_t, "mem_count": count,
         "gamma": gamma}, n=n, m=M)
    np.testing.assert_array_equal(mine.count.numpy(),
                                  theirs.mem_count.numpy())
    for a, c in ((mine.s, theirs.s_memory), (mine.y, theirs.y_memory),
                 (mine.gamma, theirs.gamma)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0, atol=1e-10)


def test_history_in_age_order_gathers_by_head():
    buf = torch.arange(2 * 3 * 2).reshape(2, 3, 2)
    out = fs.history_in_age_order(buf, torch.tensor([0, 2]))
    assert torch.equal(out[0], buf[0])
    assert torch.equal(out[1], buf[1, [2, 0, 1]])


# Every (B, n) that chip_smoke.py runs the two kernels at, and ragged ones.
SHAPES = sorted({(1024, 32), (8192, 32), (1024, 1024), (256, 4096),
                 (1000, 32), (1024, 100), (1024, 96), (1024, 256),
                 (512, 2048), (256, 64), (1, 2), (1000, 1024)})


@pytest.mark.parametrize("op", ["flat_trip", "lbfgs_prologue"])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("b,n", SHAPES)
def test_lane_mapping_fits_a_block(b, n, itemsize, op):
    mp = _kernel.lane_mapping(op, b, n, 10, itemsize)
    assert mp.smem_bytes <= _kernel.SMEM_LIMIT
    assert mp.smem_bytes == _kernel.lane_smem_bytes(
        10, n, itemsize, mp.rows, mp.lanes_per_block,
        mp.threads_per_lane == 32)
    if n <= 64:
        assert mp.threads_per_lane == 32
        assert 1 <= mp.lanes_per_block <= 8
        assert mp.blocks * mp.lanes_per_block >= b
        assert (mp.blocks - 1) * mp.lanes_per_block < b
    else:
        assert mp.lanes_per_block == 1 and mp.blocks == b
        assert mp.threads_per_lane % 32 == 0
        assert 64 <= mp.threads_per_lane <= 512
    assert mp.rows in (_kernel.ROWS_STREAM, _kernel.ROWS_STAGED,
                       _kernel.ROWS_DIRECT)
    assert mp.scalars() == (mp.lanes_per_block, mp.threads_per_lane,
                            mp.rows)


def test_lane_mapping_choices_at_the_main_shapes():
    def pick(op, b, n, itemsize=4):
        mp = _kernel.lane_mapping(op, b, n, 10, itemsize)
        return mp.lanes_per_block, mp.threads_per_lane, mp.rows, mp.blocks

    S, T, D = _kernel.ROWS_STREAM, _kernel.ROWS_STAGED, _kernel.ROWS_DIRECT
    # A warp per lane: at least two blocks per SM at (1024, 32), a ragged
    # last block at 1000 lanes.
    assert pick("flat_trip", 1024, 32) == (3, 32, D, 342)
    assert pick("flat_trip", 1000, 32) == (3, 32, D, 334)
    assert pick("lbfgs_prologue", 8192, 32) == (8, 32, D, 1024)
    # A block per lane.
    assert pick("flat_trip", 1024, 1024) == (1, 128, S, 1024)
    assert pick("flat_trip", 256, 4096) == (1, 512, S, 256)
    assert pick("flat_trip", 1024, 100) == (1, 64, S, 1024)
    assert pick("lbfgs_prologue", 1024, 100) == (1, 64, T, 1024)
    assert pick("lbfgs_prologue", 1024, 256) == (1, 64, T, 1024)
    assert pick("lbfgs_prologue", 1024, 1024) == (1, 128, S, 1024)
    assert pick("lbfgs_prologue", 512, 2048) == (1, 256, S, 512)
    assert pick("lbfgs_prologue", 256, 4096) == (1, 512, S, 256)
    # flat_trip never stages: most of its lanes touch no history.
    for b, n in SHAPES:
        for itemsize in (4, 8):
            assert pick("flat_trip", b, n, itemsize)[2] != T


def test_lane_mapping_raises_where_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        _kernel.lane_mapping("lbfgs_prologue", 4, 40000, 10, 8)
    assert fs.flat_trip_smem_bytes(10, 40000, 8) > fs._SMEM_LIMIT


@pytest.mark.parametrize("op", ["push_two_loop", "lbfgs_epilogue"])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("b,n", SHAPES)
def test_push_and_epilogue_mappings_fit_a_block(b, n, itemsize, op):
    mp = _kernel.lane_mapping(op, b, n, 10, itemsize)
    assert mp.smem_bytes <= _kernel.SMEM_LIMIT
    assert mp.lanes_per_block * mp.blocks >= b * mp.cluster
    assert mp.scalars() == (mp.lanes_per_block, mp.threads_per_lane,
                            mp.rows)
    if n <= 64:
        assert (mp.threads_per_lane, mp.cluster) == (32, 1)
        assert 1 <= mp.lanes_per_block <= 8
        assert (mp.blocks - 1) * mp.lanes_per_block < b
        return
    assert mp.lanes_per_block == 1 and mp.blocks == b * mp.cluster
    assert mp.cluster in (1, 2, 4)
    block = mp.threads_per_lane // mp.cluster
    assert block * mp.cluster == mp.threads_per_lane
    assert block % 32 == 0 and 64 <= block <= 512
    if op == "push_two_loop":
        assert mp.cluster == 1
        assert mp.smem_bytes == _kernel.lane_smem_bytes(
            10, n, itemsize, mp.rows, 1, False)
    else:
        # No history: only the reduction scratch, and a cluster only while
        # the grid has fewer than two blocks per SM.
        assert mp.rows == _kernel.ROWS_DIRECT
        assert mp.cluster == 1 or b * mp.cluster // 2 < 132


def test_push_and_epilogue_choices_at_the_main_shapes():
    def pick(op, b, n, itemsize=4):
        mp = _kernel.lane_mapping(op, b, n, 10, itemsize)
        return (mp.lanes_per_block, mp.threads_per_lane, mp.rows, mp.blocks,
                mp.cluster)

    S, T, D = _kernel.ROWS_STREAM, _kernel.ROWS_STAGED, _kernel.ROWS_DIRECT
    R = _kernel.ROWS_REGISTERS
    # push_two_loop takes the prologue's mapping, but that a warp holds the
    # rows in registers where m <= 10: path B's shapes and the made-up calls
    # of chip_smoke.py.
    for b, n in SHAPES:
        for itemsize in (4, 8):
            mine = _kernel.lane_mapping("push_two_loop", b, n, 10, itemsize)
            theirs = _kernel.lane_mapping("lbfgs_prologue", b, n, 10,
                                          itemsize)
            if n <= 64:
                assert mine.rows == R
                mine = dataclasses.replace(mine, rows=theirs.rows)
            elif mine.rows != theirs.rows:
                # Staged rows where eight lanes fit an SM, not four.
                assert (mine.rows, theirs.rows) == (S, T)
                mine = dataclasses.replace(
                    mine, rows=T, smem_bytes=theirs.smem_bytes)
            assert mine == theirs
    assert pick("push_two_loop", 1024, 32) == (3, 32, R, 342, 1)
    assert _kernel.lane_mapping("push_two_loop", 1024, 32, 11, 4).rows == D
    assert pick("push_two_loop", 1024, 256) == (1, 64, T, 1024, 1)
    assert pick("push_two_loop", 1024, 256, 8) == (1, 64, S, 1024, 1)
    assert pick("push_two_loop", 1024, 1024) == (1, 128, S, 1024, 1)
    assert pick("push_two_loop", 256, 4096) == (1, 512, S, 256, 1)
    # lbfgs_epilogue: a warp per lane, a block per lane, and clusters of 2
    # and 4 where B is below one block per SM.
    assert pick("lbfgs_epilogue", 1024, 32) == (3, 32, D, 342, 1)
    assert pick("lbfgs_epilogue", 1024, 100) == (1, 64, D, 1024, 1)
    assert pick("lbfgs_epilogue", 1024, 1024) == (1, 128, D, 1024, 1)
    assert pick("lbfgs_epilogue", 512, 2048) == (1, 256, D, 512, 1)
    assert pick("lbfgs_epilogue", 256, 4096) == (1, 512, D, 256, 1)
    assert pick("lbfgs_epilogue", 100, 4096) == (1, 512, D, 200, 2)
    assert pick("lbfgs_epilogue", 64, 16384) == (1, 2048, D, 256, 4)
    # Too narrow to split: a slice would hold fewer than 512 elements.
    assert pick("lbfgs_epilogue", 256, 1000) == (1, 128, D, 256, 1)


@pytest.mark.parametrize("op", ["flat_trip", "lbfgs_prologue",
                                "push_two_loop"])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("b,n", [(64, 16384), (64, 8192)])
def test_lane_mapping_reaches_large_n(b, n, itemsize, op):
    # Where the stream's row buffers do not fit a block (n > 5,752 in
    # float64, n > 11,563 in float32 at m = 10) the rows are read in place.
    mp = _kernel.lane_mapping(op, b, n, 10, itemsize)
    stream = _kernel.lane_smem_bytes(10, n, itemsize, _kernel.ROWS_STREAM,
                                     1, False)
    assert mp.smem_bytes <= _kernel.SMEM_LIMIT
    assert (mp.rows == _kernel.ROWS_DIRECT) == (stream > _kernel.SMEM_LIMIT)
    assert (mp.lanes_per_block, mp.threads_per_lane, mp.blocks) == (
        1, 512, b)


@pytest.mark.parametrize("op", ["flat_trip", "lbfgs_prologue",
                                "push_two_loop"])
@pytest.mark.parametrize("itemsize,reach", [(8, 28760), (4, 57816)])
def test_lane_mapping_reach_in_n_at_m_10(op, itemsize, reach):
    mp = _kernel.lane_mapping(op, 4, reach, 10, itemsize)
    assert mp.rows == _kernel.ROWS_DIRECT
    with pytest.raises(ValueError, match="shared memory"):
        _kernel.lane_mapping(op, 4, reach + 1, 10, itemsize)
    with pytest.raises(ValueError, match="shared memory"):
        _kernel.lane_mapping(op, 4, 40000 * 8 // itemsize, 10, itemsize)


def test_build_declares_the_new_entry_points_and_reads_ptxas():
    """The redesigned entry points take three more ints (the mapping) after
    ``b, n, m`` (the epilogue after ``b, n``); the build keeps ptxas's
    register, spill and stack-frame report."""
    assert callable(_build.build_all) and callable(_build.load)
    ints = _build.KERNELS["flat_trip"].count(_build._I)
    assert ints == 7 + 6  # b, n, m, max_fev, mapping; the criteria's ints
    assert _build.KERNELS["lbfgs_prologue"].count(_build._I) == 6
    assert _build.KERNELS["push_two_loop"].count(_build._I) == 6
    assert _build.KERNELS["lbfgs_epilogue"].count(_build._I) == 5 + 6
    assert "-v" in _build.NVCC_FLAGS
    text = (
        "ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1kv\n"
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill "
        "loads\n"
        "ptxas info    : Used 64 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z1jv' for 'sm_90a'\n"
        "ptxas info    : Used 40 registers\n"
        "ptxas info    : Compiling entry function '_Z1iv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1iv\n"
        "    256 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers\n")
    # The stack frame is the fifth figure: a register array indexed at run
    # time lands there with no spill reported.
    assert _build.parse_ptxas(text) == [("_Z1kv", 64, 8, 12, 0),
                                        ("_Z1jv", 40, 0, 0, 0),
                                        ("_Z1iv", 96, 0, 0, 256)]
