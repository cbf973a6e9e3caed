"""The two calibration kernels' plain versions (``ops/floors.py``) against
the Pallas kernel bodies of ``benchmarks/roofline.py``, and the calibration
loops of ``benchmarks_torch/roofline.py``, on the CPU.

The JAX kernels are closures inside ``measure_loop_trip_overhead_us``
(:560-562) and ``measure_launch_overhead_us`` (:640-641) and cannot be
imported: their bodies are copied here and run through ``pl.pallas_call``
in interpret mode with default block specs.  Plain version and kernel body
must agree bit for bit (float32, seeded numpy inputs).  The body runs in a
process of its own with ``XLA_FLAGS=--xla_backend_optimization_level=0``:
at its default level XLA's CPU backend contracts ``i * 0.999 + 1e-6`` into
one fused multiply-add (one rounding where the body has two), which is
one float32 ulp away on about a third of the elements; the port's kernel
multiplies, then adds, each rounded (``--fmad=false``), as the body is
written.  The kernels on the card are held to the plain versions by
``chip_smoke.py``'s ``floors_main``.
"""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from benchmarks import roofline as jroofline
from benchmarks_torch import roofline
from cppnumericalsolvers_tpu_torch.core.tree import any_lane
from cppnumericalsolvers_tpu_torch.ops import _build, floors

torch.set_num_threads(1)

NBUF = 8
SHAPE = (8, 128)
LAUNCHES = (1, 7)
TRIPS = (1, 5, 12)
CSRC = Path(_build.__file__).resolve().parent / "csrc"
ROOT = Path(__file__).resolve().parents[1]

# The kernel bodies (benchmarks/roofline.py:560-562 and :640-641), each
# through pl.pallas_call in interpret mode with default block specs; the
# script writes their outputs on seeded inputs to the .npz it is given.
JAX_BODIES = textwrap.dedent("""
    import sys
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import pallas as pl

    NBUF = 8

    def tiny_trip_kernel(*refs):
        ins, outs = refs[:NBUF], refs[NBUF:]
        for i, o in zip(ins, outs):
            o[:] = i[:] * 0.999 + 1e-6

    def tiny_trip(*bufs):
        return pl.pallas_call(
            tiny_trip_kernel,
            out_shape=tuple(jax.ShapeDtypeStruct(b.shape, b.dtype)
                            for b in bufs),
            input_output_aliases={i: i for i in range(NBUF)},
            interpret=True,
        )(*bufs)

    def tiny_launch_kernel(x_ref, o_ref):
        o_ref[:] = x_ref[:] + 1.0

    def tiny_launch(x):
        return pl.pallas_call(
            tiny_launch_kernel,
            out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
            interpret=True)(x)

    def seeded(seed, count):
        rng = np.random.default_rng(seed)
        return [rng.uniform(-2.0, 2.0, (8, 128)).astype(np.float32)
                for _ in range(count)]

    out = {}
    for k in (1, 7):
        bufs = tuple(jnp.asarray(b) for b in seeded(0, NBUF))
        x = jnp.asarray(seeded(1, 1)[0])
        for _ in range(k):
            bufs = tiny_trip(*bufs)
            x = tiny_launch(x)
        out[f"trip_{k}"] = np.stack([np.asarray(b) for b in bufs])
        out[f"launch_{k}"] = np.asarray(x)
    for k in (1, 5, 12):
        bufs = tuple(jnp.ones((8, 128), jnp.float32) * i
                     for i in range(NBUF))
        for _ in range(k):
            bufs = tiny_trip(*bufs)
        out[f"loop_{k}"] = np.stack([np.asarray(b) for b in bufs])
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def bodies(tmp_path_factory):
    """The JAX kernel bodies' outputs, from a process whose XLA emits the
    body's arithmetic as written."""
    path = tmp_path_factory.mktemp("floors") / "bodies.npz"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_backend_optimization_level=0"}
    subprocess.run([sys.executable, "-c", JAX_BODIES, str(path)], env=env,
                   check=True, timeout=300, cwd=ROOT)
    with np.load(path) as f:
        return dict(f)


def seeded(seed, count=1):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-2.0, 2.0, SHAPE).astype(np.float32)
            for _ in range(count)]


@pytest.mark.parametrize("launches", LAUNCHES)
def test_trip_floor_plain_version_is_the_kernel_body(launches, bodies):
    got = [torch.from_numpy(b.copy()) for b in seeded(0, NBUF)]
    for _ in range(launches):
        floors.trip_floor(got)
    for g, w in zip(got, bodies[f"trip_{launches}"]):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("launches", LAUNCHES)
def test_launch_floor_plain_version_is_the_kernel_body(launches, bodies):
    (x,) = seeded(1)
    a, b = torch.from_numpy(x.copy()), torch.empty(SHAPE)
    for _ in range(launches):
        floors.launch_floor(a, out=b)
        a, b = b, a
    np.testing.assert_array_equal(a.numpy(), bodies[f"launch_{launches}"])
    if launches == 1:
        np.testing.assert_array_equal(
            floors.launch_floor_reference(torch.from_numpy(x)).numpy(),
            bodies["launch_1"])


def test_xla_contracts_the_multiply_add_at_its_default_level():
    """Why the bodies run at optimisation level 0: in this process (XLA's
    default) the trip body is one fused multiply-add, within one float32
    ulp of the two rounded operations and not equal to them."""

    def kernel(i_ref, o_ref):
        o_ref[:] = i_ref[:] * 0.999 + 1e-6

    x = np.concatenate(seeded(0, NBUF))
    fused = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True)(jnp.asarray(x)))
    plain = floors.trip_floor_reference([torch.from_numpy(x.copy())])[0]
    ulp = np.spacing(np.abs(fused))
    assert (np.abs(fused - plain.numpy()) <= ulp).all()
    exact = x.astype(np.float64) * np.float64(np.float32(0.999)) + \
        np.float64(np.float32(1e-6))
    if not np.array_equal(fused, plain.numpy()):
        np.testing.assert_array_equal(fused, exact.astype(np.float32))


def test_wrappers_check_their_arguments():
    bufs = [torch.zeros(SHAPE) for _ in range(NBUF)]
    with pytest.raises(ValueError, match="8 buffers"):
        floors.trip_floor(bufs[:7])
    with pytest.raises(ValueError, match="shape"):
        floors.trip_floor(bufs[:7] + [torch.zeros(4, 128)])
    with pytest.raises(ValueError, match="contiguous"):
        floors.trip_floor(bufs[:7] + [torch.zeros(128, 8).T])
    with pytest.raises(TypeError):
        floors.trip_floor([b.int() for b in bufs])
    x = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="must not be x"):
        floors.launch_floor(x, out=x)
    with pytest.raises(ValueError, match="shape"):
        floors.launch_floor(x, out=torch.zeros(4, 4))


@pytest.mark.parametrize("name,ptrs,ints", [("trip_floor", 8, 1),
                                            ("launch_floor", 2, 1)])
def test_entry_points_match_the_build_declaration(name, ptrs, ints):
    """Both kernels are built with the other eight (``_build.KERNELS``, so
    ``build_all`` compiles the ten in one pool); their C entry points take
    the buffers' pointers, the element count and the stream."""
    sig = _build.KERNELS[name]
    assert sig.count(_build._P) == ptrs + 1 and sig.count(_build._I) == ints
    src = (CSRC / f"{name}.cu").read_text()
    found = re.search(r'extern "C" int NAME\((.*?)\)\s*\{', src, re.S)
    params = [p.strip() for p in found.group(1).replace("\\", " ").split(",")]
    assert sum("*" in p for p in params) == ptrs + 1
    assert sum(p.startswith("int ") for p in params) == ints
    assert f"cppns_{name}_f32" in src and f"cppns_{name}_f64" in src
    assert len(_build.KERNELS) == 10


@pytest.mark.parametrize("trips", TRIPS)
def test_trip_loop_makes_one_launch_and_one_read_a_trip(trips, monkeypatch,
                                                        bodies):
    """K trips of the trip-floor loop: exactly K ``trip_floor`` calls and K
    device-to-host reads (``any_lane``), each launch on the 8 buffers."""
    calls = []

    def counting(bufs):
        calls.append(len(bufs))
        return floors.trip_floor_reference(bufs)

    monkeypatch.setattr(floors, "trip_floor", counting)
    reads0 = any_lane.reads
    x, bufs = roofline.trip_floor_loop(trips, "cpu")
    assert any_lane.reads - reads0 == trips
    assert calls == [NBUF] * trips
    assert tuple(x.shape) == SHAPE
    for got, want in zip(bufs, bodies[f"loop_{trips}"]):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("length", [1, 4, 9])
def test_launch_chain_makes_one_launch_a_link(length, monkeypatch):
    calls = []

    def counting(x, out=None):
        calls.append(1)
        return floors.launch_floor_reference(x, out)

    monkeypatch.setattr(floors, "launch_floor", counting)
    a, b = torch.zeros(SHAPE), torch.empty(SHAPE)
    out = roofline.launch_chain(length, a, b)
    assert len(calls) == length
    assert bool((out == float(length)).all())


def test_grid_is_the_jax_benchmarks_grid():
    assert roofline.GRID == jroofline.GRID
    assert (1024, 256) in roofline.GRID


def test_trip_bound_names_its_binding_term():
    by_bytes = roofline.trip_bound(10, 3.35e9, 0.001, 0.002)
    assert by_bytes["bound_by"] == "bytes"
    assert by_bytes["bound_ms"] == pytest.approx(10.0)
    assert by_bytes["evaluation_and_trip_floor_ms"] == pytest.approx(0.03)
    by_floor = roofline.trip_bound(10, 1.0, 0.5, 1.5)
    assert by_floor["bound_by"] == "evaluation_and_trip_floor"
    assert by_floor["bound_ms"] == pytest.approx(20.0)


def test_trip_work_counts_every_trip_of_the_solve():
    """``trip_work`` (which ``chip_smoke.py``'s timing calls) counts one
    entry a trip of the same solve the flat path runs, at least the bytes
    a live lane's search step moves."""
    import cppnumericalsolvers_tpu_torch as cns

    obj = cns.models.pairwise_rosenbrock()
    x0 = torch.from_numpy(
        np.random.default_rng(0).uniform(-2.0, 2.0, (16, 32))).float()
    stop = cns.default_stopping(torch.float32)
    work = roofline.trip_work(obj, x0, stop)
    res = cns.minimize_batched(obj, x0, cns.Lbfgs(m=10,
                                                  max_linesearch_fev=20),
                               stop, device="cpu")
    assert work["trips"] == res.trips
    assert work["bytes_per_trip"] >= 2 * 32 * 4
    assert work["bound_by"] == "bytes"
    assert work["bound_ms"] == pytest.approx(
        work["bytes_per_trip"] / roofline.HBM_BYTES_PER_S * 1e3)


@pytest.mark.parametrize("fn", [roofline.measure_loop_trip_overhead_us,
                                roofline.measure_launch_overhead_us])
def test_measurements_need_a_card(fn):
    with pytest.raises(RuntimeError, match="CUDA device"):
        fn(device="cpu")
