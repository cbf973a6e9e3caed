"""The port's public surface: ``minimize`` and ``minimize_batched`` against
the JAX package on the models of ``models/unconstrained.py``, the import
boundary, the device rule of the entry points, and the kernel wrapper's
checks.  Objectives run in float64 on the CPU (``device="cpu"``); statuses
must be equal and values agree within 1e-8.  Evaluation counts are not
compared here: inside its jitted solve XLA on the CPU contracts a*b+c into
fused multiply-adds and PyTorch does not, so two trajectories can part at
the last bit and end one evaluation apart on the same status.
"""

import subprocess
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu import models as jmodels
from cppnumericalsolvers_tpu.solvers import Lbfgs as JaxLbfgs
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch import models as tmodels
from cppnumericalsolvers_tpu_torch.convert import from_jax_numpy
from cppnumericalsolvers_tpu_torch.ops import flat_solve as fs

torch.set_num_threads(1)

# (model, n, low, high) for a seeded uniform batch of starts.
BATCHED = [
    ("rosenbrock", 2, -2.0, 2.0),
    ("beale", 2, -0.5, 0.5),
    ("himmelblau", 2, -4.0, 4.0),
    ("extended_rosenbrock", 6, -1.5, 1.5),
    ("trigonometric", 10, 0.0, 0.5),
    ("powell_singular", 4, -2.0, 2.0),
]


@pytest.mark.parametrize("name,n,lo,hi", BATCHED)
def test_minimize_batched_matches_jax(name, n, lo, hi):
    x0 = np.random.default_rng(7).uniform(lo, hi, (6, n))
    ref = jcns.minimize_batched(getattr(jmodels, name)(), jnp.asarray(x0),
                                JaxLbfgs())
    res = cns.minimize_batched(getattr(tmodels, name)(),
                               torch.from_numpy(x0), cns.Lbfgs(),
                               device="cpu")
    np.testing.assert_array_equal(res.progress.status.numpy(),
                                  np.asarray(ref.progress.status))
    np.testing.assert_allclose(res.state.value.numpy(),
                               np.asarray(ref.state.value), rtol=0,
                               atol=1e-8)
    assert tuple(res.internals.s_memory.shape) == (6, 10, n)


@pytest.mark.parametrize("name,x0", [
    ("quickstart_quadratic", [-3.0, 2.0]),
    ("himmelblau", [0.5, -1.5]),
    ("booth", [4.0, -4.0]),
])
def test_minimize_matches_jax(name, x0):
    ref = jcns.minimize(getattr(jmodels, name)(), jnp.asarray(x0), JaxLbfgs())
    res = cns.minimize(getattr(tmodels, name)(), torch.tensor(x0),
                       cns.Lbfgs(), device="cpu")
    assert res.state.x.shape == (2,)
    assert int(res.progress.status) == int(ref.progress.status)
    assert abs(float(res.state.value) - float(ref.state.value)) <= 1e-8
    assert int(res.state.nfev) > 1 and res.trips > 0


def test_pairwise_rosenbrock_matches_the_benchmark_objective():
    x = np.random.default_rng(8).uniform(-2, 2, 12)
    e, o = x[0::2], x[1::2]
    want = np.sum(100.0 * (o - e**2) ** 2 + (1.0 - e) ** 2)
    got = tmodels.pairwise_rosenbrock().value(torch.from_numpy(x))
    assert float(got) == pytest.approx(want, rel=1e-15)


def test_objective_arithmetic_matches_jax():
    x = np.array([0.3, -1.2, 2.0])
    jf = jcns.objective(lambda v: jnp.sum(v**2) - 3.0, mode="first")
    jg = jcns.objective(lambda v: jnp.sin(v[0]) * v[1], mode="first")
    tf = cns.objective(lambda v: torch.sum(v**2) - 3.0)
    tg = cns.objective(lambda v: torch.sin(v[0]) * v[1])
    pairs = [
        (jf + jg, tf + tg), (jf - jg, tf - tg), (2.5 - jf, 2.5 - tf),
        (jf * jg, tf * tg), (3.0 * jg, 3.0 * tg), (-jf, -tf),
        (jcns.min_zero(jf), cns.min_zero(tf)),
        (jcns.max_zero(jf), cns.max_zero(tf)),
        (jf + jcns.constant(1.5), tf + cns.constant(1.5)),
    ]
    for j, t in pairs:
        jv, jgrad = j.value_and_grad(jnp.asarray(x))
        tv, tgrad = t.value_and_grad(torch.from_numpy(x))
        assert float(tv) == pytest.approx(float(jv), rel=1e-15, abs=1e-15)
        np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad),
                                   rtol=1e-15, atol=1e-15)
        assert t.mode == j.mode
    assert tf.with_mode("none").mode == "none"
    with pytest.raises(ValueError):
        tf.with_mode("none").with_mode("first")
    state = tf.evaluate(torch.from_numpy(x), nfev=2)
    assert int(state.nfev) == 3 and state.gradient.shape == (3,)


@pytest.mark.parametrize("name", ["min_zero", "max_zero"])
def test_min_and_max_zero_split_the_gradient_at_the_kink(name):
    # f(x) = 0 at x = (0.5, 0.5): jnp.minimum/jnp.maximum give half of f's
    # gradient there, and so must the port.
    x = np.array([0.5, 0.5])
    j = getattr(jcns, name)(jcns.objective(lambda v: jnp.sum(v) - 1.0,
                                           mode="first"))
    t = getattr(cns, name)(cns.objective(lambda v: torch.sum(v) - 1.0))
    jv, jgrad = j.value_and_grad(jnp.asarray(x))
    tv, tgrad = t.value_and_grad(torch.from_numpy(x))
    assert float(tv) == float(jv) == 0.0
    np.testing.assert_array_equal(np.asarray(jgrad), [0.5, 0.5])
    np.testing.assert_array_equal(tgrad.numpy(), np.asarray(jgrad))


@pytest.mark.parametrize("args", [
    (), (10,), (10, True), (5, False, 7), (3, True, 11, "more_thuente"),
    (3, False, 11, "armijo", "xla"), (4, False, 20, "more_thuente", "auto"),
])
def test_lbfgs_positional_fields_match_jax(args):
    mine, theirs = cns.Lbfgs(*args), JaxLbfgs(*args)
    for field in ("m", "use_hessian_preconditioner", "max_linesearch_fev",
                  "line_search", "two_loop_impl"):
        assert getattr(mine, field) == getattr(theirs, field), field


def test_import_loads_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import sys, cppnumericalsolvers_tpu_torch\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'cppnumericalsolvers_tpu'"
        " or m.startswith('cppnumericalsolvers_tpu.')]\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the default device is usable")
    obj = tmodels.sphere()
    with pytest.raises(RuntimeError, match="CUDA"):
        cns.minimize_batched(obj, torch.ones(2, 3), cns.Lbfgs())
    with pytest.raises(RuntimeError, match="CUDA"):
        cns.minimize(obj, torch.ones(3), cns.Lbfgs())


def test_flat_trip_on_cpu_takes_the_plain_version():
    obj = tmodels.pairwise_rosenbrock()
    x0 = torch.from_numpy(np.random.default_rng(9).uniform(-2, 2, (5, 6)))
    stop = cns.default_stopping()
    st, x_trial = fs.init_flat_state(obj.evaluate(x0), 10, 20)
    ref, ref_trial = st.clone(), x_trial.clone()
    before = fs.flat_trip.launches
    for _ in range(6):
        f_t, g_t = obj.batched_value_and_grad(x_trial)
        fs.flat_trip(st, f_t, g_t, x_trial, stop, 20)
        fs.flat_trip_reference(ref, f_t, g_t, ref_trial, stop, 20)
        for name in ("x0", "g0", "sdir", "gacc", "s", "y", "ring", "sf",
                     "si"):
            assert torch.equal(getattr(st, name), getattr(ref, name)), name
        assert torch.equal(x_trial, ref_trial)
    assert fs.flat_trip.launches == before == 0


def test_flat_trip_checks_its_arguments():
    obj = tmodels.pairwise_rosenbrock()
    x0 = torch.zeros(3, 4, dtype=torch.float64) + 0.5
    stop = cns.default_stopping()
    st, x_trial = fs.init_flat_state(obj.evaluate(x0), 10, 20)
    f_t, g_t = obj.batched_value_and_grad(x_trial)
    with pytest.raises(ValueError, match="g_t"):
        fs.flat_trip(st, f_t, g_t.float(), x_trial, stop, 20)
    with pytest.raises(ValueError, match="x_trial"):
        fs.flat_trip(st, f_t, g_t, x_trial[:2], stop, 20)
    with pytest.raises(ValueError, match="contiguous"):
        fs.flat_trip(st, f_t, g_t.t().contiguous().t(), x_trial, stop, 20)
    with pytest.raises(TypeError):
        half = fs.FlatState(**{k: v.half() if v.is_floating_point() else v
                               for k, v in vars(st).items()})
        fs.flat_trip(half, f_t.half(), g_t.half(), x_trial.half(), stop, 20)
    meta = fs.FlatState(**{k: v.to("meta") for k, v in vars(st).items()})
    with pytest.raises(ValueError, match="device"):
        fs.flat_trip(meta, f_t.to("meta"), g_t.to("meta"),
                     x_trial.to("meta"), stop, 20)


def test_shared_memory_bound_is_checked_before_launch():
    # alpha/rho (m each), the usable flags and the reduction scratch, and
    # q (n values) where it fits (else in device memory), must fit the
    # 227 KB a Hopper block can have.
    assert fs.flat_trip_smem_bytes(10, 4096, 4) < fs._SMEM_LIMIT
    assert fs.flat_trip_smem_bytes(10, 4096, 8) < fs._SMEM_LIMIT
    assert fs.flat_trip_smem_bytes(10, 40000, 8) < fs._SMEM_LIMIT
    assert fs.flat_trip_smem_bytes(8000, 40000, 8) > fs._SMEM_LIMIT


def test_lbfgs_accepts_every_jax_search():
    # Every search of the JAX package constructs and keeps its name; only
    # More-Thuente takes the flat solve and the batch-minor loop (the flat
    # trip carries its state machine), the others the iteration-granular
    # loop (tests/test_torch_solvers_parity.py counts its launches).
    obj = tmodels.pairwise_rosenbrock()
    x0 = torch.zeros(256, 8, dtype=torch.float64)
    for search in ("more_thuente", "hager_zhang", "armijo"):
        solver = cns.Lbfgs(line_search=search)
        assert solver.line_search == JaxLbfgs(line_search=search).line_search
        flat = search == "more_thuente"
        assert solver.supports_solve_batched(obj) == flat
        assert solver.supports_fused_update(obj)
        with mock.patch.object(cns.Lbfgs, "_TRANSPOSED_N_MAX", 1 << 30):
            assert solver.supports_batched_native(obj, x0) == flat
    # The Hessian-diagonal preconditioner is ported: it constructs, and its
    # solves are held to JAX's in tests/test_torch_cond_h.py.
    precond = cns.Lbfgs(use_hessian_preconditioner=True)
    assert precond.m == 10
    assert not precond.supports_solve_batched(obj)


def test_stopping_criteria_carry_across():
    j = jcns.conservative_stopping(jnp.float32).replace(max_iterations=77)
    t = from_jax_numpy({k: np.asarray(v) for k, v in j._asdict().items()})
    assert isinstance(t, cns.StoppingCriteria)
    assert t.max_iterations == 77 and t.past == 5
    assert t.gradient_norm == float(np.float32(5e-5))
    assert t.gradient_norm_relative is True


def test_lbfgs_loops_need_only_the_batched_evaluation():
    # A wrapper that gives only ``mode``, ``evaluate`` and
    # ``batched_value_and_grad`` (as chip_smoke.py's timed objective does)
    # drives the iteration-granular loop with More-Thuente and Hager-Zhang;
    # only Armijo asks for value-only evaluations.
    obj = tmodels.pairwise_rosenbrock()

    class Wrapped:
        mode, evaluate = obj.mode, obj.evaluate
        batched_value_and_grad = obj.batched_value_and_grad

    x0 = torch.from_numpy(np.random.default_rng(2).uniform(-2, 2, (4, 6)))
    stop = cns.default_stopping().replace(max_iterations=3)
    for search in ("more_thuente", "hager_zhang"):
        res = cns.minimize_batched(Wrapped(), x0,
                                   cns.Lbfgs(line_search=search), stop,
                                   trace=1, device="cpu")
        assert int(res.progress.num_iterations.max()) == 4
    with pytest.raises(AttributeError, match="batched_value"):
        cns.minimize_batched(Wrapped(), x0, cns.Lbfgs(line_search="armijo"),
                             stop, device="cpu")


# Names of the constrained layer, L-BFGS-B and the checkers that both
# packages export, by submodule ("" is the package).
SHARED_NAMES = {
    "": ("ConstrainedProblem", "MultiplierState",
         "augmented_lagrangian_value", "lagrangian_gradient",
         "to_augmented_lagrangian", "to_penalty"),
    "core": ("ConstrainedProblem", "MultiplierState", "penalty_value",
             "quadratic_equality_penalty", "quadratic_inequality_penalty_ge",
             "quadratic_inequality_penalty_lt",
             "update_progress_constrained"),
    "solvers": ("AlResult", "AugmentedLagrangeState", "AugmentedLagrangian",
                "Lbfgsb", "projected_gradient_inf_norm"),
    "utils": ("compute_finite_gradient", "compute_finite_hessian",
              "is_gradient_correct", "is_hessian_correct"),
}


@pytest.mark.parametrize("module", sorted(SHARED_NAMES))
def test_constrained_layer_and_checkers_export_the_jax_names(module):
    import importlib

    suffix = f".{module}" if module else ""
    port = importlib.import_module(f"cppnumericalsolvers_tpu_torch{suffix}")
    ref = importlib.import_module(f"cppnumericalsolvers_tpu{suffix}")
    for name in SHARED_NAMES[module]:
        assert hasattr(ref, name), name
        assert name in port.__all__ and hasattr(port, name), name


def test_constrained_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the default device is usable")
    problem = cns.ConstrainedProblem(
        tmodels.sphere(), (cns.objective(lambda x: x[0] - 1.0),))
    al = cns.AugmentedLagrangian(inner_solver=cns.Lbfgsb())
    with pytest.raises(RuntimeError, match="CUDA"):
        al.minimize(problem, torch.ones(3, dtype=torch.float64))
    with pytest.raises(RuntimeError, match="CUDA"):
        al.minimize_batched(problem, torch.ones(2, 3, dtype=torch.float64))
    with pytest.raises(RuntimeError, match="CUDA"):
        cns.minimize(tmodels.sphere(), torch.ones(3), cns.Lbfgsb())
