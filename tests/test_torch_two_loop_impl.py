"""``Lbfgs(two_loop_impl="xla")``, the port's plain lowering, against the
JAX package's pure-XLA lowering, in float64 on the CPU.

The parity contract (ROADMAP.md): under a 5-iteration budget status, nfev
and num_iterations are exact and iterates agree within 1e-12; on full
solves per-lane status is equal and values agree within 1e-6.  The lowering
must launch no kernel: every kernel wrapper is replaced by a shim that
fails when called, and the same shims do fire for ``"auto"``.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu import solvers as jsolvers
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.ops import fused_linesearch as fl
from cppnumericalsolvers_tpu_torch.ops import two_loop as tl
from cppnumericalsolvers_tpu_torch.solvers import lbfgs as lb

torch.set_num_threads(1)

SHORT_XTOL = 1e-12
FULL_TOL = 1e-6
SEARCHES = ("more_thuente", "hager_zhang", "armijo")


class KernelCalled(AssertionError):
    pass


def _refuse(name):
    def shim(*args, **kwargs):
        raise KernelCalled(name)
    return shim


@contextlib.contextmanager
def no_kernels(monkeypatch):
    """Every name through which a solve reaches a kernel wrapper raises."""
    for mod, name in ((lb, "flat_lbfgs_solve"), (lb, "lbfgs_prologue"),
                      (lb, "lbfgs_prologue_t"), (lb, "lbfgs_epilogue"),
                      (lb, "lbfgs_push_and_direction"),
                      (lb, "two_loop_direction"), (tl, "two_loop_direction"),
                      (tl, "lbfgs_push_and_direction"), (fl, "mt_trip")):
        monkeypatch.setattr(mod, name, _refuse(name))
    yield


def starts(b=6, n=6):
    return np.random.default_rng(11).uniform(-2.0, 2.0, (b, n))


def solve_both(x0, line_search, stopping=None):
    jobj = jcns.models.extended_rosenbrock()
    tobj = cns.models.extended_rosenbrock()
    js = None if stopping is None else jcns.default_stopping(
        jnp.float64).replace(**stopping)
    ts = None if stopping is None else cns.default_stopping(
        torch.float64).replace(**stopping)
    want = jcns.minimize_batched(
        jobj, jnp.asarray(x0),
        jsolvers.Lbfgs(m=5, line_search=line_search, two_loop_impl="xla"),
        js)
    got = cns.minimize_batched(
        tobj, torch.from_numpy(x0),
        cns.Lbfgs(m=5, line_search=line_search, two_loop_impl="xla"), ts,
        device="cpu")
    return want, got


@pytest.mark.parametrize("line_search", SEARCHES)
def test_five_iterations_are_exact(line_search, monkeypatch):
    with no_kernels(monkeypatch):
        want, got = solve_both(starts(), line_search,
                               dict(max_iterations=5))
    for field in ("status", "num_iterations"):
        np.testing.assert_array_equal(
            getattr(got.progress, field).numpy(),
            np.asarray(getattr(want.progress, field)), err_msg=field)
    np.testing.assert_array_equal(got.state.nfev.numpy(),
                                  np.asarray(want.state.nfev))
    np.testing.assert_allclose(got.state.x.numpy(), np.asarray(want.state.x),
                               rtol=0, atol=SHORT_XTOL)


@pytest.mark.parametrize("line_search", SEARCHES)
def test_full_solve_matches_jax(line_search, monkeypatch):
    with no_kernels(monkeypatch):
        want, got = solve_both(starts(), line_search)
    np.testing.assert_array_equal(got.progress.status.numpy(),
                                  np.asarray(want.progress.status))
    np.testing.assert_allclose(got.state.value.numpy(),
                               np.asarray(want.state.value), rtol=0,
                               atol=FULL_TOL)


def test_auto_reaches_the_shimmed_kernels(monkeypatch):
    """The shims do stand between "auto" and its kernels, so the tests
    above prove "xla" reaches none of them."""
    x0 = torch.from_numpy(starts())
    obj = cns.models.extended_rosenbrock()
    with no_kernels(monkeypatch):
        with pytest.raises(KernelCalled, match="flat_lbfgs_solve"):
            cns.minimize_batched(obj, x0, cns.Lbfgs(m=5), device="cpu")
        with pytest.raises(KernelCalled, match="lbfgs_prologue"):
            cns.minimize_batched(obj, x0, cns.Lbfgs(m=5), trace=2,
                                 device="cpu")


def test_xla_takes_the_generic_body_at_every_entry(monkeypatch):
    """Fresh, traced and warm-started solves, and the public More-Thuente
    search with ``plain=True``, all without a kernel."""
    x0 = torch.from_numpy(starts())
    obj = cns.models.extended_rosenbrock()
    solver = cns.Lbfgs(m=5, two_loop_impl="xla")
    with no_kernels(monkeypatch):
        fresh = cns.minimize_batched(obj, x0, solver, device="cpu")
        traced = cns.minimize_batched(obj, x0, solver, trace=3,
                                      device="cpu")
        warm = cns.minimize_batched(obj, fresh.state.x, solver,
                                    internals=fresh.internals, device="cpu")
    np.testing.assert_array_equal(traced.state.x.numpy(),
                                  fresh.state.x.numpy())
    assert bool(torch.isfinite(warm.state.value).all())
    assert not solver.supports_fused_update(obj)
    assert not solver.supports_solve_batched(obj)


def test_two_loop_impl_is_validated():
    with pytest.raises(ValueError, match="two_loop_impl"):
        cns.Lbfgs(two_loop_impl="pallas")


def _al_problem(lib, m):
    o = lib.objective
    return lib.ConstrainedProblem(
        objective=o(lambda x: m.sum((x - 1.0) ** 2), mode="first"),
        equality_constraints=(o(lambda x: m.sum(x) - 1.0, mode="first"),),
    )


def test_augmented_lagrangian_with_an_xla_inner_solver(monkeypatch):
    """``__graft_entry__.py``'s AL case: the inner solve takes the generic
    body, no prologue or epilogue, and gives the JAX package's answer."""
    x0 = np.random.default_rng(5).uniform(-1.0, 1.0, (8, 4))
    with no_kernels(monkeypatch):
        got = cns.AugmentedLagrangian(
            inner_solver=cns.Lbfgs(m=5, two_loop_impl="xla"),
        ).minimize_batched(_al_problem(cns, torch), torch.from_numpy(x0),
                           device="cpu")
    want = jsolvers.AugmentedLagrangian(
        inner_solver=jsolvers.Lbfgs(m=5, two_loop_impl="xla"),
    ).minimize_batched(_al_problem(jcns, jnp), jnp.asarray(x0))
    np.testing.assert_array_equal(got.progress.status.numpy(),
                                  np.asarray(want.progress.status))
    np.testing.assert_allclose(got.state.x.numpy(), np.asarray(want.state.x),
                               rtol=0, atol=FULL_TOL)
    np.testing.assert_allclose(got.state.x.numpy().sum(-1), 1.0, atol=1e-5)
