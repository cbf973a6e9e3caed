"""The solver matrix of tests/test_solver_matrix.py through the port.

Every unconstrained solver solves the 2-D Rosenbrock from the "Far" start
(15, 8) and the "Near" start (-1, 2) (the reference's src/test/verify.cc:
117-191) in float64 on the CPU: it must reach f within 1e-4 of 0, and end
as the JAX package's solve does, with the same status, nfev within 3 and
the value within 1e-6 (the full-solve contract).  Gradient descent and
Nelder-Mead take the conservative preset, as in SOLVER_SETUP_CONSERVATIVE
(verify.cc:185-192), Nelder-Mead with 5 x-delta strikes.  Then the
Hessian-free trust region, and the differentiability-mode cases (:91-115),
whose errors carry the JAX package's messages.

Outside the contract (statuses equal and f within 1e-4 of 0 all the same),
measured here: port against JAX nfev 171/167 for BFGS from Far; 3,295/3,674
for conjugate gradient from Far, f 4.6e-5/1.3e-5; 10,176/3,350 and
8,667/5,814 for gradient descent from Far and Near, f within 4.6e-9.  These
solves creep along the Rosenbrock valley for hundreds to thousands of
steps, which amplify the last-bit differences between XLA's sums (fused
multiply-adds) and PyTorch's; BFGS from Far parts in its last iterations.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu import models as jmodels
from cppnumericalsolvers_tpu import solvers as jsolvers
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.core.tree import tree_map

torch.set_num_threads(1)

PRECISION = 1e-4
FAR = (15.0, 8.0)
NEAR = (-1.0, 2.0)
SOLVERS = ["Bfgs", "ConjugateGradientDescent", "GradientDescent", "Lbfgs",
           "NelderMead", "NewtonDescent", "TrustRegionNewton"]


def stopping_for(name, pkg, dtype):
    if name in ("GradientDescent", "NelderMead"):
        crit = pkg.conservative_stopping(dtype)
        if name == "NelderMead":
            crit = crit.replace(x_delta_violations=5)
        return crit
    return None


@functools.lru_cache(maxsize=None)
def port_both_starts(solver_name, hessian_free=False):
    """Far and Near as the two lanes of one batched port solve (lanes are
    independent: each is the single solve from its start)."""
    kw = {"hessian_free": True} if hessian_free else {}
    return cns.minimize_batched(
        cns.models.rosenbrock(),
        torch.tensor([FAR, NEAR], dtype=torch.float64),
        getattr(cns, solver_name)(**kw),
        stopping_for(solver_name, cns, torch.float64), device="cpu")


def solve_both(solver_name, start, hessian_free=False):
    kw = {"hessian_free": True} if hessian_free else {}
    want = jcns.minimize(
        jmodels.rosenbrock(), jnp.asarray(start),
        getattr(jsolvers, solver_name)(**kw),
        stopping_for(solver_name, jcns, jnp.float64))
    lane = [FAR, NEAR].index(start)
    res = port_both_starts(solver_name, hessian_free)
    got = cns.MinimizeResult(
        state=tree_map(lambda t: t[lane], res.state),
        progress=tree_map(lambda t: t[lane], res.progress),
        internals=None)
    return want, got


OUTSIDE_CONTRACT = {("Bfgs", "Far"), ("ConjugateGradientDescent", "Far"),
                    ("GradientDescent", "Far"), ("GradientDescent", "Near")}


def check(want, got, label, contract=True):
    f_final = float(got.state.value)
    assert f_final == pytest.approx(0.0, abs=PRECISION), (
        f"{label}: f={f_final}, status={int(got.progress.status)}, "
        f"iters={int(got.progress.num_iterations)}")
    assert int(got.progress.status) == int(want.progress.status), label
    if contract:
        assert abs(int(got.state.nfev) - int(want.state.nfev)) <= 3, label
        assert f_final == pytest.approx(float(want.state.value), abs=1e-6)


@pytest.mark.parametrize("start_name,start", [("Far", FAR), ("Near", NEAR)])
@pytest.mark.parametrize("solver_name", SOLVERS)
def test_rosenbrock_matrix(solver_name, start_name, start):
    want, got = solve_both(solver_name, start)
    check(want, got, f"{solver_name} {start_name}",
          (solver_name, start_name) not in OUTSIDE_CONTRACT)


def test_trust_region_hessian_free():
    want, got = solve_both("TrustRegionNewton", FAR, hessian_free=True)
    check(want, got, "TrustRegionNewton(hessian_free=True) Far")


class TestModeVariants:
    """The differentiability-mode cases (verify.cc:36-100;
    function_base.h:42-46, :191-260)."""

    def test_first_mode_downgrade_solves(self):
        obj = cns.models.rosenbrock().with_mode("first")
        res = cns.minimize(obj, torch.tensor(NEAR, dtype=torch.float64),
                           cns.Lbfgs(), device="cpu")
        assert float(res.state.value) == pytest.approx(0.0, abs=PRECISION)

    def test_value_only_mode_solves_with_nelder_mead(self):
        crit = cns.conservative_stopping(torch.float64).replace(
            x_delta_violations=5)
        want = jcns.minimize(
            jmodels.rosenbrock().with_mode("none"), jnp.asarray(NEAR),
            jsolvers.NelderMead(),
            jcns.conservative_stopping(jnp.float64).replace(
                x_delta_violations=5))
        got = cns.minimize(
            cns.models.rosenbrock().with_mode("none"),
            torch.tensor(NEAR, dtype=torch.float64), cns.NelderMead(), crit,
            device="cpu")
        check(want, got, "NelderMead value-only")
        # A value-only state keeps a zero gradient.
        assert not bool(got.state.gradient.any())

    def test_mode_upgrade_refused(self):
        obj = cns.models.rosenbrock().with_mode("first")
        with pytest.raises(ValueError, match="upgrade"):
            obj.with_mode("second")

    def test_gradient_solver_rejects_value_only_objective(self):
        obj = cns.models.rosenbrock().with_mode("none")
        x = torch.tensor(NEAR, dtype=torch.float64)
        for solver in (cns.Lbfgs(), cns.GradientDescent(), cns.Bfgs(),
                       cns.ConjugateGradientDescent()):
            with pytest.raises(ValueError, match="requires"):
                cns.minimize(obj, x, solver, device="cpu")
        with pytest.raises(ValueError, match="requires a second-mode"):
            cns.minimize(obj.with_mode("none"), x, cns.TrustRegionNewton(),
                         device="cpu")
        with pytest.raises(ValueError, match="requires a first-mode"):
            cns.minimize(obj, x, cns.TrustRegionNewton(hessian_free=True),
                         device="cpu")

    @pytest.mark.parametrize("what", ["hessian", "gradient", "hvp"])
    def test_derivative_request_beyond_the_mode_raises(self, what):
        # function_base.h:108-115's guard, with the JAX package's message.
        mode = "first" if what == "hessian" else "none"
        jobj = jmodels.rosenbrock().with_mode(mode)
        tobj = cns.models.rosenbrock().with_mode(mode)
        x = np.array(NEAR)
        args = (x, x) if what == "hvp" else (x,)
        with pytest.raises(ValueError) as want:
            getattr(jobj, what)(*(jnp.asarray(a) for a in args))
        with pytest.raises(ValueError, match="cannot provide") as got:
            getattr(tobj, what)(*(torch.from_numpy(a) for a in args))
        assert str(got.value) == str(want.value)
