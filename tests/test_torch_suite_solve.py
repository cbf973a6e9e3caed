"""The port's solves of the MGH benchmark's 19 fixed-dimension problems
against the JAX package's (tests/torch_suite_parity.py states the
contract), and the port's counterparts of tests/test_suite.py's solve
tests.  The 39 dimension sweeps are in tests/test_torch_suite_sweeps.py, so
that the two halves run on two workers.
"""

import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.models.suite import mgh_suite

from torch_suite_parity import FIXED, check_full_solve, check_short_budget

torch.set_num_threads(1)


@pytest.mark.parametrize("name", FIXED)
def test_short_budget_matches_jax(name):
    check_short_budget(name)


# The plateau pathologies the reference documents (Meyer, Powell badly
# scaled; progress.h:388-392, :420-427), the atan2 branch of the helical
# valley, and a problem whose lanes stop on other rungs in the two packages
# (Jennrich-Sampson).
@pytest.mark.parametrize("name", ["meyer", "powell_badly_scaled",
                                  "helical_valley", "jennrich_sampson",
                                  "rosenbrock"])
def test_full_solve_matches_jax(name):
    check_full_solve(name)


def _is_converged(problem, result) -> bool:
    f = float(result.state.value)
    g = float(result.state.gradient.abs().max())
    x = float(result.state.x.abs().max())
    if not np.isfinite(f):
        return False
    grad_ok = g < 1e-5 * max(1.0, x)
    f_ok = problem.f_star is not None and f <= problem.f_star + 1e-4 * max(
        1.0, abs(problem.f_star))
    return grad_ok or f_ok


def test_mgh_suite_reliability_lbfgs():
    # tests/test_suite.py's: the 35 MGH problems from their standard starts
    # under the Conservative preset; at most one may fail.
    stopping = cns.conservative_stopping(torch.float64)
    failed = [
        problem.name for problem in mgh_suite("float64")
        if not _is_converged(problem, cns.minimize(
            problem.objective, torch.from_numpy(problem.x0), cns.Lbfgs(),
            stopping, device="cpu"))
    ]
    assert len(failed) <= 1, f"MGH failures: {failed}"


@pytest.mark.parametrize("name", ["rosenbrock", "meyer",
                                  "powell_badly_scaled"])
def test_mgh_hard_problems_reach_f_star(name):
    # tests/test_suite.py's: the documented plateau pathologies reach f*
    # under the Conservative preset.
    problem = next(p for p in mgh_suite("float64") if p.name == name)
    result = cns.minimize(problem.objective, torch.from_numpy(problem.x0),
                          cns.Lbfgs(), cns.conservative_stopping(torch.float64),
                          device="cpu")
    assert float(result.state.value) <= problem.f_star + 1e-4 * max(
        1.0, abs(problem.f_star))
