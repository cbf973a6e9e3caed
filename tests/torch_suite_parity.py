"""Helpers of tests/test_torch_suite_solve.py and
tests/test_torch_suite_sweeps.py: one MGH benchmark problem's starts solved
by both packages' ``minimize_batched`` under the reliability solver and
stopping (``Lbfgs(m=10)``, ``conservative_stopping(float64)`` with two
x-delta strikes: bench.py:50-66), float64 on the CPU; the JAX package takes
its nested loop here, the port its flat solve.

* Short budgets (every problem, every lane): at ``SHORT_BUDGET``
  iterations status, nfev and iterations equal, iterates within rtol
  1e-12 / atol 1e-12 (the contract of tests/test_flat_solve.py:44-86), and
  so at one iteration, before any history pair is used.  ``AMPLIFYING``
  lists the starts whose iterates leave 1e-12 by 5 iterations while their
  status, nfev and iterations stay equal: their line searches amplify the
  last bits of a sum, which two correct implementations summing in other
  orders do not share.  Their iterates are held at one iteration only.
* Full solves (a stated subset): on every lane the success contract
  (``models.suite.success_mask``, bench.py:76-83) and whether the status is
  a convergence status agree; values within 1e-6 of JAX's (relative above
  1).  Which convergence rung stops a lane, and the nfev it took, is not
  held: on 12 of the 58 problems (Meyer, Jennrich-Sampson, Watson 9 and 12,
  ...) the two packages stop some lanes on different rungs, and the port
  against itself with the objective changed in its last bit does the same
  (Jennrich-Sampson's mean nfev moves by 21 under that change).
"""

import jax.numpy as jnp
import numpy as np
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu.models import suite as jsuite
from cppnumericalsolvers_tpu.solvers import Lbfgs as JaxLbfgs
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.models import suite as tsuite

SHORT_BUDGET = 5
#: Problem -> starts (instance indices) whose iterates at SHORT_BUDGET
#: iterations are more than 1e-12 from JAX's, with the largest distance in
#: units of the tolerance (1e-12 (1 + |x|)), against JAX and against the
#: port itself with the objective scaled by (1 + 2^-52) (float64, CPU):
#: helical valley's 100x start 2.7e8 and 2.4e10 (its status and nfev move
#: under that change too), Powell badly scaled 119 and 102, Meyer 60 and 19
#: (start 5), 2.8 and 0.5 (2), 1.04 and 0.24 (4), Bard 13 and 15,
#: Jennrich-Sampson 3.7 and 0.6, Brown almost linear at n = 20 1.02 and 0
#: (5.8 against JAX at 8 iterations, 26 at 10).
AMPLIFYING = {"helical_valley": [2], "powell_badly_scaled": [2],
              "meyer": [2, 4, 5], "bard": [1], "jennrich_sampson": [2],
              "brown_almost_linear20": [0]}
JSTOP = jcns.conservative_stopping(jnp.float64).replace(x_delta_violations=2)
TSTOP = cns.conservative_stopping(torch.float64).replace(x_delta_violations=2)
NAMES = [p.name for p, _ in jsuite.mgh_benchmark_instances()]
#: Problems 0-18 have a fixed dimension; 19-57 are dimension sweeps.
FIXED = NAMES[:19]
SWEEPS = NAMES[19:]


def solve_both(name, max_iterations=0):
    """``(JAX result, port result, JAX problem)`` of problem ``name``'s
    starts, cut at ``max_iterations`` where it is positive."""
    index = NAMES.index(name)
    jp, jx = jsuite.mgh_benchmark_instances()[index]
    tp, tx = tsuite.mgh_benchmark_instances()[index]
    jstop, tstop = JSTOP, TSTOP
    if max_iterations:
        jstop = jstop.replace(max_iterations=max_iterations)
        tstop = tstop.replace(max_iterations=max_iterations)
    jres = jcns.minimize_batched(jp.objective, jnp.asarray(jx),
                                 JaxLbfgs(m=10), jstop)
    tres = cns.minimize_batched(tp.objective, torch.from_numpy(tx),
                                cns.Lbfgs(m=10), tstop, device="cpu")
    return jres, tres, jp


def fields(res):
    """numpy copies of the fields the checks read, from either package."""
    out = {}
    for key, val in (("x", res.state.x), ("value", res.state.value),
                     ("gradient", res.state.gradient),
                     ("nfev", res.state.nfev),
                     ("status", res.progress.status),
                     ("iterations", res.progress.num_iterations)):
        out[key] = (val.numpy() if isinstance(val, torch.Tensor)
                    else np.asarray(val))
    return out


def check_short_budget(name):
    for budget in (1, SHORT_BUDGET):
        jres, tres, _ = solve_both(name, budget)
        j, t = fields(jres), fields(tres)
        for key in ("status", "nfev", "iterations"):
            np.testing.assert_array_equal(t[key], j[key],
                                          err_msg=f"{key} at {budget}")
        held = np.ones(len(t["x"]), bool)
        if budget > 1:
            held[AMPLIFYING.get(name, [])] = False
        np.testing.assert_allclose(t["x"][held], j["x"][held], rtol=1e-12,
                                   atol=1e-12, err_msg=f"x at {budget}")


def success(problem, f):
    return tsuite.success_mask(problem, f["value"],
                               np.abs(f["gradient"]).max(-1),
                               np.abs(f["x"]).max(-1))


def check_full_solve(name):
    jres, tres, problem = solve_both(name)
    j, t = fields(jres), fields(tres)
    np.testing.assert_array_equal(success(problem, t), success(problem, j))
    conv = list(cns.CONVERGED_STATUSES)
    np.testing.assert_array_equal(np.isin(t["status"], conv),
                                  np.isin(j["status"], conv))
    np.testing.assert_allclose(t["value"], j["value"], rtol=1e-6, atol=1e-6)


def spreads(name, budget=SHORT_BUDGET):
    """Per start of problem ``name`` at ``budget`` iterations: whether
    status, nfev and iterations equal JAX's, and the iterate's largest
    distance in units of 1e-12 (1 + |x|), against JAX and against the port
    with the objective scaled by (1 + 2^-52)."""
    jres, tres, _ = solve_both(name, budget)
    index = NAMES.index(name)
    tp, tx = tsuite.mgh_benchmark_instances()[index]
    pres = cns.minimize_batched(
        tp.objective * (1 + 2.0 ** -52), torch.from_numpy(tx),
        cns.Lbfgs(m=10), TSTOP.replace(max_iterations=budget), device="cpu")
    j, t, p = fields(jres), fields(tres), fields(pres)

    def units(a, b):
        return (np.abs(a - b) / (1e-12 * (1 + np.abs(b)))).max(-1)

    ints = np.all([t[k] == j[k] for k in ("status", "nfev", "iterations")],
                  axis=0)
    return ints, units(t["x"], j["x"]), units(t["x"], p["x"])


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=. python
    # tests/torch_suite_parity.py: the starts past the short budget's
    # tolerance, which AMPLIFYING must list.
    torch.set_num_threads(1)
    for name in NAMES:
        ints, jax_units, self_units = spreads(name)
        for i in np.flatnonzero(~ints | (jax_units > 1)):
            print(f"{name} start {i}: ints equal {bool(ints[i])}, "
                  f"{jax_units[i]:.3g} against JAX, {self_units[i]:.3g} "
                  "against itself with f scaled by (1 + 2^-52)", flush=True)
