"""Shared helpers of the examples' tests (tests/test_torch_examples_*.py).

Each test runs the JAX package's example as it is, in a process of its own
(``EXAMPLES_PLATFORM=cpu python examples/<name>.py``, one CPU device, so
its ``jax.config`` updates never reach the test process), parses the
figures it prints, and holds the port's counterpart in ``examples_torch/``
(``main("cpu")``) to them: statuses, iterations and nfev exactly where the
example prints them in float64, and every printed float to its printed
precision (:func:`printed_close`).

``python tests/torch_examples.py NAME OUTER:INNER...`` runs
``examples/NAME.py`` with its ``AugmentedLagrangian.minimize`` calls cut to
budgets (:func:`start_jax_example`'s ``al_budgets``); nothing else of the
example changes.
"""

from __future__ import annotations

import json
import math
import os
import re
import runpy
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NUMBER = r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"

#: The parity contract's iterate tolerance in float64: where a printed
#: value sits at roundoff (an argmin of 1e-19), the port and JAX agree to
#: this, not to the digits printed.
X_ATOL = 1e-12


def _jax_env() -> dict:
    """The environment of a JAX process of the examples' tests: one CPU
    device, float64 available, the repository root importable."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(EXAMPLES_PLATFORM="cpu", JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="1", PYTHONPATH=ROOT)
    return env


def start_script(path: str, *args: str, timeout: float = 600):
    """Start ``python PATH ARGS...`` in a JAX process of its own (see
    :func:`start_jax_example`); :func:`finish` waits for it."""
    proc = subprocess.Popen(
        [sys.executable, path, *args], cwd=ROOT, env=_jax_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    proc.deadline = timeout
    return proc


def start_jax_example(name: str, timeout: float = 600,
                      al_budgets: dict | None = None):
    """Start ``examples/<name>.py`` on one CPU device; :func:`finish` waits
    for its output.  ``al_budgets`` maps the class name of an
    ``AugmentedLagrangian``'s inner solver to ``(outer, inner)``: each of
    the example's ``minimize`` calls on such an AL then stops after
    ``outer`` outer iterations (``inner`` inner ones each, 0: the inner
    solver's default stop), as the port's counterpart does."""
    if al_budgets is None:
        return start_script(os.path.join(ROOT, "examples", f"{name}.py"),
                            timeout=timeout)
    return start_script(os.path.abspath(__file__), name,
                        json.dumps(al_budgets), timeout=timeout)


def run_budgeted(name: str, al_budgets: dict) -> None:
    """Run ``examples/<name>.py`` as ``__main__`` with its AL solves cut to
    ``al_budgets`` (see :func:`start_jax_example`)."""
    import cppnumericalsolvers_tpu as jcns
    from cppnumericalsolvers_tpu.solvers import AugmentedLagrangian

    minimize = AugmentedLagrangian.minimize

    def budgeted(self, problem, x0, *args, **kwargs):
        outer, inner = al_budgets[type(self.inner_solver).__name__]
        kwargs["stopping"] = jcns.default_stopping(x0.dtype).replace(
            max_iterations=outer)
        if inner:
            kwargs["inner_stopping"] = self.inner_solver.default_stopping(
                x0.dtype).replace(max_iterations=inner)
        return minimize(self, problem, x0, *args, **kwargs)

    AugmentedLagrangian.minimize = budgeted
    runpy.run_path(os.path.join(ROOT, "examples", f"{name}.py"),
                   run_name="__main__")


def finish(proc) -> str:
    """The started process's standard output; raises if it failed."""
    try:
        out, err = proc.communicate(timeout=proc.deadline)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode:
        raise RuntimeError(f"JAX process exited {proc.returncode}:\n"
                           + err[-4000:])
    return out


def numbers(line: str) -> list[str]:
    """The numbers printed on ``line``, as printed."""
    return re.findall(NUMBER, line)


def line_with(text: str, prefix: str) -> str:
    """The first line of ``text`` that starts with ``prefix`` (after
    leading blanks)."""
    return next(ln for ln in text.splitlines()
                if ln.lstrip().startswith(prefix))


def printed_unit(printed: str) -> float:
    """One unit in the last printed place of ``printed``."""
    mant, _, exp = printed.lower().partition("e")
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    return 10.0 ** (int(exp or 0) - decimals)


def printed_close(value: float, printed: str, atol: float = 0.0) -> bool:
    """Whether ``value`` agrees with ``printed`` to its printed precision:
    within one unit in its last place (a value near a rounding boundary
    may print either way), or within ``atol``."""
    want = float(printed)
    if math.isnan(want):
        return math.isnan(value)
    return abs(value - want) <= max(printed_unit(printed), atol)


if __name__ == "__main__":
    run_budgeted(sys.argv[1], json.loads(sys.argv[2]))
