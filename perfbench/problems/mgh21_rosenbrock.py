"""MGH problem 21 (extended Rosenbrock) as the benchmark runs it.

``objective()`` is the solver's own objective for the problem (the port's
``models.pairwise_rosenbrock``); the rest is the benchmark's: the least work
of one batched evaluation and the plain reference.
"""

from __future__ import annotations

from perfbench.reference.mgh21_rosenbrock import F_STAR, X_STAR
from perfbench.reference.mgh21_rosenbrock import value_and_grad as reference

__all__ = ["F_STAR", "X_STAR", "eval_bytes", "eval_ops", "objective",
           "reference"]


def objective():
    from cppnumericalsolvers_tpu_torch import models

    return models.pairwise_rosenbrock()


def eval_bytes(batch: int, n: int, itemsize: int) -> int:
    """Least bytes of one batched value-and-gradient: x read once, the
    gradient and the value written once."""
    return (2 * batch * n + batch) * itemsize


def eval_ops(batch: int, n: int) -> int:
    """Least arithmetic of one batched value-and-gradient: per pair
    ``odd^2``, ``r = even - odd^2``, ``t = 1 - odd``, ``100 r^2 + t^2`` and
    its add to the sum (7), ``200 r`` (1), ``-400 odd r - 2 t`` (5)."""
    return 13 * batch * (n // 2)
