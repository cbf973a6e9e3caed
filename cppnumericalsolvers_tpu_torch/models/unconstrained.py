"""Standard unconstrained test objectives.

PyTorch counterpart of ``cppnumericalsolvers_tpu/models/unconstrained.py``,
plus the pairwise extended Rosenbrock of the throughput grid
(``benchmarks/roofline.py:108``).  All are functions ``x -> scalar`` on one
``(n,)`` tensor, batched by ``torch.func.vmap``, but for the pairwise
extended Rosenbrock's batched value and gradient, which its function
carries in closed form (:func:`pairwise_rosenbrock`).
"""

from __future__ import annotations

import functools

import torch

from ..core.objective import Objective
from ..core.tree import fixed_sum
from ..ops.objectives import pairwise_rosenbrock_value_and_grad

__all__ = [
    "quickstart_quadratic",
    "rosenbrock",
    "sphere",
    "beale",
    "booth",
    "matyas",
    "himmelblau",
    "trigonometric",
    "powell_singular",
    "powell_badly_scaled",
    "extended_rosenbrock",
    "pairwise_rosenbrock",
]


@functools.lru_cache(maxsize=None)
def quickstart_quadratic() -> Objective:
    """f(x) = 5 x0^2 + 100 x1^2 + 5 (minimum f*=5 at (0,0))."""
    return Objective(
        lambda x: 5.0 * x[0] ** 2 + 100.0 * x[1] ** 2 + 5.0, mode="second"
    )


@functools.lru_cache(maxsize=None)
def rosenbrock(a: float = 1.0, b: float = 100.0) -> Objective:
    """2-D Rosenbrock."""
    return Objective(
        lambda x: (a - x[0]) ** 2 + b * (x[1] - x[0] ** 2) ** 2, mode="second"
    )


@functools.lru_cache(maxsize=None)
def extended_rosenbrock(n: int | None = None) -> Objective:
    """N-dimensional chained Rosenbrock; works for any input length."""
    del n  # dimension comes from the input shape

    def fn(x):
        return torch.sum(
            100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2
        )

    return Objective(fn, mode="second")


class _PairwiseRosenbrock:
    """MGH problem 21, the extended Rosenbrock over disjoint (even, odd)
    pairs, as a function ``x -> scalar`` on one ``(n,)`` tensor (n even),
    carrying its closed-form batched value and gradient.  A call is the
    function as ``torch.func`` differentiates it; its sum is
    ``core.tree.fixed_sum``, so a lane's value has the same bits in a batch
    of any size on the card (``torch.sum`` of a batch of long rows adds in
    an order that depends on the number of rows).
    ``batched_value_and_grad`` is ``ops.objectives``'s closed form, for
    the dtypes in ``dtypes``: the plain version on the CPU (the vmap path's
    bits), one kernel launch on the card (the gradient's bits, the value to
    a few ulps of its sum)."""

    dtypes = (torch.float32, torch.float64)

    def __call__(self, x):
        even, odd = x[0::2], x[1::2]
        return fixed_sum(100.0 * (odd - even**2) ** 2 + (1.0 - even) ** 2)

    batched_value_and_grad = staticmethod(pairwise_rosenbrock_value_and_grad)


@functools.lru_cache(maxsize=None)
def pairwise_rosenbrock() -> Objective:
    """The throughput grid's objective (benchmarks/roofline.py:108) and the
    benchmark's: MGH problem 21 (``_PairwiseRosenbrock``), second mode.
    Its batched evaluation (``Objective.batched_value_and_grad``) is the
    function's closed form, not ``vmap(grad_and_value)``; every other
    derivative takes the ``torch.func`` path."""
    return Objective(_PairwiseRosenbrock(), mode="second")


@functools.lru_cache(maxsize=None)
def sphere() -> Objective:
    return Objective(lambda x: torch.sum(x * x), mode="second")


@functools.lru_cache(maxsize=None)
def beale() -> Objective:
    def fn(x):
        a, b = x[0], x[1]
        return (
            (1.5 - a + a * b) ** 2
            + (2.25 - a + a * b**2) ** 2
            + (2.625 - a + a * b**3) ** 2
        )

    return Objective(fn, mode="second")


@functools.lru_cache(maxsize=None)
def booth() -> Objective:
    return Objective(
        lambda x: (x[0] + 2 * x[1] - 7) ** 2 + (2 * x[0] + x[1] - 5) ** 2,
        mode="second",
    )


@functools.lru_cache(maxsize=None)
def matyas() -> Objective:
    return Objective(
        lambda x: 0.26 * (x[0] ** 2 + x[1] ** 2) - 0.48 * x[0] * x[1],
        mode="second",
    )


@functools.lru_cache(maxsize=None)
def himmelblau() -> Objective:
    return Objective(
        lambda x: (x[0] ** 2 + x[1] - 11) ** 2 + (x[0] + x[1] ** 2 - 7) ** 2,
        mode="second",
    )


@functools.lru_cache(maxsize=None)
def trigonometric() -> Objective:
    """MGH trigonometric function (the reference's 10-D perf benchmark)."""

    def fn(x):
        n = x.shape[0]
        cos_sum = torch.sum(torch.cos(x))
        i = torch.arange(1, n + 1, dtype=x.dtype, device=x.device)
        terms = n - cos_sum + i * (1.0 - torch.cos(x)) - torch.sin(x)
        return torch.sum(terms**2)

    return Objective(fn, mode="second")


@functools.lru_cache(maxsize=None)
def powell_singular() -> Objective:
    """MGH-13: quartic valley with a singular Hessian at the minimum."""

    def fn(x):
        return (
            (x[0] + 10 * x[1]) ** 2
            + 5 * (x[2] - x[3]) ** 2
            + (x[1] - 2 * x[2]) ** 4
            + 10 * (x[0] - x[3]) ** 4
        )

    return Objective(fn, mode="second")


@functools.lru_cache(maxsize=None)
def powell_badly_scaled() -> Objective:
    """MGH-03: badly scaled 2-D problem."""

    def fn(x):
        return (1e4 * x[0] * x[1] - 1.0) ** 2 + (
            torch.exp(-x[0]) + torch.exp(-x[1]) - 1.0001
        ) ** 2

    return Objective(fn, mode="second")
