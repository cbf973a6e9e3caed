"""Objective functions as PyTorch callables.

PyTorch counterpart of ``cppnumericalsolvers_tpu/core/objective.py``.  An
objective is a function ``x -> scalar`` on one ``(n,)`` tensor plus its
differentiability mode; derivatives come from ``torch.func``.  The batched
evaluation of a ``(B, n)`` batch is
``torch.func.vmap(torch.func.grad_and_value(fn))``, the counterpart of
``jax.vmap(jax.value_and_grad(fn))``: one batched call for all lanes.

``fn`` must be written with operations ``torch.func.vmap`` can batch (no
data-dependent Python control flow, no ``.item()``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
from torch.func import grad, grad_and_value, hessian, jvp, vmap

__all__ = [
    "DifferentiabilityMode",
    "FunctionState",
    "LaneObjective",
    "Objective",
    "objective",
    "constant",
    "min_zero",
    "max_zero",
]

MODE_NONE = "none"
MODE_FIRST = "first"
MODE_SECOND = "second"
_MODE_ORDER = {MODE_NONE: 0, MODE_FIRST: 1, MODE_SECOND: 2}


class DifferentiabilityMode:
    """Namespace mirroring the reference's enum (function_base.h:42-46)."""

    NONE = MODE_NONE
    FIRST = MODE_FIRST
    SECOND = MODE_SECOND


def _min_mode(a: str, b: str) -> str:
    return a if _MODE_ORDER[a] <= _MODE_ORDER[b] else b


@dataclasses.dataclass
class FunctionState:
    """A trajectory point ``(x, value, gradient)`` plus an nfev counter;
    ``value`` and ``gradient`` are the objective's at ``x``.  Fields carry
    any leading batch dimensions."""

    x: torch.Tensor
    value: torch.Tensor
    gradient: torch.Tensor
    nfev: torch.Tensor  # int32 cumulative objective evaluations


@dataclasses.dataclass(frozen=True)
class Objective:
    """A smooth objective: a function ``x -> scalar`` plus its mode."""

    fn: Callable[[torch.Tensor], torch.Tensor]
    mode: str = MODE_FIRST

    def value(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)

    @functools.cached_property
    def _grad_and_value(self):
        return grad_and_value(self.fn)

    @functools.cached_property
    def _batched_value_and_grad(self):
        return vmap(self.value_and_grad)

    def value_and_grad(self, x: torch.Tensor):
        if self.mode == MODE_NONE:
            # Value-only objectives keep a zero gradient slot so states have
            # a fixed shape.
            return self.fn(x), torch.zeros_like(x)
        g, v = self._grad_and_value(x)
        return v, g

    def batched_value_and_grad(self, x: torch.Tensor):
        """``(B, n) -> ((B,), (B, n))`` in one vmapped call."""
        return self._batched_value_and_grad(x)

    @functools.cached_property
    def _batched_value(self):
        return vmap(self.fn)

    def batched_value(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, n) -> (B,)`` in one vmapped call, without the gradient: the
        value-only trials of the Armijo search and of the simplex."""
        return self._batched_value(x)

    @functools.cached_property
    def _grad(self):
        return grad(self.fn)

    @functools.cached_property
    def _batched_grad(self):
        return vmap(self._grad)

    def gradient(self, x: torch.Tensor) -> torch.Tensor:
        """The gradient at ``x`` ``(n,)``, or at every row of a ``(B, n)``
        batch in one vmapped call."""
        self._require(MODE_FIRST, "gradient")
        return self._batched_grad(x) if x.dim() == 2 else self._grad(x)

    @functools.cached_property
    def _hessian(self):
        return hessian(self.fn)

    @functools.cached_property
    def _batched_hessian(self):
        return vmap(self._hessian)

    def hessian(self, x: torch.Tensor) -> torch.Tensor:
        """The dense Hessian at ``x``: ``(n, n)`` for ``(n,)``, ``(B, n, n)``
        for a ``(B, n)`` batch (one vmapped call).  Needs a second-mode
        objective (function_base.h:42-46)."""
        self._require(MODE_SECOND, "hessian")
        return self._batched_hessian(x) if x.dim() == 2 else self._hessian(x)

    def _hvp_one(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return jvp(self._grad, (x,), (v,))[1]

    @functools.cached_property
    def _batched_hvp(self):
        return vmap(self._hvp_one)

    def hvp(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Hessian-vector product ``H(x) v`` by forward-over-reverse: the
        ``jvp`` of the gradient, two gradient-cost passes and no ``(n, n)``
        Hessian.  ``x`` and ``v`` are ``(n,)``, or ``(B, n)`` for a batch in
        one vmapped call.  Needs a first-mode objective."""
        self._require(MODE_FIRST, "hvp")
        if x.dim() == 2:
            return self._batched_hvp(x, v)
        return self._hvp_one(x, v)

    def _require(self, mode: str, what: str) -> None:
        # The reference's Hessian-request guard (function_base.h:108-115):
        # asking a lower-mode objective for a derivative is an error.
        if _MODE_ORDER[self.mode] < _MODE_ORDER[mode]:
            raise ValueError(
                f"Objective of mode '{self.mode}' cannot provide '{what}' "
                f"(requires mode '{mode}')."
            )

    def evaluate(self, x: torch.Tensor, nfev=0) -> FunctionState:
        """A populated FunctionState at ``x`` (one evaluation); ``x`` may
        be ``(n,)`` or a ``(B, n)`` batch."""
        if x.dim() == 2:
            value, grad = self.batched_value_and_grad(x)
        else:
            value, grad = self.value_and_grad(x)
        nfev = torch.as_tensor(nfev, dtype=torch.int32, device=x.device)
        return FunctionState(
            x=x, value=value, gradient=grad,
            nfev=torch.broadcast_to(nfev + 1, value.shape).clone(),
        )

    # -- composition (the reference's expression templates) ----------------

    def with_mode(self, mode: str) -> "Objective":
        """Mode downgrade; upgrades are refused (function_base.h:191-260)."""
        if _MODE_ORDER[mode] > _MODE_ORDER[self.mode]:
            raise ValueError(
                f"Cannot upgrade objective mode '{self.mode}' -> '{mode}'."
            )
        return Objective(self.fn, mode)

    def __add__(self, other):
        other = _as_objective(other, like=self)
        return Objective(
            lambda x, f=self.fn, g=other.fn: f(x) + g(x),
            _min_mode(self.mode, other.mode),
        )

    __radd__ = __add__

    def __sub__(self, other):
        other = _as_objective(other, like=self)
        return Objective(
            lambda x, f=self.fn, g=other.fn: f(x) - g(x),
            _min_mode(self.mode, other.mode),
        )

    def __rsub__(self, other):
        other = _as_objective(other, like=self)
        return Objective(
            lambda x, f=other.fn, g=self.fn: f(x) - g(x),
            _min_mode(self.mode, other.mode),
        )

    def __mul__(self, other):
        if isinstance(other, Objective):
            return Objective(
                lambda x, f=self.fn, g=other.fn: f(x) * g(x),
                _min_mode(self.mode, other.mode),
            )
        scalar = other
        return Objective(lambda x, f=self.fn: scalar * f(x), self.mode)

    __rmul__ = __mul__

    def __neg__(self):
        return Objective(lambda x, f=self.fn: -f(x), self.mode)


@dataclasses.dataclass(frozen=True, eq=False)
class LaneObjective(Objective):
    """An objective with operands of its own in every lane: ``fn(x,
    *operands)``, where each operand has a leading batch axis.  Its batched
    calls vmap the operands together with ``x``, so lane b's value depends
    on ``operands[k][b]`` only: the augmented-Lagrangian composite of a
    batch, whose multipliers and penalty differ by lane.  The un-batched
    calls pass the operands as they are (one instance's).  It does not
    compose (``+``, ``*``, ...)."""

    operands: tuple = ()

    def value(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x, *self.operands)

    def _vg(self, x, *operands):
        if self.mode == MODE_NONE:
            return self.fn(x, *operands), torch.zeros_like(x)
        g, v = grad_and_value(self.fn)(x, *operands)
        return v, g

    def value_and_grad(self, x: torch.Tensor):
        return self._vg(x, *self.operands)

    def batched_value_and_grad(self, x: torch.Tensor):
        return vmap(self._vg)(x, *self.operands)

    def batched_value(self, x: torch.Tensor) -> torch.Tensor:
        return vmap(self.fn)(x, *self.operands)

    def gradient(self, x: torch.Tensor) -> torch.Tensor:
        self._require(MODE_FIRST, "gradient")
        g = grad(self.fn)
        return (vmap(g)(x, *self.operands) if x.dim() == 2
                else g(x, *self.operands))

    def hessian(self, x: torch.Tensor) -> torch.Tensor:
        self._require(MODE_SECOND, "hessian")
        h = hessian(self.fn)
        return (vmap(h)(x, *self.operands) if x.dim() == 2
                else h(x, *self.operands))

    def hvp(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        self._require(MODE_FIRST, "hvp")
        g = grad(self.fn)

        def one(x, v, *operands):
            return jvp(lambda z: g(z, *operands), (x,), (v,))[1]

        return (vmap(one)(x, v, *self.operands) if x.dim() == 2
                else one(x, v, *self.operands))

    def with_mode(self, mode: str) -> "LaneObjective":
        if _MODE_ORDER[mode] > _MODE_ORDER[self.mode]:
            raise ValueError(
                f"Cannot upgrade objective mode '{self.mode}' -> '{mode}'."
            )
        return LaneObjective(self.fn, mode, self.operands)


def _as_objective(value, like: Objective) -> Objective:
    if isinstance(value, Objective):
        return value
    return constant(value, mode=like.mode)


def objective(fn: Callable, mode: str = MODE_FIRST) -> Objective:
    """Wrap a function ``x -> scalar`` as an :class:`Objective`."""
    return Objective(fn, mode)


def constant(value, mode: str = MODE_SECOND) -> Objective:
    """Constant objective (ConstExpression, function_expressions.h:45-72)."""
    return Objective(
        lambda x: torch.full((), value, dtype=x.dtype, device=x.device), mode
    )


def min_zero(f: Objective) -> Objective:
    """``min(0, f(x))`` (MinZeroExpression, function_expressions.h:317-357).
    At the kink ``f(x) = 0`` the gradient is half of ``f``'s, as
    ``jnp.minimum`` gives it in the JAX package."""
    return Objective(
        lambda x, fn=f.fn: _against_zero(torch.minimum, fn(x)), f.mode
    )


def max_zero(f: Objective) -> Objective:
    """``max(0, f(x))`` (MaxZeroExpression, function_expressions.h:359-399);
    half of ``f``'s gradient at the kink, as :func:`min_zero`."""
    return Objective(
        lambda x, fn=f.fn: _against_zero(torch.maximum, fn(x)), f.mode
    )


def _against_zero(op, value):
    """``op(0, value)`` with a zero of the value's dtype and device; unlike
    ``torch.clamp``, ``torch.minimum`` and ``torch.maximum`` split the
    gradient of a tie between their two arguments."""
    return op(torch.zeros_like(value), value)
