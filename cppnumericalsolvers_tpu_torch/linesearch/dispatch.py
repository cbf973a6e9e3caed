"""Uniform line-search dispatch: the pluggable-search seam.

PyTorch counterpart of ``cppnumericalsolvers_tpu/linesearch/dispatch.py``.
Solvers carry a ``line_search`` name resolved through
:func:`run_line_search`, which presents a search behind one contract:
consume the populated start ``(x0, f0, g0)`` of every lane, return the
accepted step's ``(x, f, g)`` with the evaluations it took.  More-Thuente
runs the ``mt_trip`` kernel once per evaluation (ops/fused_linesearch.py);
Hager-Zhang and Armijo are plain PyTorch, as the JAX package leaves them to
XLA.  The port's
solvers are batched, so the operands carry a leading batch axis and
``batched_value_and_grad`` maps ``(B, n) -> ((B,), (B, n))``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.tree import lane_sum
from .armijo import armijo
from .hager_zhang import hager_zhang
from .more_thuente import DEFAULT_MAX_FEV

__all__ = [
    "LineSearchResult",
    "run_line_search",
    "line_search_alpha",
    "LINE_SEARCHES",
]

LINE_SEARCHES = ("more_thuente", "hager_zhang", "armijo")


@dataclasses.dataclass
class LineSearchResult:
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    alpha: torch.Tensor
    nfev: torch.Tensor  # int32 evaluations consumed, per lane
    trips: int = 0      # batched evaluations the search made


def run_line_search(
    method: str,
    batched_value_and_grad,
    x0,
    f0,
    g0,
    direction,
    alpha_init,
    max_fev: int = DEFAULT_MAX_FEV,
    dginit=None,
    *,
    active=None,
    batched_value=None,
    plain: bool = False,
) -> LineSearchResult:
    """Run the named search along ``direction`` ``(B, n)`` from a populated
    batched start.

    ``dginit`` optionally supplies the directional derivatives ``g0 .
    direction`` (More-Thuente's; the other searches compute their own).
    ``active`` (optional, ``(B,)`` bool) leaves the other lanes out of the
    Hager-Zhang and Armijo loops; More-Thuente leaves out the lanes whose
    ``dginit`` is not negative by its own rule.  ``batched_value`` maps
    ``(B, n) -> (B,)`` for Armijo's value-only trials; without it they take
    the value of ``batched_value_and_grad``.  ``plain`` runs More-Thuente's
    trips in plain PyTorch (``mt_trip_reference``), no kernel, on any
    device."""
    if method == "more_thuente":
        from ..ops.fused_linesearch import batched_more_thuente

        if dginit is None:
            dginit = lane_sum(g0 * direction)
        x, f, g, alpha, nfev, _info, trips = batched_more_thuente(
            batched_value_and_grad, x0, f0, g0, direction, alpha_init,
            dginit, max_fev=max_fev, plain=plain,
        )
        return LineSearchResult(x=x, f=f, g=g, alpha=alpha, nfev=nfev,
                                trips=trips)
    if method == "hager_zhang":
        r = hager_zhang(batched_value_and_grad, x0, f0, g0, direction,
                        alpha_init, active=active)
        return LineSearchResult(x=r.x, f=r.f, g=r.g, alpha=r.alpha,
                                nfev=r.nfev, trips=r.trips)
    if method == "armijo":
        # Value-only backtracking, then one value-and-gradient evaluation at
        # the accepted point, billed (the reference's Armijo solvers rebuild
        # the state the same way, solver.h:210-216).
        if batched_value is None:
            def batched_value(x):
                return batched_value_and_grad(x)[0]
        r = armijo(batched_value, x0, f0, g0, direction, alpha_init,
                   active=active)
        x = x0 + r.alpha[:, None] * direction
        f, g = batched_value_and_grad(x)
        return LineSearchResult(x=x, f=f, g=g, alpha=r.alpha,
                                nfev=r.nfev + 1, trips=r.trips + 1)
    raise ValueError(
        f"unknown line search {method!r}; expected one of {LINE_SEARCHES}"
    )


def line_search_alpha(
    method: str,
    batched_value_and_grad,
    x0,
    direction,
    alpha_init=1.0,
    max_fev: int = DEFAULT_MAX_FEV,
) -> LineSearchResult:
    """The reference's alpha-only overload (more_thuente.h:63-77,
    hager_zhang.h:63-77): only ``(x0, direction)`` are given, ``(n,)`` or a
    ``(B, n)`` batch; the start's value and gradient are evaluated here and
    billed in ``nfev``.  Returns the whole :class:`LineSearchResult`,
    un-batched for an ``(n,)`` start: ``.alpha`` is the bare step width of
    the C++ overload, ``(.x, .f, .g)`` the cached-output overload's
    (more_thuente.h:89-107).  ``batched_value_and_grad`` maps ``(B, n) ->
    ((B,), (B, n))``."""
    x0 = torch.as_tensor(x0)
    single = x0.dim() == 1
    if single:
        x0, direction = x0[None], torch.as_tensor(direction)[None]
    f0, g0 = batched_value_and_grad(x0)
    r = run_line_search(
        method, batched_value_and_grad, x0, f0, g0, direction, alpha_init,
        max_fev=max_fev,
    )
    r.nfev = r.nfev + 1
    r.trips += 1
    if single:
        for name in ("x", "f", "g", "alpha", "nfev"):
            setattr(r, name, getattr(r, name)[0])
    return r
