"""Uniform line-search dispatch: the pluggable-search seam.

PyTorch counterpart of ``cppnumericalsolvers_tpu/linesearch/dispatch.py``.
Solvers carry a ``line_search`` name resolved through
:func:`run_line_search`, which presents a search behind one contract:
consume the populated start ``(x0, f0, g0)`` of every lane, return the
accepted step's ``(x, f, g)`` with the evaluations it took.  The port's
solvers are batched, so the operands carry a leading batch axis and
``batched_value_and_grad`` maps ``(B, n) -> ((B,), (B, n))``.
"""

from __future__ import annotations

import dataclasses

import torch

from .more_thuente import DEFAULT_MAX_FEV

__all__ = ["LineSearchResult", "run_line_search", "LINE_SEARCHES"]

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
) -> LineSearchResult:
    """Run the named search along ``direction`` ``(B, n)`` from a populated
    batched start.  ``dginit`` optionally supplies the directional
    derivatives ``g0 . direction``."""
    if method == "more_thuente":
        from ..ops.fused_linesearch import batched_more_thuente

        if dginit is None:
            dginit = torch.sum(g0 * direction, dim=-1)
        x, f, g, alpha, nfev, _info, trips = batched_more_thuente(
            batched_value_and_grad, x0, f0, g0, direction, alpha_init,
            dginit, max_fev=max_fev,
        )
        return LineSearchResult(x=x, f=f, g=g, alpha=alpha, nfev=nfev,
                                trips=trips)
    if method in LINE_SEARCHES:
        raise NotImplementedError(
            f"line_search={method!r} is not ported yet (ROADMAP.md queue A, "
            "the line searches: linesearch/armijo.py, "
            "linesearch/hager_zhang.py)."
        )
    raise ValueError(
        f"unknown line search {method!r}; expected one of {LINE_SEARCHES}"
    )
