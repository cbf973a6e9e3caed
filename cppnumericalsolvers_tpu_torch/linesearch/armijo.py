"""Armijo backtracking line search, batched.

PyTorch counterpart of ``cppnumericalsolvers_tpu/linesearch/armijo.py``
(the reference's backtracking rule, include/cppoptlib/linesearch/armijo.h:
31-103): c = 0.2, rho = 0.9, alpha_min = 1e-8.  The second-order variant
adds a curvature term ``0.5 c^2 d^T H d`` to the sufficient-decrease
threshold (armijo.h:67-103) and has no alpha floor, as the C++
specialisation.

The JAX package runs one ``lax.while_loop`` per instance and vmaps it; here
the loop is at batch level: every pass is one batched value-only evaluation
of the whole batch and one device-to-host read (any lane still
backtracking), and a lane whose test passed keeps its step.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.tree import lane_sum, masked_while

__all__ = ["armijo", "ArmijoResult"]

_C = 0.2
_RHO = 0.9
_ALPHA_MIN = 1e-8
_MAX_ITERS = 200


@dataclasses.dataclass
class ArmijoResult:
    alpha: torch.Tensor  # (B,) accepted step widths
    nfev: torch.Tensor  # (B,) int32 value evaluations consumed, per lane
    trips: int = 0  # batched evaluations the search made


def armijo(
    batched_value,
    x,
    f0,
    g0,
    direction,
    alpha_init=1.0,
    *,
    curvature_term=None,
    max_iters: int = _MAX_ITERS,
    active=None,
) -> ArmijoResult:
    """Backtrack every lane of ``x`` ``(B, n)`` along ``direction`` until
    ``f(x + a d) <= f0 + a c (g0.d [+ 0.5 c curvature])``.

    ``batched_value`` maps ``(B, n) -> (B,)``.  ``curvature_term`` (optional,
    ``(B,)`` values of ``d^T H d``) selects the second-order threshold of
    armijo.h:85-95 and disables the alpha floor.  ``active`` (optional,
    ``(B,)`` bool) leaves the other lanes out of the loop: they return
    ``alpha_init`` with nfev 0.  A lane's nfev is its backtracking steps plus
    one, as in the JAX package."""
    dtype = f0.dtype
    b = x.shape[0]
    cache = _C * lane_sum(g0 * direction)
    if curvature_term is not None:
        cache = cache + 0.5 * _C * _C * curvature_term.to(dtype)
        alpha_floor = 0.0
    else:
        alpha_floor = _ALPHA_MIN
    alpha = torch.broadcast_to(
        torch.as_tensor(alpha_init, dtype=dtype, device=x.device), (b,)
    ).clone()
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=x.device)
    trips = 0

    def value_at(alpha):
        nonlocal trips
        trips += 1
        return batched_value(x + alpha[:, None] * direction)

    def cond(c):
        alpha, f_trial, iters = c
        return ((f_trial > f0 + alpha * cache) & (alpha > alpha_floor)
                & (iters < max_iters))

    def body(c, _active):
        alpha, _, iters = c
        alpha = alpha * _RHO
        return alpha, value_at(alpha), iters + 1

    alpha, _, iters = masked_while(cond, body, (
        alpha, value_at(alpha),
        torch.zeros((b,), dtype=torch.int32, device=x.device)), active)
    nfev = torch.where(active, iters + 1, torch.zeros_like(iters))
    return ArmijoResult(alpha=alpha, nfev=nfev, trips=trips)
