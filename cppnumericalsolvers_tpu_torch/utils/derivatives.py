"""Finite-difference derivative checkers.

PyTorch counterpart of ``cppnumericalsolvers_tpu/utils/derivatives.py``
(the reference's include/cppoptlib/utils/derivatives.h:37-311): the four
central-difference accuracy orders and the 16-point mixed-partial stencil,
with the JAX package's step sizes.  Every check builds all its evaluation
points first and evaluates them in one ``torch.func.vmap`` call.  ``fn``
maps one ``(n,)`` tensor to a scalar, as an objective's ``fn`` does.
"""

from __future__ import annotations

import torch
from torch.func import vmap

__all__ = [
    "compute_finite_gradient",
    "compute_finite_hessian",
    "is_gradient_correct",
    "is_hessian_correct",
]

# Central-difference coefficient tables (derivatives.h:52-62), the JAX
# package's own.
_COEFF = (
    (1.0, -1.0),
    (1.0, -8.0, 8.0, -1.0),
    (-1.0, 9.0, -45.0, 45.0, -9.0, 1.0),
    (3.0, -32.0, 168.0, -672.0, 672.0, -168.0, 32.0, -3.0),
)
_COEFF2 = (
    (1.0, -1.0),
    (-2.0, -1.0, 1.0, 2.0),
    (-3.0, -2.0, -1.0, 1.0, 2.0, 3.0),
    (-4.0, -3.0, -2.0, -1.0, 1.0, 2.0, 3.0, 4.0),
)
_DD = (2.0, 12.0, 60.0, 840.0)

# The 16-point mixed stencil (derivatives.h:160-240): offsets of (i, j) in
# units of the pair's mean step, in four terms weighted (-63, 63, 44, 74),
# each a signed sum of four evaluations.
_MIXED = (
    (-63.0, ((1.0, -2.0, 1), (2.0, -1.0, 1), (-2.0, 1.0, 1), (-1.0, 2.0, 1))),
    (63.0, ((-1.0, -2.0, 1), (-2.0, -1.0, 1), (1.0, 2.0, 1), (2.0, 1.0, 1))),
    (44.0, ((2.0, -2.0, 1), (-2.0, 2.0, 1), (-2.0, -2.0, -1),
            (2.0, 2.0, -1))),
    (74.0, ((-1.0, -1.0, 1), (1.0, 1.0, 1), (1.0, -1.0, -1),
            (-1.0, 1.0, -1))),
)


def compute_finite_gradient(fn, x0, accuracy: int = 0) -> torch.Tensor:
    """Finite-difference gradient at ``x0`` ``(n,)`` (derivatives.h:37-83).

    ``accuracy`` in {0, 1, 2, 3} selects 2/4/6/8-point central differences.
    Step per coordinate: ``sqrt(eps) * max(|x0_d|, 1)``.  The ``n * k``
    evaluations are one vmapped call."""
    x0 = torch.as_tensor(x0)
    n = x0.shape[-1]
    dtype, dev = x0.dtype, x0.device
    eps = torch.finfo(dtype).eps
    h = torch.sqrt(torch.tensor(eps, dtype=dtype, device=dev)) * torch.clamp(
        torch.abs(x0), min=1.0)
    coeff = torch.tensor(_COEFF[accuracy], dtype=dtype, device=dev)
    coeff2 = torch.tensor(_COEFF2[accuracy], dtype=dtype, device=dev)
    k = coeff.shape[0]
    eye = torch.eye(n, dtype=dtype, device=dev)
    # Point (d, s) is x0 + coeff2[s] * h_d e_d.
    offsets = coeff2[None, :, None] * (h[:, None, None] * eye[:, None, :])
    points = x0[None, None, :] + offsets  # (n, k, n)
    values = vmap(fn)(points.reshape(n * k, n)).reshape(n, k)
    return (values @ coeff) / (_DD[accuracy] * h)


def compute_finite_hessian(fn, x0, accuracy: int = 0) -> torch.Tensor:
    """Finite-difference Hessian at ``x0`` ``(n,)`` (derivatives.h:86-252).

    ``accuracy == 0``: central differences; ``accuracy > 0``: the 16-point
    mixed-partial stencil with weights (-63, 63, 44, 74) / (600 hbar^2),
    hbar the pair's mean step.  The step is ``eps^(1/4) * max(|x0_d|, 1)``,
    the JAX package's (the reference's ``sqrt(eps)`` cancels away from small
    values).  The diagonal is ``(f(x+h) - 2 f(x) + f(x-h)) / h^2`` in both
    modes, and the lower triangle is the upper one mirrored.  All
    evaluations are one vmapped call."""
    x0 = torch.as_tensor(x0)
    n = x0.shape[-1]
    dtype, dev = x0.dtype, x0.device
    eps = torch.finfo(dtype).eps
    h = eps ** 0.25 * torch.clamp(torch.abs(x0), min=1.0)
    eye = torch.eye(n, dtype=dtype, device=dev)

    # Pair steps (i, j): h_i and h_j, or the mean step in both.
    if accuracy == 0:
        hi, hj = h[:, None], h[None, :]
        pairs = ((1.0, 1.0, 1), (1.0, -1.0, -1), (-1.0, 1.0, -1),
                 (-1.0, -1.0, 1))
        stencil = ((1.0, pairs),)
    else:
        hbar = (h[:, None] + h[None, :]) / 2.0
        hi = hj = hbar
        stencil = _MIXED

    def pair_points(ci, cj):
        # x0 + ci * hi e_i + cj * hj e_j for every (i, j): (n, n, n).
        return (x0[None, None, :]
                + (ci * hi)[..., None].expand(n, n, 1) * eye[:, None, :]
                + (cj * hj)[..., None].expand(n, n, 1) * eye[None, :, :])

    offs = [(ci, cj) for _, terms in stencil for ci, cj, _ in terms]
    points = [x0[None, :], x0[None, :] + h[:, None] * eye,
              x0[None, :] - h[:, None] * eye]
    points += [pair_points(ci, cj).reshape(n * n, n) for ci, cj in offs]
    values = vmap(fn)(torch.cat(points))
    f0 = values[0]
    f_plus, f_minus = values[1:n + 1], values[n + 1:2 * n + 1]
    pair_values = values[2 * n + 1:].reshape(len(offs), n, n)
    diag = (f_plus - 2.0 * f0 + f_minus) / (h * h)

    at = iter(pair_values)
    if accuracy == 0:
        f_pp, f_pm, f_mp, f_mm = (next(at) for _ in range(4))
        off = (f_pp - f_pm - f_mp + f_mm) / (4.0 * torch.outer(h, h))
    else:
        total = None
        for weight, terms in stencil:
            term = None
            for _, _, sign in terms:
                v = next(at)
                term = v if term is None else (
                    term + v if sign > 0 else term - v)
            total = weight * term if total is None else total + weight * term
        off = total / (600.0 * hbar * hbar)

    hessian = off - torch.diag(torch.diagonal(off)) + torch.diag(diag)
    iu = torch.triu_indices(n, n, 1, device=dev)
    hessian[iu[1], iu[0]] = hessian[iu[0], iu[1]]
    return hessian


def _agrees(actual, expected, tolerance) -> bool:
    scale = torch.clamp(
        torch.maximum(torch.abs(actual), torch.abs(expected)), min=1.0)
    return bool(torch.all(torch.abs(actual - expected) <= tolerance * scale))


def is_gradient_correct(objective, x0, accuracy: int = 3,
                        tolerance=1e-2) -> bool:
    """Whether the objective's gradient at ``x0`` agrees with finite
    differences, relative to ``max(|g|, |fd|, 1)`` per entry
    (derivatives.h:254-283)."""
    x0 = torch.as_tensor(x0)
    return _agrees(objective.gradient(x0),
                   compute_finite_gradient(objective.fn, x0, accuracy),
                   tolerance)


def is_hessian_correct(objective, x0, accuracy: int = 3,
                       tolerance=1e-1) -> bool:
    """Whether the objective's Hessian at ``x0`` agrees with finite
    differences, as :func:`is_gradient_correct` (derivatives.h:285-311)."""
    x0 = torch.as_tensor(x0)
    return _agrees(objective.hessian(x0),
                   compute_finite_hessian(objective.fn, x0, accuracy),
                   tolerance)
