"""Small dense linear-algebra helpers shared by second-order paths.

PyTorch counterpart of ``cppnumericalsolvers_tpu/utils/linalg.py``:

* :func:`frobenius_condition` for the Hessian-condition criterion.  Its
  inverse is a library call (``torch.linalg.inv``), as it is
  ``jnp.linalg.inv`` in the JAX package: it runs outside any kernel there
  too;
* :func:`solve_small` and :func:`invert_small`, L-BFGS-B's ``(2m, 2m)``
  solves: the JAX package's unrolled Gauss-Jordan with partial pivoting,
  step for step (not ``torch.linalg.solve``, whose pivot order and
  arithmetic differ), batched over any leading dimensions.
"""

from __future__ import annotations

import torch

__all__ = [
    "frobenius_condition",
    "condition_test_enabled",
    "solve_small",
    "invert_small",
]


def condition_test_enabled(stopping) -> bool:
    """Whether the HessianConditionViolation criterion is live.  cond(H)
    costs a Hessian and an inverse per iteration, so it is computed only
    when the criterion is on (the default is off: ``condition_hessian ==
    0``)."""
    return bool(stopping.condition_hessian > 0)


def frobenius_condition(hessian: torch.Tensor) -> torch.Tensor:
    """Frobenius-norm condition estimate ``|H|_F * |H^{-1}|_F`` of a matrix
    ``(n, n)`` or of every matrix of a batch ``(B, n, n)``.

    This is the metric the reference's progress machine computes for
    second-mode functions (progress.h:197-208: Eigen's ``.norm()`` is the
    Frobenius norm).  A singular H has no finite inverse; that maps to the
    dtype's largest value, so the criterion still fires."""
    big = torch.finfo(hessian.dtype).max
    inv, info = torch.linalg.inv_ex(hessian)
    norm = torch.linalg.matrix_norm
    cond = norm(hessian) * norm(inv)
    ok = (info == 0) & torch.isfinite(cond)
    return torch.where(ok, cond, torch.full_like(cond, big))


def solve_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a @ x = b`` for small ``k x k`` systems by Gauss-Jordan
    elimination with partial pivoting, unrolled over the k columns.

    ``a`` is ``(..., k, k)`` and ``b`` is ``(..., k)`` or ``(..., k, r)``
    with the same leading dimensions.  At column j the pivot is the first
    row of largest magnitude among rows >= j (``torch.argmax`` returns the
    first maximum, as ``jnp.argmax`` does); rows j and p swap, the pivot
    row is divided by its pivot and subtracted from every other row.  A
    singular pivot propagates inf or NaN, as an LU solve would."""
    k = a.shape[-1]
    vec = b.dim() == a.dim() - 1
    rhs = b[..., None] if vec else b
    m = torch.cat([a, rhs.to(a.dtype)], dim=-1)  # (..., k, k + r)
    rows = torch.arange(k, device=a.device)
    neg = torch.tensor(-1.0, dtype=a.dtype, device=a.device)
    width = m.shape[-1]
    for j in range(k):
        col = m[..., j]
        cand = torch.where(rows >= j, torch.abs(col), neg)
        p = torch.argmax(cand, dim=-1)  # (...)
        pivot_row = torch.gather(
            m, -2, p[..., None, None].expand(*p.shape, 1, width))[..., 0, :]
        row_j = m[..., j, :]
        at_j = (rows == j)[:, None]
        at_p = (rows == p[..., None])[..., None]
        m = torch.where(at_j, pivot_row[..., None, :],
                        torch.where(at_p, row_j[..., None, :], m))
        norm_row = pivot_row / pivot_row[..., j:j + 1]
        factor = m[..., j]
        elim = m - factor[..., None] * norm_row[..., None, :]
        m = torch.where(at_j, norm_row[..., None, :], elim)
    x = m[..., k:]
    return x[..., 0] if vec else x


def invert_small(a: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of small ``(..., k, k)`` matrices: :func:`solve_small`
    against the identity."""
    k = a.shape[-1]
    eye = torch.eye(k, dtype=a.dtype, device=a.device)
    return solve_small(a, eye.expand(a.shape).clone())
