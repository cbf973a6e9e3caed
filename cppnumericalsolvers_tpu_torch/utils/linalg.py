"""Small dense linear-algebra helpers shared by second-order paths.

PyTorch counterpart of ``cppnumericalsolvers_tpu/utils/linalg.py`` for what
the Hessian-condition criterion needs.  The inverse is a library call
(``torch.linalg.inv``), as it is ``jnp.linalg.inv`` in the JAX package: it
runs outside any kernel there too.
"""

from __future__ import annotations

import torch

__all__ = ["frobenius_condition", "condition_test_enabled"]


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
