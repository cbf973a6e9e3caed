"""L-BFGS history push and two-loop recursion on a batch, in plain PyTorch.

PyTorch counterpart of ``push_history_xla`` and ``two_loop_direction_xla``
of ``cppnumericalsolvers_tpu/ops/two_loop.py``, written for a whole batch:
vectors ``(B, n)``, history ``(B, m, n)`` chronological (row 0 the oldest),
count and gamma ``(B,)``.  They are the arithmetic of the plain versions of
the ``flat_trip`` and ``lbfgs_prologue`` kernels and run nowhere else.
"""

from __future__ import annotations

import torch

__all__ = ["push_history", "search_direction", "two_loop_direction"]


def _rdot(a, b):
    return torch.sum(a * b, dim=-1)


def push_history(s_memory, y_memory, mem_count, gamma, s_new, y_new, valid):
    """Curvature-gated chronological append and gamma update
    (lbfgs.h:253-298): accept the pair iff ``s.y > eps |s||y|`` and it is
    ``valid``; a full history shifts out its oldest row; gamma (N&W 7.20)
    updates under the reference's finite/magnitude guards.  Returns new
    ``(s_memory, y_memory, mem_count, gamma)``."""
    m = s_memory.shape[1]
    eps = torch.finfo(s_memory.dtype).eps

    sy = _rdot(s_new, y_new)
    s2 = _rdot(s_new, s_new)
    y2 = _rdot(y_new, y_new)
    threshold = eps * torch.sqrt(s2) * torch.sqrt(y2)
    accept = valid & (sy > threshold)
    full = mem_count >= m
    slot = torch.clamp_max(mem_count, m - 1)
    new_count = torch.where(accept & ~full, mem_count + 1, mem_count)
    temp = sy / torch.where(y2 > eps, y2, torch.ones_like(y2))
    gamma_ok = (
        valid & (y2 > eps) & torch.isfinite(temp) & (torch.abs(temp) <= 1e7)
    )
    new_gamma = torch.where(gamma_ok, torch.clamp_min(temp, eps), gamma)

    rows = torch.arange(m, device=s_memory.device)
    shift = ((accept & full)[:, None] & (rows < m - 1)[None, :])[..., None]
    write = (accept[:, None] & (slot[:, None] == rows[None, :]))[..., None]

    def push(buf, row):
        up = torch.cat([buf[:, 1:], buf[:, -1:]], dim=1)
        return torch.where(write, row[:, None, :], torch.where(shift, up, buf))

    return push(s_memory, s_new), push(y_memory, y_new), new_count, new_gamma


def two_loop_direction(gradient, s_memory, y_memory, mem_count, gamma):
    """The two-loop recursion ``H * gradient`` (lbfgs.h:141-196) over the
    rows below ``mem_count``, newest to oldest and back, skipping a row
    whose ``|s.y| < eps``."""
    m = s_memory.shape[1]
    eps = torch.finfo(gradient.dtype).eps
    alphas, rhos, usables = [None] * m, [None] * m, [None] * m
    q = gradient
    for r in range(m - 1, -1, -1):
        s_r, y_r = s_memory[:, r], y_memory[:, r]
        denom = _rdot(s_r, y_r)
        usable = (mem_count > r) & (torch.abs(denom) >= eps)
        rho = torch.where(usable, 1.0 / denom, torch.zeros_like(denom))
        alpha = rho * _rdot(s_r, q)
        q = torch.where(usable[:, None], q - alpha[:, None] * y_r, q)
        alphas[r], rhos[r], usables[r] = alpha, rho, usable
    q = q * gamma[:, None]
    for r in range(m):
        s_r, y_r = s_memory[:, r], y_memory[:, r]
        beta = rhos[r] * _rdot(y_r, q)
        q = torch.where(
            usables[r][:, None], q + s_r * (alphas[r] - beta)[:, None], q
        )
    return q


def search_direction(x, gradient, d, mem_count):
    """Descent check of the two-loop direction ``d``, the steepest-descent
    fallback and the line search's set-up (lbfgs.h:199-224).  Returns
    ``(ls_dir, alpha_init, dginit, invalid)``: the direction to search along
    (``-d``, or ``-gradient`` for the ``invalid`` lanes, whose history the
    caller resets), the first step (1/|d| with no curvature history, else
    1; 1/|g| on the fallback) and ``gradient . ls_dir``."""
    eps = torch.finfo(gradient.dtype).eps
    one = torch.ones_like(d[:, 0])
    relative_eps = eps * torch.maximum(one, torch.sqrt(_rdot(x, x)))
    descent = -_rdot(gradient, d)
    direction_norm = torch.sqrt(_rdot(d, d))
    gradient_norm = torch.sqrt(_rdot(gradient, gradient))

    alpha_init = torch.where(
        mem_count == 0,
        torch.where(direction_norm > eps, 1.0 / direction_norm, one),
        one,
    )
    invalid = ~torch.isfinite(descent) | (descent > -eps * relative_eps)
    alpha_init = torch.where(
        invalid,
        torch.where(gradient_norm > eps, 1.0 / gradient_norm, one),
        alpha_init,
    )
    ls_dir = -torch.where(invalid[:, None], gradient, d)
    return ls_dir, alpha_init, _rdot(gradient, ls_dir), invalid
