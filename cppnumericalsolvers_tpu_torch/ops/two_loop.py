"""L-BFGS history push and two-loop recursion on a batch.

PyTorch counterpart of ``cppnumericalsolvers_tpu/ops/two_loop.py``: vectors
``(B, n)``, history ``(B, m, n)`` chronological (row 0 the oldest), count
and gamma ``(B,)``.

Two public ops, each the wrapper of a hand-written CUDA kernel; both also
take one un-batched instance (``(n,)``, ``(m, n)``, 0-d scalars), which
runs as a batch of one:

* :func:`two_loop_direction` -- the bare recursion ``H * gradient``
  (``csrc/two_loop.cu``); the history is read only.
* :func:`lbfgs_push_and_direction` -- the curvature-gated push of a
  candidate pair with the gamma update, then the recursion on the updated
  history (``csrc/push_two_loop.cu``).  It works **in place** on
  ``s_memory``, ``y_memory``, ``mem_count`` and ``gamma``, kernel and plain
  version alike, and returns them; a lane with ``valid = False`` keeps
  every bit of them.  There is no ``done`` input: the caller gates
  ``valid``.

CPU tensors take the plain versions (``*_reference``); CUDA tensors launch
the kernel or raise.  :func:`push_history`,
:func:`two_loop_direction_reference` and :func:`search_direction` are also
the arithmetic of the plain versions of the ``flat_trip`` and prologue
kernels.

The JAX package's compact (Gram-matrix) form of the recursion is switched
off there (``COMPACT_N_MAX = 0``) and is not ported.
"""

from __future__ import annotations

import torch

from ..core.tree import lane_sum
from ._kernel import check_args, check_float, lane_mapping, launch

__all__ = [
    "lbfgs_push_and_direction",
    "lbfgs_push_and_direction_reference",
    "push_gate",
    "push_history",
    "search_direction",
    "two_loop_direction",
    "two_loop_direction_reference",
]


def _rdot(a, b):
    return lane_sum(a * b)


def push_gate(mem_count, gamma, s_new, y_new, valid, m):
    """Curvature gate and gamma of a candidate pair (lbfgs.h:253-298):
    accept iff ``s.y > eps |s||y|`` and it is ``valid``; gamma (N&W 7.20)
    updates under the reference's finite/magnitude guards.  Returns
    ``(accept, full, new_count, new_gamma)``."""
    eps = torch.finfo(s_new.dtype).eps
    sy = _rdot(s_new, y_new)
    s2 = _rdot(s_new, s_new)
    y2 = _rdot(y_new, y_new)
    threshold = eps * torch.sqrt(s2) * torch.sqrt(y2)
    accept = valid & (sy > threshold)
    full = mem_count >= m
    new_count = torch.where(accept & ~full, mem_count + 1, mem_count)
    temp = sy / torch.where(y2 > eps, y2, torch.ones_like(y2))
    gamma_ok = (
        valid & (y2 > eps) & torch.isfinite(temp) & (torch.abs(temp) <= 1e7)
    )
    new_gamma = torch.where(gamma_ok, torch.clamp_min(temp, eps), gamma)
    return accept, full, new_count, new_gamma


def push_history(s_memory, y_memory, mem_count, gamma, s_new, y_new, valid):
    """Curvature-gated chronological append and gamma update
    (:func:`push_gate`): a full history shifts out its oldest row.  Returns
    new ``(s_memory, y_memory, mem_count, gamma)``."""
    m = s_memory.shape[1]
    accept, full, new_count, new_gamma = push_gate(
        mem_count, gamma, s_new, y_new, valid, m)
    slot = torch.clamp_max(mem_count, m - 1)

    rows = torch.arange(m, device=s_memory.device)
    shift = ((accept & full)[:, None] & (rows < m - 1)[None, :])[..., None]
    write = (accept[:, None] & (slot[:, None] == rows[None, :]))[..., None]

    def push(buf, row):
        up = torch.cat([buf[:, 1:], buf[:, -1:]], dim=1)
        return torch.where(write, row[:, None, :], torch.where(shift, up, buf))

    return push(s_memory, s_new), push(y_memory, y_new), new_count, new_gamma


def two_loop_direction_reference(gradient, s_memory, y_memory, mem_count,
                                 gamma, precond_diagonal=None):
    """The two-loop recursion ``H * gradient`` (lbfgs.h:141-196) in plain
    PyTorch over the rows below ``mem_count``, newest to oldest and back,
    skipping a row whose ``|s.y| < eps``.  With ``precond_diagonal``
    ``(B, n)`` the centre scaling is that diagonal instead of ``gamma``
    (lbfgs.h:97-139)."""
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
    if precond_diagonal is not None:
        q = precond_diagonal * q
    else:
        q = q * gamma[:, None]
    for r in range(m):
        s_r, y_r = s_memory[:, r], y_memory[:, r]
        beta = rhos[r] * _rdot(y_r, q)
        q = torch.where(
            usables[r][:, None], q + s_r * (alphas[r] - beta)[:, None], q
        )
    return q


def _batch_of_one(tensors):
    return [t[None] for t in tensors]


def two_loop_direction(gradient, s_memory, y_memory, mem_count, gamma):
    """``H * gradient`` for every lane: ``gradient`` ``(B, n)``, the history
    ``(B, m, n)`` (read only), ``mem_count`` int32 and ``gamma`` ``(B,)``;
    or one un-batched instance.  Rows at or above a lane's count and rows
    with ``|s.y| < eps`` are skipped.

    CPU tensors run :func:`two_loop_direction_reference`; CUDA tensors
    launch the kernel of ``csrc/two_loop.cu`` on the current stream with
    the lanes mapped by :func:`~._kernel.lane_mapping`, or raise (also
    where no mapping fits a block: n > 28,760 in float64, 57,816 in float32
    at m = 10).  ``two_loop_direction.launches`` counts kernel launches."""
    if gradient.dim() == 1:
        return two_loop_direction(*_batch_of_one(
            (gradient, s_memory, y_memory, mem_count, gamma)))[0]
    b, m, n = s_memory.shape
    dtype = gradient.dtype
    check_float("two_loop_direction", dtype)
    dev = check_args("two_loop_direction", {
        "gradient": (gradient, (b, n), dtype),
        "s_memory": (s_memory, (b, m, n), dtype),
        "y_memory": (y_memory, (b, m, n), dtype),
        "mem_count": (mem_count, (b,), torch.int32),
        "gamma": (gamma, (b,), dtype),
    })
    if dev.type == "cpu" or b == 0:
        return two_loop_direction_reference(
            gradient, s_memory, y_memory, mem_count, gamma)
    mapping = lane_mapping("two_loop", b, n, m, gradient.element_size())
    out = torch.empty_like(gradient)
    launch("two_loop", dev, dtype,
           (gradient, s_memory, y_memory, mem_count, gamma, out),
           (b, n, m, *mapping.scalars()))
    two_loop_direction.launches += 1
    return out


two_loop_direction.launches = 0


def lbfgs_push_and_direction_reference(
    gradient, s_memory, y_memory, mem_count, gamma, s_new, y_new, valid,
):
    """The fused op in plain PyTorch: :func:`push_history`, then
    :func:`two_loop_direction_reference` on the updated history, written
    back in place; see :func:`lbfgs_push_and_direction`."""
    s_mem, y_mem, count, new_gamma = push_history(
        s_memory, y_memory, mem_count, gamma, s_new, y_new, valid)
    d = two_loop_direction_reference(gradient, s_mem, y_mem, count, new_gamma)
    s_memory.copy_(s_mem)
    y_memory.copy_(y_mem)
    mem_count.copy_(count)
    gamma.copy_(new_gamma)
    return d, s_memory, y_memory, mem_count, gamma


def lbfgs_push_and_direction(
    gradient, s_memory, y_memory, mem_count, gamma, s_new, y_new, valid,
):
    """Append the candidate pair ``(s_new, y_new)`` ``(B, n)`` to every
    lane's history under the curvature gate (and ``valid``, bool ``(B,)``),
    update gamma, and run the two-loop recursion on the updated history.
    Returns ``(d, s_memory, y_memory, mem_count, gamma)``: the direction
    ``H * gradient`` and the four tensors given, updated in place.  One
    un-batched instance is taken too.

    CPU tensors run :func:`lbfgs_push_and_direction_reference`; CUDA tensors
    launch the kernel of ``csrc/push_two_loop.cu`` on the current stream
    with the lanes mapped by :func:`~._kernel.lane_mapping`, or raise.
    ``lbfgs_push_and_direction.launches`` counts kernel launches."""
    if gradient.dim() == 1:
        d, *_ = lbfgs_push_and_direction(*_batch_of_one(
            (gradient, s_memory, y_memory, mem_count, gamma, s_new, y_new,
             valid)))
        return d[0], s_memory, y_memory, mem_count, gamma
    b, m, n = s_memory.shape
    dtype = gradient.dtype
    op = "lbfgs_push_and_direction"
    check_float(op, dtype)
    dev = check_args(op, {
        "gradient": (gradient, (b, n), dtype),
        "s_memory": (s_memory, (b, m, n), dtype),
        "y_memory": (y_memory, (b, m, n), dtype),
        "mem_count": (mem_count, (b,), torch.int32),
        "gamma": (gamma, (b,), dtype),
        "s_new": (s_new, (b, n), dtype), "y_new": (y_new, (b, n), dtype),
        "valid": (valid, (b,), torch.bool),
    })
    if dev.type == "cpu" or b == 0:
        return lbfgs_push_and_direction_reference(
            gradient, s_memory, y_memory, mem_count, gamma, s_new, y_new,
            valid)
    mapping = lane_mapping("push_two_loop", b, n, m, gradient.element_size())
    d = torch.empty_like(gradient)
    launch("push_two_loop", dev, dtype,
           (gradient, s_new, y_new, valid, s_memory, y_memory, mem_count,
            gamma, d), (b, n, m, *mapping.scalars()))
    lbfgs_push_and_direction.launches += 1
    return d, s_memory, y_memory, mem_count, gamma


lbfgs_push_and_direction.launches = 0


def search_direction(x, gradient, d, mem_count):
    """Descent check of the two-loop direction ``d``, the steepest-descent
    fallback and the line search's set-up (lbfgs.h:199-224).  Returns
    ``(ls_dir, alpha_init, dginit, invalid)``: the direction to search along
    (``-d``, or ``-gradient`` for the ``invalid`` lanes, whose history the
    caller resets), the first step (1/|d| with no curvature history, else
    1; 1/|g| on the fallback) and ``gradient . ls_dir``."""
    eps = torch.finfo(gradient.dtype).eps
    one = d.new_ones(d.shape[:-1])
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
