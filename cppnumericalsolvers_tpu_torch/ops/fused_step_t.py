"""The batch-minor ("transposed") L-BFGS prologue.

PyTorch counterpart of ``cppnumericalsolvers_tpu/ops/fused_step_t.py``.  It
computes what :func:`~.fused_step.lbfgs_prologue` computes (push of the
pending pair, gamma, two-loop, invalid-descent fallback, ``alpha_init``,
``dginit``; done lanes inert) on another storage layout of the history:

    ``(m * n, B)``: element ``j`` of row ``r`` of lane ``i`` at
    ``[r * n + j, i]``, the batch in the minor (contiguous) dimension.

On the card this gives neighbouring threads neighbouring lanes of one
history element, so a warp's loads coalesce at any n, and a dot product over
n is a serial sum in the few threads that share a lane (``csrc/
lbfgs_prologue_t.cu``).  Only the history is batch-minor: the iteration
vectors (``x``, ``gradient``, the pending pair, the direction) stay
``(B, n)``, and the kernel reads and writes them where they are.  The port
pads nothing: any ``B`` and ``n`` are taken, and the lanes of a last,
partly filled block are inert.

:func:`lbfgs_prologue_t` is the wrapper of the kernel: CPU tensors take the
plain version (:func:`lbfgs_prologue_t_reference`, the batch-major plain
version on a view of the history), CUDA tensors launch the kernel or raise.
Both work **in place** on the history, its count and gamma; a done lane
keeps every bit of them and gets the zero direction with ``dginit = 0`` and
``alpha_init = 1``, as in :mod:`.fused_step`.

The layout helpers convert a whole history: :func:`make_history_t`,
:func:`history_rows_to_t`, :func:`history_t_to_rows`.
"""

from __future__ import annotations

import torch

from ._kernel import SMEM_LIMIT, check_args, check_float, launch
from .fused_step import lbfgs_prologue_reference

__all__ = [
    "history_rows_to_t",
    "history_t_to_rows",
    "lbfgs_prologue_t",
    "lbfgs_prologue_t_reference",
    "make_history_t",
    "prologue_t_launch_plan",
]

_BLOCK_THREADS = 256
_MAX_LANE_TILE, _MIN_LANE_TILE = 32, 8
_SM_COUNT = 132  # an H100's streaming multiprocessors
_SUMS = 5  # values the widest in-block reduction carries
# A block keeps the two-loop's q in shared memory while two blocks still fit
# on one SM; above that q lives in a (n, B) scratch tensor.
_Q_SMEM_BUDGET = 100 * 1024


def make_history_t(b: int, m: int, n: int, dtype, device="cpu"):
    """A fresh batch-minor history: ``(m * n, B)`` zeros."""
    return torch.zeros((m * n, b), dtype=dtype, device=device)


def _rows_view(hist_t, m: int, n: int):
    """``(m * n, B)`` seen as ``(B, m, n)`` without a copy."""
    return hist_t.t().reshape(hist_t.shape[1], m, n)


def history_t_to_rows(hist_t, m: int, n: int):
    """``(m * n, B)`` batch-minor history -> a new contiguous ``(B, m, n)``
    (for results, checkpoints and warm starts)."""
    return _rows_view(hist_t, m, n).contiguous()


def history_rows_to_t(hist):
    """``(B, m, n)`` -> a new contiguous batch-minor ``(m * n, B)``."""
    b, m, n = hist.shape
    return hist.reshape(b, m * n).t().contiguous()


def lbfgs_prologue_t_reference(
    x, gradient, s_memory_t, y_memory_t, mem_count, gamma, s_new, y_new,
    valid, done,
):
    """The batch-minor prologue in plain PyTorch: the batch-major plain
    version run on ``(B, m, n)`` views of the two history buffers, which it
    updates in place; see :func:`lbfgs_prologue_t`."""
    n = gradient.shape[1]
    m = s_memory_t.shape[0] // n
    ls_dir, alpha_init, dginit, *_ = lbfgs_prologue_reference(
        x, gradient, _rows_view(s_memory_t, m, n),
        _rows_view(y_memory_t, m, n), mem_count, gamma, s_new, y_new, valid,
        done,
    )
    return (ls_dir, alpha_init, dginit, s_memory_t, y_memory_t, mem_count,
            gamma)


def prologue_t_launch_plan(b: int, m: int, n: int, itemsize: int) -> dict:
    """How the kernel is launched for a ``(B, n)`` batch: ``lane_tile`` lanes
    and ``slices`` threads per lane in each block (threads of one lane split
    the n elements between them), whether q lives in shared memory, and the
    block's shared memory in bytes.

    The lane tile is 32 (one warp reads 32 neighbouring lanes of an element
    in one transaction) and is halved, down to 8 (one 32-byte sector in
    float32), while there are fewer blocks than the card has SMs."""
    lane_tile = _MAX_LANE_TILE
    while lane_tile > _MIN_LANE_TILE and -(-b // lane_tile) < _SM_COUNT:
        lane_tile //= 2
    slices = max(1, min(_BLOCK_THREADS // lane_tile, n))
    fixed = (_SUMS * slices + 2 * m) * lane_tile * itemsize + (
        m + 1) * lane_tile * 4
    q_bytes = n * lane_tile * itemsize
    q_in_smem = fixed + q_bytes <= _Q_SMEM_BUDGET
    return {
        "lane_tile": lane_tile, "slices": slices, "q_in_smem": q_in_smem,
        "smem_bytes": fixed + (q_bytes if q_in_smem else 0),
    }


def lbfgs_prologue_t(
    x, gradient, s_memory_t, y_memory_t, mem_count, gamma, s_new, y_new,
    valid, done,
):
    """The first half of an L-BFGS iteration for every lane of a batch, on
    the batch-minor history.

    ``x``, ``gradient`` and the pending pair ``s_new``, ``y_new`` are
    ``(B, n)``; ``s_memory_t``, ``y_memory_t`` are ``(m * n, B)``;
    ``mem_count`` (int32), ``gamma``, ``valid`` and ``done`` (bool) are
    ``(B,)``.  The history, ``mem_count`` and ``gamma`` are updated in
    place.  Returns ``(ls_dir, alpha_init, dginit, s_memory_t, y_memory_t,
    mem_count, gamma)`` as :func:`~.fused_step.lbfgs_prologue` does, with
    ``ls_dir`` ``(B, n)``.

    CPU tensors run :func:`lbfgs_prologue_t_reference`; CUDA tensors launch
    the kernel of ``csrc/lbfgs_prologue_t.cu`` on the current stream, or
    raise.  There is no limit on n: where q does not fit a block's shared
    memory it goes to a scratch tensor.  ``lbfgs_prologue_t.launches``
    counts kernel launches."""
    b, n = gradient.shape
    if n == 0 or s_memory_t.dim() != 2 or s_memory_t.shape[0] % n:
        raise ValueError(
            f"lbfgs_prologue_t: s_memory_t must be (m * n, B) with n = {n}, "
            f"got shape {tuple(s_memory_t.shape)}")
    m = s_memory_t.shape[0] // n
    dtype = gradient.dtype
    check_float("lbfgs_prologue_t", dtype)
    dev = check_args("lbfgs_prologue_t", {
        "x": (x, (b, n), dtype), "gradient": (gradient, (b, n), dtype),
        "s_memory_t": (s_memory_t, (m * n, b), dtype),
        "y_memory_t": (y_memory_t, (m * n, b), dtype),
        "mem_count": (mem_count, (b,), torch.int32),
        "gamma": (gamma, (b,), dtype),
        "s_new": (s_new, (b, n), dtype), "y_new": (y_new, (b, n), dtype),
        "valid": (valid, (b,), torch.bool), "done": (done, (b,), torch.bool),
    })
    if dev.type == "cpu" or b == 0:
        return lbfgs_prologue_t_reference(
            x, gradient, s_memory_t, y_memory_t, mem_count, gamma, s_new,
            y_new, valid, done,
        )
    plan = prologue_t_launch_plan(b, m, n, x.element_size())
    if plan["smem_bytes"] > SMEM_LIMIT:
        raise ValueError(
            f"lbfgs_prologue_t: m={m} needs {plan['smem_bytes']} bytes of "
            f"shared memory per block, more than the {SMEM_LIMIT} a Hopper "
            "block has")
    ls_dir = torch.empty_like(gradient)
    alpha_init = torch.empty_like(gamma)
    dginit = torch.empty_like(gamma)
    # An empty tensor's pointer is null: the kernel then keeps q in shared
    # memory.
    q_scratch = torch.empty(
        (0,) if plan["q_in_smem"] else (n, b), dtype=dtype, device=dev)
    launch(
        "lbfgs_prologue_t", dev, dtype,
        (x, gradient, s_new, y_new, valid, done, s_memory_t, y_memory_t,
         mem_count, gamma, ls_dir, alpha_init, dginit, q_scratch),
        (b, n, m, plan["lane_tile"], plan["slices"]),
    )
    lbfgs_prologue_t.launches += 1
    return (ls_dir, alpha_init, dginit, s_memory_t, y_memory_t, mem_count,
            gamma)


lbfgs_prologue_t.launches = 0
