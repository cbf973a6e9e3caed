"""The batch-minor ("transposed") L-BFGS prologue.

PyTorch counterpart of ``cppnumericalsolvers_tpu/ops/fused_step_t.py``.  It
computes what :func:`~.fused_step.lbfgs_prologue` computes (push of the
pending pair, gamma, two-loop, invalid-descent fallback, ``alpha_init``,
``dginit``; done lanes inert) on another storage layout of the history:

    ``(m * n, B)``: element ``j`` of physical row ``p`` of lane ``i`` at
    ``[p * n + j, i]``, the batch in the minor (contiguous) dimension.

On the card this gives neighbouring threads neighbouring lanes of one
history element, so a warp's loads coalesce at any n (``csrc/
lbfgs_prologue_t.cu``; :func:`prologue_t_launch_plan` sizes its grid by
``B x n``).  The kernel adds its sums in the batch-major kernel's order, so
on the card the two layouts give the same bits.  Only the history is
batch-minor: the iteration vectors (``x``, ``gradient``, the pending pair,
the direction) stay ``(B, n)``.  The port pads nothing: any ``B`` is taken,
and the lanes of a last, partly filled tile are inert.

Given a per-lane ``head`` (int32, ``(B,)``), the history is a ring: the row
of age ``k`` (0 the oldest) is physical row ``(head + k) mod m``, an
accepted pair writes one row, and a push into a full history overwrites the
oldest row and moves ``head`` on by one.  Nothing shifts.  This is how the
batch-minor loop carries it (``LbfgsInternalsT.head``); :func:`gather_rows`
turns it chronological.  Without a head the op keeps the chronological
contract: row 0 is the oldest, and a full history shifts.

:func:`lbfgs_prologue_t` is the wrapper of the kernel: CPU tensors take the
plain version (:func:`lbfgs_prologue_t_reference`, the batch-major plain
version on a chronological view), CUDA tensors launch the kernel or raise.
Both work **in place** on the history, its count, gamma and head; a done
lane keeps every bit of them and gets the zero direction with ``dginit =
0`` and ``alpha_init = 1``, as in :mod:`.fused_step`.

The layout helpers convert a whole history: :func:`make_history_t`,
:func:`history_rows_to_t`, :func:`history_t_to_rows`, :func:`gather_rows`.
"""

from __future__ import annotations

import torch

from ._kernel import SMEM_LIMIT, check_args, check_float, lane_threads, launch
from .fused_step import lbfgs_prologue_reference
from .two_loop import push_gate

__all__ = [
    "gather_rows",
    "history_rows_to_t",
    "history_t_to_rows",
    "lbfgs_prologue_t",
    "lbfgs_prologue_t_reference",
    "make_history_t",
    "prologue_t_launch_plan",
]

_SM_COUNT = 132  # an H100's streaming multiprocessors
_LANE_TILE = 8  # neighbouring lanes of a tile: one 32-byte sector in float32
_CLUSTERS = (1, 2, 4, 8)
_EPT_MAX = 16  # elements a thread keeps in registers
_SUMS = 5  # values the widest reduction carries
# A grid fills the card with at least two blocks per SM, or 16 warps per SM.
FILL_BLOCKS = 2 * _SM_COUNT
FILL_WARPS = 16 * _SM_COUNT


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


def gather_rows(hist_t, head, m: int, n: int):
    """The ring ``(m * n, B)`` with per-lane ``head`` -> a new contiguous
    chronological ``(B, m, n)``: row ``k`` is the lane's age ``k``."""
    rows = _rows_view(hist_t, m, n)
    ages = torch.arange(m, device=hist_t.device)
    idx = (head.long()[:, None] + ages[None, :]) % m
    return torch.gather(rows, 1, idx[:, :, None].expand(-1, -1, n))


def lbfgs_prologue_t_reference(
    x, gradient, s_memory_t, y_memory_t, mem_count, gamma, s_new, y_new,
    valid, done, head=None,
):
    """The batch-minor prologue in plain PyTorch: the batch-major plain
    version run on a chronological ``(B, m, n)`` form of the two history
    buffers, which it updates in place; see :func:`lbfgs_prologue_t`.
    With ``head`` the buffers are a ring: the chronological copy is
    gathered, pushed and written back, every age to its physical row under
    the new head (``head`` plus one where a full history accepted)."""
    n = gradient.shape[1]
    m = s_memory_t.shape[0] // n
    if head is None:
        ls_dir, alpha_init, dginit, *_ = lbfgs_prologue_reference(
            x, gradient, _rows_view(s_memory_t, m, n),
            _rows_view(y_memory_t, m, n), mem_count, gamma, s_new, y_new,
            valid, done,
        )
        return (ls_dir, alpha_init, dginit, s_memory_t, y_memory_t,
                mem_count, gamma)
    accept, full, _, _ = push_gate(mem_count, gamma, s_new, y_new,
                                   valid & ~done, m)
    s_rows = gather_rows(s_memory_t, head, m, n)
    y_rows = gather_rows(y_memory_t, head, m, n)
    ls_dir, alpha_init, dginit, *_ = lbfgs_prologue_reference(
        x, gradient, s_rows, y_rows, mem_count, gamma, s_new, y_new, valid,
        done,
    )
    head.copy_((head + (accept & full).to(head.dtype)) % m)
    ages = torch.arange(m, device=head.device)
    phys = ((head.long()[:, None] + ages[None, :]) % m)[:, :, None].expand(
        -1, -1, n)
    for buf, rows in ((s_memory_t, s_rows), (y_memory_t, y_rows)):
        view = torch.empty_like(rows)
        view.scatter_(1, phys, rows)
        buf.copy_(view.reshape(view.shape[0], m * n).t())
    return (ls_dir, alpha_init, dginit, s_memory_t, y_memory_t, mem_count,
            gamma)


def _plan_smem(slots: int, m: int, itemsize: int) -> int:
    """Shared memory of one block (csrc/lbfgs_prologue_t.cu ``plan_smem``):
    the double-buffered partials of the tile's real warps (``slots`` per
    lane and value, padded by 16 bytes) for the widest reduction, and alpha,
    rho and the usable flag per row and lane."""
    stride = slots + 16 // itemsize
    return (2 * _SUMS * _LANE_TILE * stride + 3 * m * _LANE_TILE) * itemsize


def launch_candidates(b: int, m: int, n: int, itemsize: int):
    """Every launch the kernel takes for a ``(B, n)`` batch, fewest blocks
    per cluster first (``lane_sweep.py`` times them all).

    The kernel adds its sums in the order of the batch-major kernel's
    ``lane_threads(n)`` threads per lane (``threads_per_lane``: 32 virtual
    threads to a virtual warp, ``ept`` elements each); a tile of 8 lanes
    has 8 real warps per virtual warp, split over ``cluster`` blocks of
    ``warps_per_block`` warps (at most 8, or 16 where a lane has more than
    8 virtual warps)."""
    tpl = lane_threads(n)
    nvw = tpl // 32
    ept = -(-n // tpl)
    if ept > _EPT_MAX:
        return
    ept = 1 << (ept - 1).bit_length()
    slots = 8 * nvw
    for cluster in _CLUSTERS:
        warps = slots // cluster
        if slots % cluster or warps > (16 if nvw > 8 else 8):
            continue
        blocks = -(-b // _LANE_TILE) * cluster
        yield {
            "lane_tile": _LANE_TILE, "threads_per_lane": tpl,
            "warps_per_block": warps, "cluster": cluster, "ept": ept,
            "threads": 32 * warps, "blocks": blocks,
            "warps": blocks * warps,
            "smem_bytes": _plan_smem(slots, m, itemsize),
        }


def prologue_t_launch_plan(b: int, m: int, n: int, itemsize: int) -> dict:
    """How the kernel is launched for a ``(B, n)`` batch (see
    :func:`launch_candidates`): the candidate with the fewest blocks per
    cluster (each reduction waits on a cluster barrier) whose grid fills the
    card (``FILL_BLOCKS`` blocks, or ``FILL_WARPS`` warps), or, where none
    fills (a small batch), the one with the most blocks.  Raises
    ``ValueError`` where none fits (n above 8192) or its shared memory
    exceeds a block's."""
    plans = list(launch_candidates(b, m, n, itemsize))
    if not plans:
        raise ValueError(
            f"lbfgs_prologue_t: n={n} needs more than {_EPT_MAX} elements "
            "a thread")
    filling = [p for p in plans
               if p["blocks"] >= FILL_BLOCKS or p["warps"] >= FILL_WARPS]
    plan = filling[0] if filling else max(plans, key=lambda p: p["blocks"])
    if plan["smem_bytes"] > SMEM_LIMIT:
        raise ValueError(
            f"lbfgs_prologue_t: m={m}, n={n} needs {plan['smem_bytes']} "
            f"bytes of shared memory per block, more than the {SMEM_LIMIT} "
            "a Hopper block has")
    return plan


def lbfgs_prologue_t(
    x, gradient, s_memory_t, y_memory_t, mem_count, gamma, s_new, y_new,
    valid, done, head=None,
):
    """The first half of an L-BFGS iteration for every lane of a batch, on
    the batch-minor history.

    ``x``, ``gradient`` and the pending pair ``s_new``, ``y_new`` are
    ``(B, n)``; ``s_memory_t``, ``y_memory_t`` are ``(m * n, B)``;
    ``mem_count`` (int32), ``gamma``, ``valid`` and ``done`` (bool) are
    ``(B,)``; ``head`` (int32 ``(B,)``, optional) makes the history a ring
    (see the module's note), else it is chronological.  The history,
    ``mem_count``, ``gamma`` and ``head`` are updated in place.  Returns
    ``(ls_dir, alpha_init, dginit, s_memory_t, y_memory_t, mem_count,
    gamma)`` as :func:`~.fused_step.lbfgs_prologue` does, with ``ls_dir``
    ``(B, n)``.

    CPU tensors run :func:`lbfgs_prologue_t_reference`; CUDA tensors launch
    the kernel of ``csrc/lbfgs_prologue_t.cu`` on the current stream under
    :func:`prologue_t_launch_plan`, or raise.  The kernel always runs the
    ring; without ``head`` it runs from head 0 and the rows of the lanes
    whose full history took a pair are then rotated back to chronological
    order.  ``lbfgs_prologue_t.launches`` counts kernel launches."""
    b, n = gradient.shape
    if n == 0 or s_memory_t.dim() != 2 or s_memory_t.shape[0] % n:
        raise ValueError(
            f"lbfgs_prologue_t: s_memory_t must be (m * n, B) with n = {n}, "
            f"got shape {tuple(s_memory_t.shape)}")
    m = s_memory_t.shape[0] // n
    dtype = gradient.dtype
    check_float("lbfgs_prologue_t", dtype)
    expect = {
        "x": (x, (b, n), dtype), "gradient": (gradient, (b, n), dtype),
        "s_memory_t": (s_memory_t, (m * n, b), dtype),
        "y_memory_t": (y_memory_t, (m * n, b), dtype),
        "mem_count": (mem_count, (b,), torch.int32),
        "gamma": (gamma, (b,), dtype),
        "s_new": (s_new, (b, n), dtype), "y_new": (y_new, (b, n), dtype),
        "valid": (valid, (b,), torch.bool), "done": (done, (b,), torch.bool),
    }
    if head is not None:
        expect["head"] = (head, (b,), torch.int32)
    dev = check_args("lbfgs_prologue_t", expect)
    if dev.type == "cpu" or b == 0:
        return lbfgs_prologue_t_reference(
            x, gradient, s_memory_t, y_memory_t, mem_count, gamma, s_new,
            y_new, valid, done, head,
        )
    plan = prologue_t_launch_plan(b, m, n, x.element_size())
    ring = head if head is not None else torch.zeros(
        (b,), dtype=torch.int32, device=dev)
    ls_dir = torch.empty_like(gradient)
    alpha_init = torch.empty_like(gamma)
    dginit = torch.empty_like(gamma)
    launch(
        "lbfgs_prologue_t", dev, dtype,
        (x, gradient, s_new, y_new, valid, done, s_memory_t, y_memory_t,
         mem_count, ring, gamma, ls_dir, alpha_init, dginit),
        (b, n, m, plan["threads_per_lane"], plan["warps_per_block"],
         plan["cluster"]),
    )
    _prologue_t_wrapper.launches += 1
    if head is None:
        # Chronological contract: a lane whose full history took a pair
        # (head 1 now) has its oldest row at physical m - 1 after the
        # ring's write; rotate its rows up by one.
        moved = (ring != 0)[None, None, :]
        for buf in (s_memory_t, y_memory_t):
            rows = buf.view(m, n, b)
            buf.copy_(torch.where(moved, torch.roll(rows, -1, 0), rows)
                      .reshape(m * n, b))
    return (ls_dir, alpha_init, dginit, s_memory_t, y_memory_t, mem_count,
            gamma)


lbfgs_prologue_t.launches = 0
# Callers may stand other functions in under the name; the wrapper counts on
# itself.
_prologue_t_wrapper = lbfgs_prologue_t
