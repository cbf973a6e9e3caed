"""The two halves of one batched L-BFGS iteration around the line search.

PyTorch counterpart of ``cppnumericalsolvers_tpu/ops/fused_step.py``.  One
iteration of the iteration-granular loop is::

    lbfgs_prologue -> line-search trips (objective evaluations) ->
    lbfgs_epilogue -> loop predicate

* :func:`lbfgs_prologue` -- curvature-gated push of the pending correction
  pair with the gamma update, the two-loop recursion, the invalid-descent
  fallback to steepest descent with a history reset (lbfgs.h:199-224), the
  initial step width and the search's directional derivative.
* :func:`lbfgs_epilogue` -- the non-finite guard on the search's result
  (lbfgs.h:234-241), the next pending pair, the stall reset of the history
  count, and the whole ``Progress::Update`` ladder (progress.h:153-327).

Each is the wrapper of a hand-written CUDA kernel (``csrc/lbfgs_prologue.cu``,
``csrc/lbfgs_epilogue.cu``): CPU tensors take the plain PyTorch version
beside it (``*_reference``), CUDA tensors launch the kernel or raise.

Both work in place on the loop's carry, kernel and plain version alike: the
prologue on the history, its count and gamma; the epilogue on the iterate,
the pending pair, the count and the progress record.  A done lane keeps
every bit of them.  For a done lane the prologue emits the zero direction
with ``dginit = 0``, so the search aborts that lane before its first
evaluation by its own non-descent rule, and the epilogue ignores what the
search returns for it.  (The JAX package computes a direction for done
lanes too and discards the search's result for them.)
"""

from __future__ import annotations

import torch

from ..core.objective import FunctionState
from ..core.progress import (
    PAST_RING_SIZE,
    ProgressState,
    StoppingCriteria,
    update_progress,
)
from ..core.tree import tree_where
from ._kernel import check_args, check_float, lane_mapping, launch
from .flat_solve import crit_scalars
from .two_loop import (
    push_history,
    search_direction,
    two_loop_direction_reference,
)

__all__ = [
    "lbfgs_prologue",
    "lbfgs_prologue_reference",
    "lbfgs_epilogue",
    "lbfgs_epilogue_reference",
]


# ---------------------------------------------------------------------------
# Prologue: push + two-loop + descent fallback + line-search set-up
# ---------------------------------------------------------------------------


def lbfgs_prologue_reference(
    x, gradient, s_memory, y_memory, mem_count, gamma, s_new, y_new, valid,
    done,
):
    """The prologue in plain PyTorch; see :func:`lbfgs_prologue`."""
    live = ~done

    # The push is a no-op for a done lane.
    s_mem, y_mem, count, new_gamma = push_history(
        s_memory, y_memory, mem_count, gamma, s_new, y_new, valid & live
    )
    d = two_loop_direction_reference(gradient, s_mem, y_mem, count,
                                     new_gamma)
    ls_dir, alpha_init, dginit, invalid = search_direction(
        x, gradient, d, count)
    # Invalid descent resets the history (lbfgs.h:214-224).
    count = torch.where(invalid & live, torch.zeros_like(count), count)

    ls_dir = torch.where(live[:, None], ls_dir, torch.zeros_like(ls_dir))
    alpha_init = torch.where(live, alpha_init, torch.ones_like(gamma))
    dginit = torch.where(live, dginit, torch.zeros_like(gamma))
    s_memory.copy_(s_mem)
    y_memory.copy_(y_mem)
    mem_count.copy_(count)
    gamma.copy_(new_gamma)
    return ls_dir, alpha_init, dginit, s_memory, y_memory, mem_count, gamma


def lbfgs_prologue(
    x, gradient, s_memory, y_memory, mem_count, gamma, s_new, y_new, valid,
    done,
):
    """The first half of an L-BFGS iteration for every lane of a batch.

    ``x``, ``gradient`` and the pending pair ``s_new``, ``y_new`` are
    ``(B, n)``; the history ``s_memory``, ``y_memory`` is ``(B, m, n)``
    chronological; ``mem_count`` (int32), ``gamma``, ``valid`` and ``done``
    (bool) are ``(B,)``.  The history, ``mem_count`` and ``gamma`` are
    updated in place.  Returns ``(ls_dir, alpha_init, dginit, s_memory,
    y_memory, mem_count, gamma)``: the ready-to-search direction (the
    reference searches along ``-d``, lbfgs.h:226-232), the first step, and
    ``dginit == gradient . ls_dir``; the last four are the tensors given.

    CPU tensors run :func:`lbfgs_prologue_reference`; CUDA tensors launch
    the kernel of ``csrc/lbfgs_prologue.cu`` on the current stream, or
    raise.  ``lbfgs_prologue.launches`` counts kernel launches."""
    b, m, n = s_memory.shape
    dtype = gradient.dtype
    check_float("lbfgs_prologue", dtype)
    dev = check_args("lbfgs_prologue", {
        "x": (x, (b, n), dtype), "gradient": (gradient, (b, n), dtype),
        "s_memory": (s_memory, (b, m, n), dtype),
        "y_memory": (y_memory, (b, m, n), dtype),
        "mem_count": (mem_count, (b,), torch.int32),
        "gamma": (gamma, (b,), dtype),
        "s_new": (s_new, (b, n), dtype), "y_new": (y_new, (b, n), dtype),
        "valid": (valid, (b,), torch.bool), "done": (done, (b,), torch.bool),
    })
    if dev.type == "cpu" or b == 0:
        return lbfgs_prologue_reference(
            x, gradient, s_memory, y_memory, mem_count, gamma, s_new, y_new,
            valid, done,
        )
    mapping = lane_mapping("lbfgs_prologue", b, n, m, x.element_size())
    ls_dir = torch.empty_like(gradient)
    alpha_init = torch.empty_like(gamma)
    dginit = torch.empty_like(gamma)
    launch(
        "lbfgs_prologue", dev, dtype,
        (x, gradient, s_new, y_new, valid, done, s_memory, y_memory,
         mem_count, gamma, ls_dir, alpha_init, dginit),
        (b, n, m, *mapping.scalars()),
    )
    lbfgs_prologue.launches += 1
    return ls_dir, alpha_init, dginit, s_memory, y_memory, mem_count, gamma


lbfgs_prologue.launches = 0


# ---------------------------------------------------------------------------
# Epilogue: non-finite guard + s/y formation + stall reset + Progress::Update
# ---------------------------------------------------------------------------


def _assign(dst, src) -> None:
    """Copy every tensor field of the record ``src`` into ``dst``'s."""
    for name, value in vars(src).items():
        getattr(dst, name).copy_(value)


def lbfgs_epilogue_reference(
    state: FunctionState, x_ls, f_ls, g_ls, ls_nfev, mem_count, s_pend,
    y_pend, pvalid, done, progress: ProgressState, crit: StoppingCriteria,
):
    """The epilogue in plain PyTorch; see :func:`lbfgs_epilogue`.  It is the
    generic composition: finite-guard select, s/y differences, stall reset,
    :func:`~..core.progress.update_progress`, and the freeze of done
    lanes."""
    finite = torch.isfinite(f_ls)
    take = finite & ~done
    x1 = torch.where(take[:, None], x_ls, state.x)
    f1 = torch.where(take, f_ls, state.value)
    g1 = torch.where(take[:, None], g_ls, state.gradient)
    nfev1 = torch.where(done, state.nfev, state.nfev + ls_nfev)
    new_state = FunctionState(x=x1, value=f1, gradient=g1, nfev=nfev1)

    s = x1 - state.x
    y = g1 - state.gradient
    # Stall recovery: clearing the history makes the next step steepest
    # descent with a fresh step length.
    stalled = torch.amax(torch.abs(s), dim=-1) <= 0.0
    count1 = torch.where(stalled & ~done, torch.zeros_like(mem_count),
                         mem_count)

    new_progress = update_progress(progress, state, new_state, crit,
                                   mode="first")
    # The Hessian-condition figure is not produced on this path: the carried
    # value passes through.
    new_progress.condition_hessian = progress.condition_hessian
    new_progress = tree_where(done, progress, new_progress)

    s_pend.copy_(torch.where(done[:, None], s_pend, s))
    y_pend.copy_(torch.where(done[:, None], y_pend, y))
    pvalid.copy_(torch.where(done, pvalid, finite))
    mem_count.copy_(count1)
    _assign(state, new_state)
    _assign(progress, new_progress)
    return state, s_pend, y_pend, pvalid, mem_count, progress


def lbfgs_epilogue(
    state: FunctionState, x_ls, f_ls, g_ls, ls_nfev, mem_count, s_pend,
    y_pend, pvalid, done, progress: ProgressState, crit: StoppingCriteria,
):
    """The second half of an L-BFGS iteration for every lane of a batch.

    ``state`` is the batched iterate the search started from; ``x_ls``,
    ``f_ls``, ``g_ls``, ``ls_nfev`` the search's result; ``mem_count`` the
    history count after the prologue; ``s_pend``, ``y_pend`` ``(B, n)`` and
    ``pvalid`` ``(B,)`` bool the pending pair's buffers.  ``state``,
    ``mem_count``, the pending pair and ``progress`` are updated in place;
    a ``done`` lane keeps every bit.  Returns ``(state, s_pend, y_pend,
    pvalid, mem_count, progress)``, the objects given.

    CPU tensors run :func:`lbfgs_epilogue_reference`; CUDA tensors launch
    the kernel of ``csrc/lbfgs_epilogue.cu`` on the current stream with
    the lanes mapped by :func:`~._kernel.lane_mapping`, or raise.
    ``lbfgs_epilogue.launches`` counts kernel launches."""
    b, n = state.x.shape
    dtype = state.x.dtype
    i32 = torch.int32
    pr = progress
    check_float("lbfgs_epilogue", dtype)
    dev = check_args("lbfgs_epilogue", {
        "state.x": (state.x, (b, n), dtype),
        "state.value": (state.value, (b,), dtype),
        "state.gradient": (state.gradient, (b, n), dtype),
        "state.nfev": (state.nfev, (b,), i32),
        "x_ls": (x_ls, (b, n), dtype), "f_ls": (f_ls, (b,), dtype),
        "g_ls": (g_ls, (b, n), dtype), "ls_nfev": (ls_nfev, (b,), i32),
        "mem_count": (mem_count, (b,), i32),
        "s_pend": (s_pend, (b, n), dtype), "y_pend": (y_pend, (b, n), dtype),
        "pvalid": (pvalid, (b,), torch.bool), "done": (done, (b,), torch.bool),
        "num_iterations": (pr.num_iterations, (b,), i32),
        "x_delta": (pr.x_delta, (b,), dtype),
        "x_delta_violations": (pr.x_delta_violations, (b,), i32),
        "f_delta": (pr.f_delta, (b,), dtype),
        "f_delta_violations": (pr.f_delta_violations, (b,), i32),
        "gradient_norm": (pr.gradient_norm, (b,), dtype),
        "status": (pr.status, (b,), i32),
        "past_ring": (pr.past_ring, (b, PAST_RING_SIZE), dtype),
        "past_pos": (pr.past_pos, (b,), i32),
    })
    if dev.type == "cpu" or b == 0:
        return lbfgs_epilogue_reference(
            state, x_ls, f_ls, g_ls, ls_nfev, mem_count, s_pend, y_pend,
            pvalid, done, progress, crit,
        )
    mapping = lane_mapping("lbfgs_epilogue", b, n, 0, state.x.element_size())
    launch(
        "lbfgs_epilogue", dev, dtype,
        (state.x, state.value, state.gradient, state.nfev, x_ls, f_ls, g_ls,
         ls_nfev, mem_count, s_pend, y_pend, pvalid, done,
         pr.num_iterations, pr.x_delta, pr.x_delta_violations, pr.f_delta,
         pr.f_delta_violations, pr.gradient_norm, pr.status, pr.past_ring,
         pr.past_pos),
        (b, n, mapping.lanes_per_block, mapping.threads_per_lane,
         mapping.cluster, *crit_scalars(crit)),
    )
    lbfgs_epilogue.launches += 1
    return state, s_pend, y_pend, pvalid, mem_count, progress


lbfgs_epilogue.launches = 0
