"""Small utilities over the port's dataclasses of tensors.

PyTorch counterpart of ``cppnumericalsolvers_tpu/core/tree.py``.  The port's
records (``FunctionState``, ``ProgressState``, ``LbfgsInternals``, ...) are
dataclasses whose fields are tensors, other such dataclasses, or plain
Python values; these helpers walk them as ``jax.tree.map`` walks a pytree.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

__all__ = [
    "any_lane",
    "lane_amax",
    "lane_sum",
    "masked_while",
    "model_axis_group",
    "tree_map",
    "tree_where",
]

#: The process group over which a lane's n-vector is sharded, set only by
#: ``parallel.minimize_model_sharded`` through :func:`model_axis_group`;
#: None everywhere else.
_MODEL_GROUP = None


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every tensor leaf of ``tree`` (and the matching
    leaves of ``rest``); tuples and dataclasses are walked, anything else
    passes through from ``tree``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if type(tree) is tuple:
        return tuple(tree_map(fn, t, *r) for t, *r in zip(tree, *rest))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: tree_map(
                fn, getattr(tree, f.name),
                *(getattr(r, f.name) for r in rest),
            )
            for f in dataclasses.fields(tree)
        })
    return tree


def tree_where(pred, if_true, if_false):
    """Leafwise ``where(pred, a, b)`` with one predicate entry per lane:
    ``pred`` has the leaves' leading (batch) shape and broadcasts over their
    trailing dimensions.  It is how finished lanes of a batch are frozen."""

    def pick(a, b):
        p = pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim()))
        return torch.where(p, a, b)

    return tree_map(pick, if_true, if_false)


def any_lane(mask: torch.Tensor) -> bool:
    """Whether any lane of ``mask`` is set: the predicate of a loop at batch
    level, and one device-to-host read.  ``any_lane.reads`` counts them."""
    any_lane.reads += 1
    return bool(mask.any())


any_lane.reads = 0


def masked_while(cond, body, carry, live):
    """A ``lax.while_loop`` as ``vmap`` runs it, at batch level over the
    lanes of ``live`` ``(B,)``: ``body(carry, active)`` runs while any live
    lane's ``cond(carry)`` holds (one device-to-host read a pass), and a lane
    whose ``cond`` is false keeps its carry, by ``torch.where``, so what the
    body computes for it (a NaN or an inf included) never reaches it.
    ``active`` tells the body which lanes it runs for, e.g. to restrict a
    loop nested in it."""
    while True:
        active = live & cond(carry)
        if not any_lane(active):
            return carry
        carry = tree_where(active, body(carry, active), carry)


@contextlib.contextmanager
def model_axis_group(group):
    """Within this context every lane's n-vector is sharded over the ranks
    of ``group`` (a ``torch.distributed`` process group): :func:`lane_sum`
    and :func:`lane_amax` follow their local reduction with an
    ``all_reduce`` over it, and the More-Thuente search takes its plain
    trip, whose directional derivative is a :func:`lane_sum` (the
    ``mt_trip`` kernel reduces over the local shard only)."""
    global _MODEL_GROUP
    outer, _MODEL_GROUP = _MODEL_GROUP, group
    try:
        yield
    finally:
        _MODEL_GROUP = outer


def model_group():
    """The process group of the enclosing :func:`model_axis_group`, or
    None."""
    return _MODEL_GROUP


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """``torch.sum(x, -1)``: a per-lane sum over the n axis (a dot product
    is ``lane_sum(a * b)``).  Inside :func:`model_axis_group` the local sums
    are then summed over the group by one ``all_reduce``."""
    s = torch.sum(x, dim=-1)
    if _MODEL_GROUP is not None:
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=_MODEL_GROUP)
    return s


def lane_amax(x: torch.Tensor) -> torch.Tensor:
    """``torch.amax(x, -1)`` of non-negative values ``x`` (magnitudes): a
    per-lane infinity norm over the n axis.  Inside
    :func:`model_axis_group` the local maxima (0 on a rank whose shard is
    empty) are then maximised over the group by one ``all_reduce``."""
    if _MODEL_GROUP is None:
        return torch.amax(x, dim=-1)
    s = (torch.amax(x, dim=-1) if x.shape[-1]
         else x.new_zeros(x.shape[:-1]))
    dist.all_reduce(s, op=dist.ReduceOp.MAX, group=_MODEL_GROUP)
    return s
