"""Small utilities over the port's dataclasses of tensors.

PyTorch counterpart of ``cppnumericalsolvers_tpu/core/tree.py``.  The port's
records (``FunctionState``, ``ProgressState``, ``LbfgsInternals``, ...) are
dataclasses whose fields are tensors, other such dataclasses, or plain
Python values; these helpers walk them as ``jax.tree.map`` walks a pytree.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["any_lane", "masked_while", "tree_map", "tree_where"]


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
