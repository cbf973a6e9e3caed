"""Small utilities over the port's dataclasses of tensors.

PyTorch counterpart of ``cppnumericalsolvers_tpu/core/tree.py``.  The port's
records (``FunctionState``, ``ProgressState``, ``LbfgsInternals``, ...) are
dataclasses whose fields are tensors, other such dataclasses, or plain
Python values; these helpers walk them as ``jax.tree.map`` walks a pytree.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["tree_map", "tree_where"]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every tensor leaf of ``tree`` (and the matching
    leaves of ``rest``); anything else passes through from ``tree``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
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
