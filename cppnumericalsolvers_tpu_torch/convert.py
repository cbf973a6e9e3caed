"""Carry the JAX package's results across into the port's objects.

The JAX package hands its results over as numpy arrays (``np.asarray`` of
each field); nothing here imports JAX.  :func:`from_jax_numpy` dispatches on
the field names of what it is given:

* ``StoppingCriteria`` fields -> the port's :class:`StoppingCriteria`;
* ``ProgressState`` fields -> the port's :class:`ProgressState`;
* the flat solve's internals (``s_memory_t``, ``y_memory_t`` in the
  batch-minor ``(m * n8, B_pad)`` layout of ``ops/fused_step_t.py``, plus
  ``mem_count`` and ``gamma``) -> the port's :class:`LbfgsInternals`, with
  the history chronological and batch-major ``(B, m, n)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.progress import ProgressState, StoppingCriteria
from .solvers.lbfgs import LbfgsInternals

__all__ = ["from_jax_numpy", "history_t_to_rows"]


def _fields(obj) -> dict:
    if isinstance(obj, dict):
        return dict(obj)
    if hasattr(obj, "_asdict"):
        return dict(obj._asdict())
    raise TypeError(f"expected a NamedTuple or a dict, got {type(obj)}")


def _scalar(v):
    a = np.asarray(v)
    if a.shape != ():
        raise ValueError(f"expected a scalar, got shape {a.shape}")
    return a.item()


def history_t_to_rows(hist_t, b: int, m: int, n: int) -> np.ndarray:
    """``(m * n8, B_pad)`` batch-minor history -> ``(B, m, n)``."""
    hist_t = np.asarray(hist_t)
    n8 = hist_t.shape[0] // m
    return hist_t[:, :b].T.reshape(b, m, n8)[:, :, :n]


def from_jax_numpy(obj, *, n: int | None = None, m: int | None = None,
                   device="cpu"):
    """Convert a JAX-package result given as numpy arrays.

    ``obj`` is a NamedTuple or dict of numpy arrays (or scalars).  For the
    flat solve's internals pass ``n`` and ``m``; the batch size comes from
    ``mem_count``.
    """
    fields = _fields(obj)
    names = set(fields)
    crit_names = {f.name for f in dataclasses.fields(StoppingCriteria)}
    prog_names = {f.name for f in dataclasses.fields(ProgressState)}

    def tensor(v):
        return torch.as_tensor(np.array(v), device=device)

    if names == crit_names:
        return StoppingCriteria(**{k: _scalar(v) for k, v in fields.items()})
    if names == prog_names:
        return ProgressState(**{k: tensor(v) for k, v in fields.items()})
    if {"s_memory_t", "y_memory_t", "mem_count", "gamma"} <= names:
        if n is None or m is None:
            raise ValueError("converting a transposed history needs n and m")
        count = np.asarray(fields["mem_count"])
        b = count.shape[0]
        return LbfgsInternals(
            s_memory=tensor(history_t_to_rows(fields["s_memory_t"], b, m, n)),
            y_memory=tensor(history_t_to_rows(fields["y_memory_t"], b, m, n)),
            mem_count=tensor(count.astype(np.int32)),
            gamma=tensor(fields["gamma"]),
        )
    raise ValueError(f"unrecognised fields: {sorted(names)}")
