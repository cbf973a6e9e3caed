"""Carry the JAX package's results across into the port's objects.

The JAX package hands its results over as numpy arrays (``np.asarray`` of
each field); nothing here imports JAX.  :func:`from_jax_numpy` dispatches on
the field names of what it is given:

* ``StoppingCriteria`` fields -> the port's :class:`StoppingCriteria`;
* ``ProgressState``, ``FunctionState`` and ``IterationTrace`` fields -> the
  port's records of the same names;
* ``LbfgsInternals`` fields (the history chronological, ``(m, n)`` or
  batch-major ``(B, m, n)``, with the pending pair) -> the port's
  :class:`LbfgsInternals`, which has the same layout;
* the flat solve's internals (``s_memory_t``, ``y_memory_t`` in the
  batch-minor ``(m * n8, B_pad)`` layout of ``ops/fused_step_t.py``, plus
  ``mem_count`` and ``gamma``) -> the port's :class:`LbfgsInternals`, with
  the history chronological and batch-major ``(B, m, n)`` and no pending
  pair;
* the internals of the other unconstrained solvers (``BfgsInternals``,
  ``CgInternals``, ``NewtonInternals``, ``TrInternals``, ``NmInternals``,
  per instance or with a leading batch axis) -> the port's records of the
  same names, and gradient descent's empty internals ``()`` -> ``()``;
* a whole ``LbfgsInternalsT`` (those four fields and the pending pair) ->
  the port's :class:`LbfgsInternalsT`: the history batch-minor
  ``(m * n, B)`` with the JAX package's padding (``n8``, ``B_pad``)
  stripped, the pending pair carried over, the ring at head 0 (JAX's
  history is chronological);
* ``LbfgsbInternals`` (per instance or with a leading batch axis) -> the
  port's :class:`LbfgsbInternals`;
* ``MultiplierState``, ``AugmentedLagrangeState`` (its multipliers
  converted as above) and a whole ``AlResult`` (``state``, ``progress``) ->
  the port's records of the same names;
* a whole ``MinimizeResult`` (``state``, ``progress``, ``internals``,
  ``trace``, each converted as above) -> the port's
  :class:`MinimizeResult`, which :func:`~.core.driver.resume` continues.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.callbacks import IterationTrace
from .core.driver import MinimizeResult
from .core.objective import FunctionState
from .core.penalty import MultiplierState
from .core.progress import ProgressState, StoppingCriteria
from .solvers.augmented_lagrangian import AlResult, AugmentedLagrangeState
from .solvers.bfgs import BfgsInternals
from .solvers.conjugate_gradient import CgInternals
from .solvers.lbfgs import LbfgsInternals, LbfgsInternalsT
from .solvers.lbfgsb import LbfgsbInternals
from .solvers.nelder_mead import NmInternals
from .solvers.newton import NewtonInternals
from .solvers.trust_region import TrInternals

__all__ = ["from_jax_numpy", "history_t_to_rows"]

_INT32_FIELDS = frozenset({
    "nfev", "mem_count", "status", "num_iterations", "x_delta_violations",
    "f_delta_violations", "past_pos", "iteration", "count",
})
_RECORDS = (ProgressState, FunctionState, IterationTrace, LbfgsInternals,
            BfgsInternals, CgInternals, NewtonInternals, TrInternals,
            NmInternals, LbfgsbInternals, MultiplierState,
            AugmentedLagrangeState)


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

    ``obj`` is a NamedTuple or dict of numpy arrays (or scalars), possibly
    nested (a whole result).  For the flat solve's internals pass ``n`` and
    ``m``; the batch size comes from ``mem_count``.
    """
    if isinstance(obj, tuple) and not obj:
        return ()
    fields = _fields(obj)
    names = set(fields)
    crit_names = {f.name for f in dataclasses.fields(StoppingCriteria)}

    def tensor(v, name=None):
        a = np.array(v)
        if name in _INT32_FIELDS:
            a = a.astype(np.int32)
        return torch.as_tensor(a, device=device)

    def sub(v):
        return None if v is None else from_jax_numpy(
            v, n=n, m=m, device=device)

    if names == crit_names:
        return StoppingCriteria(**{k: _scalar(v) for k, v in fields.items()})
    if names == {"state", "progress", "internals", "trace"}:
        return MinimizeResult(
            state=sub(fields["state"]), progress=sub(fields["progress"]),
            internals=sub(fields["internals"]), trace=sub(fields["trace"]),
        )
    if names == {"state", "progress"}:
        return AlResult(state=sub(fields["state"]),
                        progress=sub(fields["progress"]))
    for cls in _RECORDS:
        if names == {f.name for f in dataclasses.fields(cls)}:
            return cls(**{
                k: (sub(v) if isinstance(v, dict) or hasattr(v, "_asdict")
                    else tensor(v, k))
                for k, v in fields.items()})
    if {"s_memory_t", "y_memory_t", "mem_count", "gamma"} <= names:
        if n is None or m is None:
            raise ValueError("converting a transposed history needs n and m")
        count = np.asarray(fields["mem_count"])
        b = count.shape[0]
        gamma = tensor(fields["gamma"])
        if "s_pending" in names:
            def strip(hist_t):
                rows = history_t_to_rows(hist_t, b, m, n)
                return tensor(rows.reshape(b, m * n).T)

            return LbfgsInternalsT(
                s_memory_t=strip(fields["s_memory_t"]),
                y_memory_t=strip(fields["y_memory_t"]),
                mem_count=tensor(count, "mem_count"), gamma=gamma,
                s_pending=tensor(fields["s_pending"]),
                y_pending=tensor(fields["y_pending"]),
                pending_valid=tensor(fields["pending_valid"]),
                head=torch.zeros((b,), dtype=torch.int32, device=device),
            )
        return LbfgsInternals(
            s_memory=tensor(history_t_to_rows(fields["s_memory_t"], b, m, n)),
            y_memory=tensor(history_t_to_rows(fields["y_memory_t"], b, m, n)),
            mem_count=tensor(count, "mem_count"),
            gamma=gamma,
            s_pending=torch.zeros((b, n), dtype=gamma.dtype, device=device),
            y_pending=torch.zeros((b, n), dtype=gamma.dtype, device=device),
            pending_valid=torch.zeros((b,), dtype=torch.bool, device=device),
        )
    raise ValueError(f"unrecognised fields: {sorted(names)}")
