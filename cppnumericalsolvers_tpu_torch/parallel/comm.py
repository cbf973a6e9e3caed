"""Collectives of the multi-device solves, and a log of them.

The sharded solves call ``torch.distributed`` in two places only:
``core.tree``'s collectives inside the model-sharded loop (the lane
reductions, an ``all_reduce`` of one scalar per lane, and the gathers and
sums of whole n-vectors that the dense solvers make) and the gathers here,
which assemble a full result on every rank once a solve has ended.  :class:`CollectiveLog`
records every collective a block of code issues, those that DTensor issues
for the objective included, so a caller can count what runs inside a loop.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.driver import MinimizeResult, resolve_device
from ..core.tree import all_gather_cat, any_lane, shard_sizes, tree_map

__all__ = [
    "CollectiveLog",
    "all_gather_cat",
    "gather_lanes",
    "max_over",
    "rank_device",
    "shard_sizes",
]


def rank_device(device=None) -> torch.device:
    """The device this rank solves on: ``device`` as given, else
    ``cuda:{LOCAL_RANK}`` (the launcher's variable; without it the global
    rank modulo the number of cards).  Raises without a GPU."""
    if device is not None:
        return resolve_device(device)
    resolve_device("cuda")
    count = torch.cuda.device_count()
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % count))
    if local >= count:
        raise RuntimeError(
            f"LOCAL_RANK {local} has no card: {count} visible; pass device="
        )
    return torch.device("cuda", local)


def max_over(value: int, group, device) -> int:
    """The largest ``value`` over the ranks of ``group``: one
    ``all_reduce``."""
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())


def gather_lanes(res: MinimizeResult, group, batch: int | None = None
                 ) -> MinimizeResult:
    """A result whose every tensor leaf holds the lanes of all ranks of
    ``group`` (one ``all_gather`` a leaf, along the batch axis), cut to the
    first ``batch`` lanes where given; ``trips`` is the largest over the
    ranks (each rank's loop ran its own number of trips)."""

    def gather(t):
        out = all_gather_cat(t, group, 0)
        return out if batch is None else out[:batch]

    return MinimizeResult(
        state=tree_map(gather, res.state),
        progress=tree_map(gather, res.progress),
        internals=tree_map(gather, res.internals),
        trips=max_over(res.trips, group, res.state.x.device),
        trace=tree_map(gather, res.trace),
    )


_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


def _kind(name: str) -> str:
    flat = name.replace("_", "")
    if "allreduce" in flat:
        return "all_reduce"
    if "allgather" in flat:
        return "all_gather"
    return name.strip("_")


def _first_tensor(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a
        if isinstance(a, (list, tuple)):
            t = _first_tensor(a)
            if t is not None:
                return t
    return None


class CollectiveLog(TorchDispatchMode):
    """Records every collective issued inside it, as ``entries``: dicts of
    ``kind`` ("all_reduce", "all_gather", or the op's name), ``numel`` (the
    elements of one rank's input) and ``reads`` (``core.tree.any_lane.reads``
    when it ran, which places it in the loop: a collective issued after a
    loop's last predicate read shows that read's count).  The collectives
    DTensor issues while it evaluates the objective are seen too.  Every
    operation inside passes through Python, which slows a solve; time a
    solve without it."""

    def __init__(self):
        super().__init__()
        self.entries: list[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            # Let DTensor lower the operation; its collectives come back
            # through this mode.
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        name = func.name()
        ns, _, op = name.partition("::")
        op = op.split(".")[0]
        if ns in _COLLECTIVE_NAMESPACES and op not in _NOT_COLLECTIVES:
            t = _first_tensor(args)
            self.entries.append({
                "kind": _kind(op),
                "numel": None if t is None else t.numel(),
                "reads": any_lane.reads,
            })
        return out

    def kinds(self, entries=None) -> dict:
        """Counts by ``(kind, numel)`` of ``entries`` (default: all)."""
        counts: dict = {}
        for e in self.entries if entries is None else entries:
            key = (e["kind"], e["numel"])
            counts[key] = counts.get(key, 0) + 1
        return counts
