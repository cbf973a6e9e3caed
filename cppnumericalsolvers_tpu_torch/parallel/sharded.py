"""Batched solving with the instance batch split over ranks.

PyTorch counterpart of ``cppnumericalsolvers_tpu/parallel/sharded.py``, on
``torch.distributed``: every rank is one process on one card (NCCL there;
gloo on the CPU), and every rank calls the same function with the same
global ``(B, n)`` batch, as every JAX process holds the same global array.

* Each rank of the mesh takes its contiguous block of ``B / size`` lanes
  (what ``P("batch")`` gives a device) and solves it with the batched
  driver on its own card: a fresh L-BFGS solve runs the flat solve and its
  ``flat_trip`` kernel, ``Lbfgs(two_loop_impl="xla")`` the plain versions,
  each solver what it runs in ``minimize_batched``.
* There is no collective inside the loop: each rank's loop ends when its
  own lanes are done, as each device's loop does under ``shard_map``.
* At the end one ``all_gather`` a result leaf gives every rank the whole
  result (rank order is lane order).  ``MinimizeResult.trips``, which the
  JAX package does not have, is the largest over the ranks.
* Multi-host: ``initialize_distributed`` (``init_process_group``), then the
  mesh spans every rank of the job.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.driver import MinimizeResult, SolverBase, _solve_batched
from ..core.objective import Objective
from ..core.progress import StoppingCriteria
from ..core.status import CONVERGED_STATUSES
from .comm import gather_lanes, rank_device

__all__ = [
    "make_mesh",
    "minimize_sharded",
    "aggregate_metrics",
    "initialize_distributed",
]


def make_mesh(n_devices: int | None = None, axis: str = "batch",
              device=None) -> DeviceMesh:
    """A 1-D device mesh named ``axis`` over ranks ``0 .. n_devices - 1``
    of the default process group (default: all of them).  Its device type
    is ``"cuda"``, or that of ``device`` (``"cpu"`` for gloo on the CPU).

    Every rank calls it, since it creates the mesh's process group.  A mesh
    smaller than the world is the counterpart of the JAX package's submesh:
    the sharded solves run on its ranks only, and a rank outside it gets
    ``None`` back from them."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"n_devices must be in [1, {world}], got {n}")
    kind = "cuda" if device is None else torch.device(device).type
    return DeviceMesh(kind, list(range(n)), mesh_dim_names=(axis,))


def initialize_distributed(**kwargs) -> None:
    """Multi-host entry point: ``torch.distributed.init_process_group``
    passthrough (``backend``, ``init_method`` or ``store``, ``world_size``,
    ``rank``, ...).  Where there is a GPU it also makes card ``LOCAL_RANK``
    (0 without the variable) this process's current device."""
    dist.init_process_group(**kwargs)
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))


def minimize_sharded(
    objective: Objective,
    x0_batch,
    solver: SolverBase,
    stopping: StoppingCriteria | None = None,
    mesh: DeviceMesh | None = None,
    axis: str = "batch",
    device=None,
) -> MinimizeResult | None:
    """Solve a batch of instances split over the ranks of a mesh.

    ``x0_batch`` is the global ``(B, n)``, the same on every rank, with B
    divisible by the mesh size.  Each rank solves its block of lanes on
    ``device`` (default ``cuda:{LOCAL_RANK}``, see
    :func:`~.comm.rank_device`) with no communication, then every rank
    gets the whole result, each leaf with its leading batch axis (see the
    module docstring).  A rank outside ``mesh`` returns None."""
    solver.check_mode(objective)
    device = rank_device(device)
    x0 = torch.as_tensor(x0_batch)
    if not x0.is_floating_point():
        x0 = x0.to(torch.float64)
    if x0.dim() != 2:
        raise ValueError(f"x0_batch must be (B, n), got {tuple(x0.shape)}")
    if mesh is None:
        mesh = make_mesh(axis=axis, device=device)
    size = mesh.size()
    if x0.shape[0] % size:
        raise ValueError(
            f"batch size {x0.shape[0]} not divisible by mesh size "
            f"{size}; pad the batch (converged padding lanes are free)."
        )
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    lanes = x0.shape[0] // size
    local = x0[coord[0] * lanes:(coord[0] + 1) * lanes].to(device)
    res = _solve_batched(objective, local, solver, stopping, 0, None, None,
                         device)
    return gather_lanes(res, mesh.get_group())


def aggregate_metrics(result: MinimizeResult) -> dict[str, float]:
    """Batch-level metrics of a (gathered) batched result: converged %,
    mean nfev, mean iterations and the number of instances, computed on the
    result's tensors (no collective)."""
    status = result.progress.status
    converged = torch.isin(
        status, torch.tensor(CONVERGED_STATUSES, dtype=status.dtype,
                             device=status.device))
    return {
        "converged_pct": 100.0 * float(converged.double().mean()),
        "mean_nfev": float(result.state.nfev.double().mean()),
        "mean_iterations": float(
            result.progress.num_iterations.double().mean()),
        "total_instances": int(status.numel()),
    }
