"""Intra-problem ("model"-axis) sharding for large n.

PyTorch counterpart of ``cppnumericalsolvers_tpu/parallel/model_sharded.py``.
Where one instance's n is too large for one card, or its per-iteration
linear algebra should ride more than one card's memory bandwidth, the
parameter vector itself is split over the ranks of a mesh axis.  GSPMD
partitions the JAX solve by itself; here the two halves of a solve are
sharded in two ways:

* **The objective** is evaluated as written, on the full logical shape:
  each rank's shard of x becomes a ``DTensor`` placed ``Shard(-1)`` on the
  model mesh, and the port's ``vmap(grad_and_value(fn))`` runs on it.  The
  value comes back ``Replicate``d (one ``all_reduce`` of B scalars); the
  gradient is redistributed to ``Shard(-1)`` and each rank keeps its shard.
  Operations DTensor can shard stay sharded (elementwise, reductions,
  ``x.view(-1, 2)`` where every shard splits into whole pairs); where it
  cannot it all-gathers, as GSPMD does (strided slices such as
  ``x[0::2]``).  A constant tensor of length n is either a plain tensor,
  which DTensor takes as replicated (``implicit_replication``: each rank
  uses its slice, no collective), or a DTensor on the same mesh, e.g.
  ``distribute_tensor(c, mesh, [Shard(0)])``.
* **Second derivatives.**  DTensor cannot carry ``torch.func.jvp``, on
  which ``hessian`` rests too, so these are evaluated replicated on the
  gathered x, as GSPMD does where it cannot partition: the Hessian as each
  rank's *columns*, ``(B, n, n_local)``, one ``jvp`` of the gradient along
  each of its coordinates (the columns ``torch.func.hessian`` forms, bit
  for bit, with the work split over the ranks; one ``all_gather`` of x);
  a Hessian-vector product whole from the gathered x and v (one
  ``all_gather``), cut to the shard.  The objective must then also accept
  a plain tensor: its constants plain, not DTensors.  Nfev is billed as
  the unsharded solve bills it.
* **The solver's reductions** are explicit: inside
  ``core.tree.model_axis_group`` every per-lane sum and infinity norm of
  the loop (the two-loop's and the searches' dot products, the stopping
  machine's norms) is the local reduction followed by one ``all_reduce``
  of B scalars.  x, the gradient and the ``(m, n)`` history stay sharded
  through the whole loop; every rank computes the same per-lane scalars,
  so their loops run the same trips.

Every solver runs; none launches a kernel (a kernel's reductions cover one
shard), as the JAX package's sharded solve runs no Pallas kernel:

* L-BFGS as ``Lbfgs(two_loop_impl="xla")`` (the push, the two-loop and the
  More-Thuente trips in plain PyTorch), forced here as the JAX package
  forces its pure-XLA lowering; with the Hessian-diagonal preconditioner
  each rank takes the diagonal of its Hessian columns.  Gradient descent
  and conjugate gradient run as they are, their searches' trips in plain
  PyTorch.
* L-BFGS-B runs as it is, its box sharded like x (a per-coordinate box of
  the config is cut to each rank's shard): every sum over n is
  all-reduced, and its generalized-Cauchy-point walk merges the ranks'
  sorted breakpoints, one pass at a time, in two collectives a pass (an
  ``all_gather`` of each rank's next breakpoint, an ``all_reduce`` of the
  crossed coordinate's 2m + 5 values;
  ``solvers.lbfgsb.generalized_cauchy_point``).
* BFGS holds each rank's rows of every inverse Hessian, ``(B, n_local,
  n)``: ``H g`` and ``H y`` are row-local products of the gathered
  vector; three ``all_gather``s of n-vectors an iteration (g; y and s;
  ``H y``) beside the scalar all-reduces.
* Newton gathers the Hessian's columns and the gradient (two
  ``all_gather``s an iteration: ``B n^2`` and ``B n`` values) and every
  rank solves the same dense system, as GSPMD replicates
  ``jnp.linalg.solve``, keeping its shard of the direction.
* The trust region: the dense form's product with the rank's Hessian
  columns is a partial sum of the whole vector, one ``all_reduce`` of
  ``B n`` values a CG step; the Hessian-free form keeps O(n / W) state a
  rank and gathers x and v for each product (one ``all_gather``).  The CG
  budget counts the global n.
* Nelder-Mead holds each rank's coordinates of every vertex, ``(B, n + 1,
  n_local)``, its distances maxima all-reduced (two ``all_reduce``s an
  iteration beside the evaluations').

Combine with the batch axis for a 2-D mesh: ``x0`` of shape ``(B, n)``
with ``batch_axis`` splits the lanes over that axis (contiguous blocks,
the last lane repeated to fill the last block where B does not divide) and
each lane's n over ``model_axis``.  Every rank gets the whole result.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.func import grad_and_value, jacrev, jvp, vmap

from ..core.driver import (
    MinimizeResult,
    SolverBase,
    _solve_batched,
    _unbatch_result,
)
from ..core.objective import MODE_FIRST, MODE_NONE, MODE_SECOND, Objective
from ..core.progress import StoppingCriteria
from ..core.tree import model_axis_group, model_cut, model_gather
from ..solvers.bfgs import BfgsInternals
from ..solvers.conjugate_gradient import CgInternals
from ..solvers.lbfgs import LbfgsInternals
from ..solvers.lbfgsb import Lbfgsb, LbfgsbInternals
from ..solvers.nelder_mead import NmInternals
from .comm import all_gather_cat, gather_lanes, rank_device, shard_sizes
from .sharded import make_mesh

__all__ = ["minimize_model_sharded"]


def _force_xla_two_loop(solver: SolverBase) -> SolverBase:
    """Pin the solver to its plain versions: a kernel's reductions cover
    one rank's shard, so the model-sharded solve takes the lowering whose
    reductions go through ``core.tree``'s lane reductions."""
    if hasattr(solver, "two_loop_impl"):
        return dataclasses.replace(solver, two_loop_impl="xla")
    return solver


#: Fields of a result's internals that are sharded along n, by type, with
#: the axis each is sharded on.
_ALONG_N = {
    LbfgsInternals: {"s_memory": -1, "y_memory": -1, "s_pending": -1,
                     "y_pending": -1},
    CgInternals: {"previous_gradient": -1, "direction": -1},
    LbfgsbInternals: {"s_history": -1, "y_history": -1, "lower": -1,
                      "upper": -1},
    BfgsInternals: {"inverse_hessian": -2},
    NmInternals: {"simplex": -1},
}


def _shard_box(solver: SolverBase, start: int, size: int) -> SolverBase:
    """``solver`` with a per-coordinate box of its config (a tuple of n
    floats) cut to this rank's shard ``start .. start + size``."""
    if not isinstance(solver, Lbfgsb):
        return solver
    cut = {name: getattr(solver, name)[start:start + size]
           for name in ("lower", "upper")
           if isinstance(getattr(solver, name), tuple)}
    return dataclasses.replace(solver, **cut) if cut else solver


@dataclasses.dataclass(frozen=True, eq=False)
class _ShardedObjective(Objective):
    """``fn`` evaluated on the local ``(B, n_local)`` shard of a global
    ``(B, n)`` batch sharded over ``mesh``; see the module docstring."""

    mesh: DeviceMesh | None = None
    n: int = 0

    def _global(self, x):
        from torch.distributed.tensor import DTensor, Shard

        b = x.shape[0]
        return DTensor.from_local(
            x, self.mesh, [Shard(1)], run_check=False,
            shape=torch.Size((b, self.n)), stride=(self.n, 1))

    def _value(self, v):
        from torch.distributed.tensor import DTensor, Replicate

        if isinstance(v, DTensor):
            v = v.redistribute(self.mesh, [Replicate()]).to_local()
        return v

    def _shard(self, g):
        from torch.distributed.tensor import Shard

        return g.redistribute(self.mesh, [Shard(1)]).to_local().contiguous()

    def batched_value_and_grad(self, x):
        from torch.distributed.tensor.experimental import implicit_replication

        xg = self._global(x)
        with implicit_replication():
            if self.mode == MODE_NONE:
                return self._value(vmap(self.fn)(xg)), torch.zeros_like(x)
            g, v = vmap(grad_and_value(self.fn))(xg)
        return self._value(v), self._shard(g)

    def batched_value(self, x):
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            return self._value(vmap(self.fn)(self._global(x)))

    @functools.cached_property
    def _whole(self) -> Objective:
        return Objective(self.fn, self.mode)

    def hessian(self, x):
        """This rank's columns of every lane's Hessian, ``(B, n,
        n_local)``: x gathered, then one ``jvp`` of the gradient along each
        of the rank's coordinates, as ``torch.func.hessian`` forms its
        columns (so the columns have its bits)."""
        self._require(MODE_SECOND, "hessian")
        whole = model_gather(x)
        n = whole.shape[-1]
        basis = model_cut(torch.eye(n, dtype=x.dtype, device=x.device), 0)
        if not basis.shape[0]:
            return whole.new_zeros((*whole.shape, 0))
        jac = jacrev(self.fn)

        def columns(xl):
            return vmap(lambda e: jvp(jac, (xl,), (e,))[1])(basis).movedim(
                0, -1)

        return vmap(columns)(whole)

    def hvp(self, x, v):
        """This rank's shard of every lane's ``H(x) v``: x and v gathered
        (one ``all_gather``), the product formed whole as
        ``Objective.hvp`` forms it, then cut to the shard."""
        self._require(MODE_FIRST, "hvp")
        x, v = model_gather(torch.stack([x, v]))
        return model_cut(self._whole.hvp(x, v))

    def _unsupported(self, *args):
        # The un-batched calls would evaluate fn on one rank's shard alone.
        raise ValueError("the model-sharded solve evaluates batched values, "
                         "gradients, Hessians and their products only")

    value = value_and_grad = gradient = _unsupported


def minimize_model_sharded(
    objective: Objective,
    x0,
    solver: SolverBase,
    stopping: StoppingCriteria | None = None,
    *,
    mesh: DeviceMesh | None = None,
    model_axis: str = "model",
    batch_axis: str | None = None,
    trace: int = 0,
    device=None,
) -> MinimizeResult:
    """Solve with the parameter vector sharded over a mesh axis.

    ``x0`` is ``(n,)``, or ``(B, n)`` when ``batch_axis`` is given, in
    which case the batch is split over ``batch_axis`` and each instance's n
    over ``model_axis`` (a 2-D mesh).  Every rank passes the same global
    ``x0`` and gets the whole result back.  n need not be divisible by the
    axis size: shards follow DTensor's split (:func:`~.comm.shard_sizes`),
    though even shards keep the ranks balanced, and the objective must be
    one DTensor can evaluate on them.  ``device`` is this rank's (default
    ``cuda:{LOCAL_RANK}``); ``mesh`` defaults to all ranks on one
    ``model_axis``."""
    solver.check_mode(objective)
    solver = _force_xla_two_loop(solver)
    device = rank_device(device)
    x0 = torch.as_tensor(x0)
    if not x0.is_floating_point():
        x0 = x0.to(torch.float64)
    if batch_axis is None:
        if x0.dim() != 1:
            raise ValueError(
                f"x0 must be (n,) without batch_axis, got {tuple(x0.shape)}"
            )
    elif x0.dim() != 2:
        raise ValueError(
            f"x0 must be (B, n) with batch_axis, got {tuple(x0.shape)}"
        )
    if mesh is None:
        mesh = make_mesh(axis=model_axis, device=device)

    xb = x0[None] if batch_axis is None else x0
    b, n = xb.shape
    model_mesh = mesh[model_axis] if mesh.ndim > 1 else mesh
    model_group = mesh.get_group(model_axis)
    sizes = shard_sizes(n, model_mesh.size())
    col = mesh.get_local_rank(model_axis)
    start = sum(sizes[:col])
    if batch_axis is not None:
        parts = mesh[batch_axis].size()
        lanes = -(-b // parts)
        pad = lanes * parts - b
        if pad:
            xb = torch.cat([xb, xb[-1:].expand(pad, n)])
        row = mesh.get_local_rank(batch_axis)
        xb = xb[row * lanes:(row + 1) * lanes]
    local = xb[:, start:start + sizes[col]].to(device).contiguous()

    sharded = _ShardedObjective(objective.fn, objective.mode, model_mesh, n)
    solver = _shard_box(solver, start, sizes[col])
    with model_axis_group(model_group, start, n):
        res = _solve_batched(sharded, local, solver, stopping, trace, None,
                             None, device)

    res.state.x = all_gather_cat(res.state.x, model_group, -1, sizes)
    res.state.gradient = all_gather_cat(res.state.gradient, model_group, -1,
                                        sizes)
    fields = _ALONG_N.get(type(res.internals), {})
    if fields:
        res.internals = dataclasses.replace(res.internals, **{
            name: all_gather_cat(getattr(res.internals, name), model_group,
                                 axis, sizes)
            for name, axis in fields.items()})
    if batch_axis is not None:
        res = gather_lanes(res, mesh.get_group(batch_axis), b)
    return _unbatch_result(res) if batch_axis is None else res

