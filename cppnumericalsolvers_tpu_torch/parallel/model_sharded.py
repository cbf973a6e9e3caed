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
  ``x[0::2]``).  A constant tensor of length n must be a DTensor on the
  same mesh, e.g. ``distribute_tensor(c, mesh, [Shard(0)])``: DTensor
  refuses to mix it with a plain tensor.
* **The solver's reductions** are explicit: inside
  ``core.tree.model_axis_group`` every per-lane sum and infinity norm of
  the loop (the two-loop's and the searches' dot products, the stopping
  machine's norms) is the local reduction followed by one ``all_reduce``
  of B scalars.  x, the gradient and the ``(m, n)`` history stay sharded
  through the whole loop; every rank computes the same per-lane scalars,
  so their loops run the same trips.

L-BFGS runs as ``Lbfgs(two_loop_impl="xla")`` (the push, the two-loop and
the More-Thuente trips in plain PyTorch, no kernel), forced here as the JAX
package forces its pure-XLA lowering; gradient descent runs as it is, its
More-Thuente trips in plain PyTorch too (``core.tree.model_axis_group``),
and so does conjugate gradient with its Armijo search.  L-BFGS-B runs as it
is, its box sharded like x (a per-coordinate box of the config is cut to
each rank's shard), its search's trips in plain PyTorch: every sum over n
is all-reduced, and its generalized-Cauchy-point walk merges the ranks'
sorted breakpoints, one pass at a time, in two collectives a pass (an
``all_gather`` of each rank's next breakpoint, an ``all_reduce`` of the
crossed coordinate's 2m + 5 values;
``solvers.lbfgsb.generalized_cauchy_point``).  None of these four launches
a kernel.  These are the solvers whose reductions over n all go through
``core.tree``'s lane reductions; any other raises with its reason
(:func:`_check_solver`).

Combine with the batch axis for a 2-D mesh: ``x0`` of shape ``(B, n)``
with ``batch_axis`` splits the lanes over that axis (contiguous blocks,
the last lane repeated to fill the last block where B does not divide) and
each lane's n over ``model_axis``.  Every rank gets the whole result.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.func import grad_and_value, vmap

from ..core.driver import (
    MinimizeResult,
    SolverBase,
    _solve_batched,
    _unbatch_result,
)
from ..core.objective import MODE_NONE, Objective
from ..core.progress import StoppingCriteria
from ..core.tree import model_axis_group
from ..solvers.bfgs import Bfgs
from ..solvers.conjugate_gradient import CgInternals, ConjugateGradientDescent
from ..solvers.gradient_descent import GradientDescent
from ..solvers.lbfgs import Lbfgs, LbfgsInternals
from ..solvers.lbfgsb import Lbfgsb, LbfgsbInternals
from ..solvers.nelder_mead import NelderMead
from ..solvers.newton import NewtonDescent
from ..solvers.trust_region import TrustRegionNewton
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


#: Why each solver the port does not model-shard cannot be, by class.
_UNSHARDABLE = {
    Bfgs: "it holds an n x n inverse Hessian per lane",
    NewtonDescent: "it forms and solves with the n x n Hessian per lane",
    TrustRegionNewton: "it holds the n x n Hessian per lane, and its "
                       "Hessian-free form's CG-Steihaug sums over n outside "
                       "core.tree's lane reductions",
    NelderMead: "it holds an (n + 1) x n simplex per lane",
}

#: Fields of a result's internals that are sharded along n, by type.
_ALONG_N = {
    LbfgsInternals: ("s_memory", "y_memory", "s_pending", "y_pending"),
    CgInternals: ("previous_gradient", "direction"),
    LbfgsbInternals: ("s_history", "y_history", "lower", "upper"),
}


def _check_solver(solver: SolverBase) -> None:
    """Raise unless every reduction over n of ``solver``'s loop goes
    through ``core.tree``'s lane reductions: ``Lbfgs`` without the Hessian
    preconditioner, ``GradientDescent``, ``ConjugateGradientDescent`` and
    ``Lbfgsb``."""
    if isinstance(solver, Lbfgs):
        if not solver.use_hessian_preconditioner:
            return
        why = ("the Hessian-diagonal preconditioner needs the Hessian, "
               "which the model-sharded objective does not evaluate")
    elif isinstance(solver, (GradientDescent, ConjugateGradientDescent,
                             Lbfgsb)):
        return
    else:
        why = next((v for k, v in _UNSHARDABLE.items()
                    if isinstance(solver, k)),
                   "its reductions over n do not go through core.tree's "
                   "lane reductions")
    raise ValueError(
        f"{type(solver).__name__} is not model-sharded in the port: {why}."
    )


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
        xg = self._global(x)
        if self.mode == MODE_NONE:
            return self._value(vmap(self.fn)(xg)), torch.zeros_like(x)
        g, v = vmap(grad_and_value(self.fn))(xg)
        return self._value(v), self._shard(g)

    def batched_value(self, x):
        return self._value(vmap(self.fn)(self._global(x)))

    def _unsupported(self, *args):
        # The un-batched calls would evaluate fn on one rank's shard alone.
        raise ValueError("the model-sharded solve evaluates batched values "
                         "and gradients only")

    value = value_and_grad = gradient = hessian = hvp = _unsupported


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
    _check_solver(solver)
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

    def along_n(t):
        return all_gather_cat(t, model_group, -1, sizes)

    res.state.x = along_n(res.state.x)
    res.state.gradient = along_n(res.state.gradient)
    fields = _ALONG_N.get(type(res.internals), ())
    if fields:
        res.internals = dataclasses.replace(res.internals, **{
            name: along_n(getattr(res.internals, name)) for name in fields})
    if batch_axis is not None:
        res = gather_lanes(res, mesh.get_group(batch_axis), b)
    return _unbatch_result(res) if batch_axis is None else res

