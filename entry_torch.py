"""Entry points of the PyTorch/CUDA port: one batched L-BFGS step, and a dry
run of the multi-device solves.

Counterpart of ``__graft_entry__.py``.  The flagship workload is the batched
L-BFGS solve: one "forward step" is one L-BFGS iteration of every lane (the
two-loop direction, the More-Thuente search, the history update).
``dryrun_multichip(n)`` runs the multi-device solves over the first ``n``
ranks of the default process group on tiny shapes: the batch split over
ranks (``Lbfgs``, and ``Lbfgsb`` with active bounds), the batched
augmented-Lagrangian solve split over ranks, and from two ranks on a 2-D
(batch, model) mesh.

    python entry_torch.py [--device cuda|cpu]        # a world of one
    torchrun --nproc-per-node <cards> entry_torch.py  # every card
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _flagship_objective():
    from cppnumericalsolvers_tpu_torch import objective

    def ext_rosenbrock(x):
        even, odd = x[0::2], x[1::2]
        return torch.sum(100.0 * (odd - even ** 2) ** 2 + (1.0 - even) ** 2)

    return objective(ext_rosenbrock, mode="first")


def _pairwise_rosenbrock(x):
    """The flagship objective written so that DTensor keeps it sharded."""
    p = x.view(-1, 2)
    return torch.sum(100.0 * (p[:, 1] - p[:, 0] ** 2) ** 2
                     + (1.0 - p[:, 0]) ** 2)


def entry(device=None):
    """Returns ``(fn, example_args)``: ``fn(x_batch)`` is one batched
    L-BFGS step from fresh internals on ``(256, 32)`` float32 starts from
    seed 0, on ``device`` (default the card)."""
    from cppnumericalsolvers_tpu_torch.core.driver import resolve_device
    from cppnumericalsolvers_tpu_torch.core.progress import default_stopping
    from cppnumericalsolvers_tpu_torch.solvers import Lbfgs

    dev = resolve_device(device)
    obj = _flagship_objective()
    solver = Lbfgs(m=10)
    stopping = default_stopping(torch.float32)

    def step(x_batch):
        state = obj.evaluate(x_batch, nfev=0)
        internals = solver.init_batched(obj, state)
        new_state, _, _ = solver.step(obj, state, internals, stopping)
        return new_state.x

    rng = np.random.default_rng(0)
    x_batch = torch.from_numpy(
        rng.uniform(-2.0, 2.0, size=(256, 32)).astype(np.float32)).to(dev)
    return step, (x_batch,)


def _al_sharded(al, problem, x0, mesh, device):
    """The batched AL solve split over ``mesh``'s ranks: each rank solves
    its contiguous block of lanes (``AugmentedLagrangian.minimize_batched``)
    and one ``all_gather`` a result leaf gives every rank the whole result,
    as ``parallel.minimize_sharded`` does for a ``SolverBase``.  A rank
    outside the mesh returns None."""
    from cppnumericalsolvers_tpu_torch.core.tree import tree_map
    from cppnumericalsolvers_tpu_torch.parallel.comm import all_gather_cat

    coord = mesh.get_coordinate()
    if coord is None:
        return None
    lanes = x0.shape[0] // mesh.size()
    block = x0[coord[0] * lanes:(coord[0] + 1) * lanes]
    res = al.minimize_batched(problem, block, device=device)
    group = mesh.get_group()

    def gather(t):
        return all_gather_cat(t, group, 0)

    res.state = tree_map(gather, res.state)
    res.progress = tree_map(gather, res.progress)
    return res


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the full batched solves over the first ``n_devices`` ranks of
    the default process group (joined as a world of one where it is not
    up) on tiny shapes, float32, starts from seed 1; return what each
    solve gave, lane by lane, on the host.

    The port's parallelism is data-parallel over problem instances (each
    rank's loop exits on its own lanes) and, from two ranks, intra-problem
    over a model axis."""
    from examples_torch._common import join_world, lanes

    from cppnumericalsolvers_tpu_torch import ConstrainedProblem, objective
    from cppnumericalsolvers_tpu_torch.parallel import (
        aggregate_metrics, make_mesh, minimize_model_sharded,
        minimize_sharded)
    from cppnumericalsolvers_tpu_torch.parallel.comm import rank_device
    from cppnumericalsolvers_tpu_torch.solvers import (
        AugmentedLagrangian, Lbfgs, Lbfgsb)

    joined = join_world(device)
    try:
        dev = rank_device(device)
        obj = _flagship_objective()
        mesh = make_mesh(n_devices, device=dev)
        rng = np.random.default_rng(1)
        out = {}

        def f32(a):
            return torch.from_numpy(a.astype(np.float32))

        x0 = f32(rng.uniform(-2.0, 2.0, size=(4 * n_devices, 4)))
        result = minimize_sharded(obj, x0, Lbfgs(m=5), mesh=mesh,
                                  device=dev)
        if result is not None:
            metrics = aggregate_metrics(result)
            assert metrics["total_instances"] == 4 * n_devices
            assert bool(torch.isfinite(result.state.value).all())
            out["lbfgs"] = {**lanes(result), "metrics": metrics}

        # The box-constrained solver on the same sharded-batch path:
        # L-BFGS-B with active bounds, each rank's loop on its own lanes.
        x0_box = f32(rng.uniform(1.0, 3.0, size=(2 * n_devices, 4)))
        result_box = minimize_sharded(
            _flagship_objective(), x0_box,
            Lbfgsb(m=5, lower=0.5, upper=4.0), mesh=mesh, device=dev)
        if result_box is not None:
            assert bool(torch.isfinite(result_box.state.value).all())
            x_box = result_box.state.x
            assert bool(((x_box >= 0.5 - 1e-5) & (x_box <= 4.0 + 1e-5))
                        .all())
            out["lbfgsb"] = lanes(result_box)

        # The constrained outer loop split over the batch: each rank's
        # nested AL solve (inner L-BFGS) on its block of lanes.
        problem = ConstrainedProblem(
            objective=objective(lambda x: torch.sum((x - 1.0) ** 2),
                                mode="first"),
            equality_constraints=(
                objective(lambda x: torch.sum(x) - 1.0, mode="first"),
            ),
        )
        al = AugmentedLagrangian(inner_solver=Lbfgs(m=5))
        x0_al = f32(rng.uniform(-1.0, 1.0, size=(2 * n_devices, 4)))
        result_al = _al_sharded(al, problem, x0_al, mesh, dev)
        if result_al is not None:
            assert bool(torch.isfinite(result_al.state.x).all())
            out["al"] = lanes(result_al)

        # The second scaling axis: intra-problem sharding on a 2-D (batch,
        # model) mesh, each instance's n split over "model".  The objective
        # is the same function written with x.view(-1, 2), which DTensor
        # keeps sharded (whole pairs on each rank); the strided form
        # all-gathers x at every evaluation, and gloo's all-gather of card
        # tensors through DTensor crashes the process.
        if n_devices >= 2:
            from torch.distributed.device_mesh import DeviceMesh

            rows = n_devices // 2
            mesh2d = DeviceMesh(
                dev.type, torch.arange(2 * rows).reshape(rows, 2),
                mesh_dim_names=("batch", "model"))
            x0_2d = f32(rng.uniform(-2.0, 2.0, size=(rows, 16)))
            if mesh2d.get_coordinate() is not None:
                result2d = minimize_model_sharded(
                    objective(_pairwise_rosenbrock, mode="first"), x0_2d,
                    Lbfgs(m=5), mesh=mesh2d,
                    batch_axis="batch", device=dev)
                assert bool(torch.isfinite(result2d.state.value).all())
                out["mesh_2d"] = lanes(result2d)
        return out
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    import argparse
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from examples_torch._common import join_world

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    device = parser.parse_args().device
    fn, args = entry(device)
    out = fn(*args)
    print("entry ok:", tuple(out.shape), out.dtype)
    joined = join_world(device)
    try:
        dryrun_multichip(dist.get_world_size(), device)
    finally:
        if joined:
            dist.destroy_process_group()
    print("dryrun_multichip ok")
