"""Rank processes of the port's multi-device tests (gloo on the CPU).

    python tests/torch_parallel_ranks.py SUITE WORLD RANK DIR

runs one rank of a ``WORLD``-rank job: it joins the process group through a
``FileStore`` in ``DIR``, runs every case of ``SUITE`` ("batch": the batch
split over ranks, ``parallel.minimize_sharded``; "model": each instance's n
split, ``parallel.minimize_model_sharded``) and writes what each case
returned to ``DIR/SUITE_rank{RANK}.pt``.  :func:`run_ranks` starts the
``WORLD`` processes and loads their records.  It imports no JAX: the test
files compare the records with the JAX package in their own process.
"""

from __future__ import annotations

import os
import subprocess
import sys
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

N_MODEL = 512  # the model suite's n, as tests/test_model_sharded.py's N
N_UNEVEN = 510  # n that the model axis does not divide into equal shards


def rosenbrock_view(x):
    """Extended Rosenbrock over disjoint pairs, written so that DTensor
    keeps it sharded: ``view(-1, 2)`` splits each shard into whole pairs."""
    p = x.view(-1, 2)
    return torch.sum(100.0 * (p[:, 1] - p[:, 0] ** 2) ** 2
                     + (1.0 - p[:, 0]) ** 2)


def rosenbrock_strided(x):
    """The same function written as the JAX tests write it; DTensor
    all-gathers x to take the strided slices."""
    even, odd = x[0::2], x[1::2]
    return torch.sum(100.0 * (odd - even ** 2) ** 2 + (1.0 - even) ** 2)


def quadratic_scale(n, dtype=torch.float64):
    """tests/test_model_sharded.py's ``quadratic`` weights."""
    return 1.0 + torch.arange(n, dtype=dtype) / n


def quadratic(scale):
    return lambda x: torch.sum(scale * x * x)


def batch_start():
    """tests/test_parallel.py's batch: 32 starts of the 2-D Rosenbrock."""
    return np.random.default_rng(7).uniform(-2.0, 2.0, size=(32, 2))


def box_start():
    """Starts of the box-constrained leg (``__graft_entry__.py``'s
    ``Lbfgsb(m=5, lower=0.5, upper=4.0)`` case), float64."""
    return np.random.default_rng(1).uniform(1.0, 3.0, size=(16, 4))


def easy_hard_start():
    """tests/test_scaling_efficiency.py's lanes: at the optimum, or at the
    classic start."""
    easy = np.ones(4)
    hard = np.array([-1.2, 1.0, -1.2, 1.0])
    return np.stack([easy, hard, easy, hard] * 2)


def mesh_2d_start():
    """tests/test_model_sharded.py's 2-D mesh batch."""
    return np.random.default_rng(3).uniform(-2.0, 2.0, size=(8, N_MODEL))


def summary(res):
    """The tensors of a result that the tests read, on the host."""
    if res is None:
        return None
    out = {
        "x": res.state.x, "value": res.state.value,
        "gradient": res.state.gradient, "nfev": res.state.nfev,
        "status": res.progress.status,
        "iterations": res.progress.num_iterations,
    }
    if res.trace is not None:
        out["trace_value"] = res.trace.value
    out = {k: v.detach().cpu().clone() for k, v in out.items()}
    out["trips"] = res.trips
    return out


def logged(fn):
    """``fn()`` under a collective log: its summary, the log's entries and
    the device-to-host reads of the loop."""
    from cppnumericalsolvers_tpu_torch.core.tree import any_lane
    from cppnumericalsolvers_tpu_torch.parallel.comm import CollectiveLog

    reads0 = any_lane.reads
    with CollectiveLog() as log:
        res = fn()
    return {"result": summary(res), "entries": log.entries,
            "reads0": reads0, "reads1": any_lane.reads}


def caught(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def batch_suite(world, rank):
    import cppnumericalsolvers_tpu_torch as cns
    from cppnumericalsolvers_tpu_torch.parallel import (
        aggregate_metrics, make_mesh, minimize_sharded)

    cpu = dict(device="cpu")
    mesh = make_mesh(axis="batch", **cpu)
    out = {}
    batch = torch.from_numpy(batch_start())
    out["lbfgs"] = logged(lambda: minimize_sharded(
        cns.models.rosenbrock(), batch, cns.Lbfgs(), mesh=mesh, **cpu))
    out["metrics"] = aggregate_metrics(minimize_sharded(
        cns.models.rosenbrock(), batch, cns.Lbfgs(), mesh=mesh, **cpu))
    out["lbfgsb"] = logged(lambda: minimize_sharded(
        cns.models.pairwise_rosenbrock(), torch.from_numpy(box_start()),
        cns.Lbfgsb(m=5, lower=0.5, upper=4.0), mesh=mesh, **cpu))
    out["easy_hard"] = summary(minimize_sharded(
        cns.models.pairwise_rosenbrock(),
        torch.from_numpy(easy_hard_start()), cns.Lbfgs(m=5), mesh=mesh,
        **cpu))
    out["indivisible"] = caught(lambda: minimize_sharded(
        cns.models.rosenbrock(), batch[:31], cns.Lbfgs(), mesh=mesh, **cpu))
    sub = make_mesh(2, **cpu)
    out["submesh"] = summary(minimize_sharded(
        cns.models.rosenbrock(), batch, cns.Lbfgs(), mesh=sub, **cpu))
    return out


def model_suite(world, rank):
    import cppnumericalsolvers_tpu_torch as cns
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from cppnumericalsolvers_tpu_torch.parallel import (
        make_mesh, minimize_model_sharded)

    cpu = dict(device="cpu")
    mesh = make_mesh(axis="model", **cpu)
    out = {}

    def solve(fn, x0, solver, **kw):
        return minimize_model_sharded(
            cns.objective(fn), x0, solver, mesh=mesh, **cpu, **kw)

    x_rosen = torch.full((N_MODEL,), -1.2, dtype=torch.float64)
    out["rosen_view"] = logged(
        lambda: solve(rosenbrock_view, x_rosen, cns.Lbfgs(m=10)))
    short = cns.default_stopping(torch.float64).replace(max_iterations=2)
    out["rosen_strided"] = logged(lambda: solve(
        rosenbrock_strided, x_rosen, cns.Lbfgs(m=10), stopping=short))
    scale = distribute_tensor(quadratic_scale(N_MODEL), mesh, [Shard(0)])
    x_quad = torch.linspace(-2.0, 2.0, N_MODEL, dtype=torch.float64)
    quad = logged(lambda: solve(quadratic(scale), x_quad, cns.Lbfgs(m=5),
                                trace=4))
    out["quadratic"] = quad
    out["gd"] = summary(solve(
        quadratic(scale), torch.linspace(-1.0, 1.0, N_MODEL,
                                         dtype=torch.float64),
        cns.GradientDescent()))
    scale_u = distribute_tensor(quadratic_scale(N_UNEVEN), mesh, [Shard(0)])
    out["uneven"] = summary(solve(
        quadratic(scale_u),
        torch.linspace(-2.0, 2.0, N_UNEVEN, dtype=torch.float64),
        cns.Lbfgs(m=5)))
    # n = 9 over 4 ranks: DTensor's split leaves the last rank no element.
    out["tiny"] = summary(solve(lambda x: torch.sum((x - 1.0) ** 2),
                                torch.zeros(9, dtype=torch.float64),
                                cns.Lbfgs(m=5)))
    out["shape_1d"] = caught(lambda: solve(
        rosenbrock_view, torch.zeros((2, N_MODEL), dtype=torch.float64),
        cns.Lbfgs()))
    out["shape_2d"] = caught(lambda: solve(
        rosenbrock_view, torch.zeros((N_MODEL,), dtype=torch.float64),
        cns.Lbfgs(), batch_axis="batch"))
    out["bfgs"] = caught(lambda: solve(rosenbrock_view, x_rosen, cns.Bfgs()))
    if world == 4:
        mesh2 = init_device_mesh("cpu", (2, 2),
                                 mesh_dim_names=("batch", "model"))
        out["mesh_2d"] = logged(lambda: minimize_model_sharded(
            cns.objective(rosenbrock_view),
            torch.from_numpy(mesh_2d_start()), cns.Lbfgs(m=5), mesh=mesh2,
            batch_axis="batch", **cpu))
        # 3 lanes over 2 batch groups: the last group's block is padded.
        out["mesh_2d_uneven"] = summary(minimize_model_sharded(
            cns.objective(lambda x: torch.sum((x - 1.0) ** 2)),
            torch.from_numpy(mesh_2d_start()[:3, :64]), cns.Lbfgs(m=5),
            mesh=mesh2, batch_axis="batch", **cpu))
    return out


SUITES = {"batch": batch_suite, "model": model_suite}


def main(suite, world, rank, where):
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(where, f"{suite}.store"),
                                     world),
        rank=rank, world_size=world)
    try:
        out = SUITES[suite](world, rank)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(where, f"{suite}_rank{rank}.pt"))


def run_ranks(suite, world, where, timeout=240):
    """Run ``suite`` on ``world`` gloo ranks, each a process of its own, and
    return their records in rank order.  A rank that fails or outlasts
    ``timeout`` seconds fails the run; every process is stopped."""
    os.makedirs(where, exist_ok=True)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, suite, str(world), str(r), where],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for r in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"{suite} ranks {bad} failed:\n"
                           + "\n".join(logs)[-6000:])
    return [torch.load(os.path.join(where, f"{suite}_rank{r}.pt"),
                       weights_only=False) for r in range(world)]


if __name__ == "__main__":
    try:
        main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    except Exception:
        traceback.print_exc()
        sys.exit(1)
