"""Rank processes of the port's multi-device tests (gloo on the CPU).

    python tests/torch_parallel_ranks.py SUITE WORLD RANK DIR

runs one rank of a ``WORLD``-rank job: it joins the process group through a
``FileStore`` in ``DIR``, runs every case of ``SUITE`` ("batch": the batch
split over ranks, ``parallel.minimize_sharded``; "model": each instance's n
split, ``parallel.minimize_model_sharded``; "dense": the same for BFGS,
Newton, both trust regions, Nelder-Mead and preconditioned L-BFGS;
"examples": examples_torch/pod_scale.py and entry_torch.py; "scaling":
benchmarks_torch/scaling.py's legs) and writes what each case
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


def model_box_start(n):
    """One start of the model-sharded box leg, uniform in [1, 3]."""
    return np.random.default_rng(1).uniform(1.0, 3.0, size=n)


LBFGSB_BOX = (0.5, 4.0)
#: The iteration cut of the boxed Rosenbrock's exact comparisons: from a
#: random start its trajectory amplifies a last-bit difference (x 1e-14
#: from JAX's at 10 iterations, 2.9e-10 at 20 and the value 1.5e-10 apart
#: relative, 1.6e-9 at 40), so a short fixed budget is held.
LBFGSB_CUT = 10


def lbfgsb_cases():
    """The model-sharded L-BFGS-B cases: (label, objective, n, box or
    None, start, iteration cut or 0).  The view-form Rosenbrock at N_MODEL
    (boxed from [1, 3], to its end and cut; unboxed from -1.2); at
    N_UNEVEN, whose shards are odd on two ranks, the weighted quadratic."""
    rosen_x = np.full(N_MODEL, -1.2)
    quad_x = np.linspace(-2.0, 2.0, N_UNEVEN)
    box_x = model_box_start(N_MODEL)
    return [
        ("lbfgsb_box", "rosen", N_MODEL, LBFGSB_BOX, box_x, 0),
        ("lbfgsb_box_cut", "rosen", N_MODEL, LBFGSB_BOX, box_x, LBFGSB_CUT),
        ("lbfgsb_free", "rosen", N_MODEL, None, rosen_x, 0),
        ("lbfgsb_box_uneven", "quad", N_UNEVEN, LBFGSB_BOX,
         model_box_start(N_UNEVEN), 0),
        ("lbfgsb_free_uneven", "quad", N_UNEVEN, None, quad_x, 0),
    ]


def tuple_box(n=64):
    """A box per coordinate of the config (tuples of n floats): every rank
    solves with its own shard of it."""
    lo = tuple(-1.0 - 0.01 * j for j in range(n))
    up = tuple(1.0 + 0.05 * j for j in range(n))
    return lo, up


def cauchy_inputs(kind, n=N_MODEL, m=3):
    """Inputs of one generalized-Cauchy-point walk of two lanes, float64:
    ``kind`` "none" puts every coordinate on a bound its gradient points
    out of (no positive breakpoint: the walk starts at the last sorted
    one); "ties" gives whole classes of coordinates, spread over every
    shard, one breakpoint (and a quarter of them a zero gradient), so the
    walk must take ties in index order across ranks.  The history is a
    real one (s.y > 0); returns numpy arrays ``x, g, lower, upper, w,
    middle_inv, theta``."""
    import cppnumericalsolvers_tpu_torch.solvers.lbfgsb as tl
    from cppnumericalsolvers_tpu_torch.utils.linalg import invert_small

    rng = np.random.default_rng(5)
    b = 2
    lower = np.full((b, n), -1.0)
    upper = np.full((b, n), 1.0)
    j = np.arange(n)
    if kind == "none":
        at_upper = rng.uniform(size=(b, n)) < 0.5
        x = np.where(at_upper, upper, lower)
        g = np.where(at_upper, -1.0, 1.0) * rng.uniform(0.5, 2.0, (b, n))
    else:
        x = np.where(j % 3 == 0, 0.5, 0.25) * np.ones((b, n))
        g = np.where(j % 3 == 0, 1.0, -2.0) * np.ones((b, n))
        g[1] *= 0.1  # the second lane crosses more breakpoints
        g[:, j % 4 == 1] = 0.0
    s_h = torch.from_numpy(rng.normal(size=(b, m, n)) * 0.1)
    y_h = s_h * 2.0 + torch.from_numpy(rng.normal(size=(b, m, n)) * 0.01)
    count = torch.full((b,), m, dtype=torch.int32)
    theta = tl._dot(y_h[:, -1], y_h[:, -1]) / tl._dot(s_h[:, -1], y_h[:, -1])
    middle_inv = invert_small(tl._build_middle(s_h, y_h, count, theta, m))
    w = torch.cat([y_h.transpose(-1, -2),
                   theta[:, None, None] * s_h.transpose(-1, -2)], dim=-1)
    return (x, g, lower, upper, w.numpy(), middle_inv.numpy(),
            theta.numpy())


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
    """``fn()`` under a collective log: its summary, the log's entries,
    the device-to-host reads of the loop and the L-BFGS-B Cauchy walk's
    passes."""
    from cppnumericalsolvers_tpu_torch.core.tree import any_lane
    from cppnumericalsolvers_tpu_torch.parallel.comm import CollectiveLog
    from cppnumericalsolvers_tpu_torch.solvers.lbfgsb import (
        generalized_cauchy_point as gcp)

    reads0, passes0 = any_lane.reads, gcp.passes
    with CollectiveLog() as log:
        res = fn()
    return {"result": summary(res), "entries": log.entries,
            "reads0": reads0, "reads1": any_lane.reads,
            "passes": gcp.passes - passes0}


def sharded_cauchy(kind, group, world, rank):
    """The walk of :func:`cauchy_inputs` on this rank's shard, inside the
    model group; every rank returns the whole ``(x_cauchy, c)``."""
    from cppnumericalsolvers_tpu_torch.core.tree import model_axis_group
    from cppnumericalsolvers_tpu_torch.parallel.comm import (
        all_gather_cat, shard_sizes)
    from cppnumericalsolvers_tpu_torch.solvers.lbfgsb import (
        generalized_cauchy_point)

    x, g, lower, upper, w, middle_inv, theta = (
        torch.from_numpy(a) for a in cauchy_inputs(kind))
    n = x.shape[-1]
    sizes = shard_sizes(n, world)
    start, size = sum(sizes[:rank]), sizes[rank]
    cut = slice(start, start + size)
    with model_axis_group(group, start, n):
        xc, c = generalized_cauchy_point(
            x[:, cut], g[:, cut], lower[:, cut], upper[:, cut],
            w[:, cut], middle_inv, theta)
    return {"x_cauchy": all_gather_cat(xc, group, -1, sizes), "c": c}


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
    for label, kind, n, box, x0, cut in lbfgsb_cases():
        fn = rosenbrock_view if kind == "rosen" else quadratic(scale_u)
        kw = {} if box is None else dict(lower=box[0], upper=box[1])
        lstop = cns.Lbfgsb().default_stopping(torch.float64)
        if cut:
            lstop = lstop.replace(max_iterations=cut)
        run = (logged if label == "lbfgsb_box_cut"
               else lambda f: summary(f()))
        out[label] = run(lambda: solve(
            fn, torch.from_numpy(x0), cns.Lbfgsb(m=5, **kw),
            stopping=lstop))
    lo, up = tuple_box()
    out["lbfgsb_tuple_box"] = summary(solve(
        lambda x: torch.sum((x - 2.0) ** 2), torch.zeros(len(lo),
                                                         dtype=torch.float64),
        cns.Lbfgsb(m=5, lower=lo, upper=up)))
    group = mesh.get_group("model")
    for kind in ("none", "ties"):
        out[f"cauchy_{kind}"] = sharded_cauchy(kind, group, world, rank)
    out["cg"] = logged(lambda: solve(quadratic(scale), x_quad,
                                     cns.ConjugateGradientDescent()))
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


N_DENSE = 64  # Newton's and the dense trust region's n, and Rosenbrock's
N_DENSE_UNEVEN = 62  # ... that four ranks do not divide (16, 16, 16, 14)
N_NM = 16  # Nelder-Mead's n, as the JAX check of the same
N_NM_UNEVEN = 15
#: The long Nelder-Mead cases' budgets, their x-delta, f-delta and plateau
#: tests off (the default stopping ends the simplex after 6-13 iterations
#: on these starts): on Rosenbrock past 20 iterations the best vertex of
#: the port and of JAX parts on a last-bit difference of their sums (x
#: 1.3e-15 apart after 20, another vertex 1.2 away after 30, nfev equal to
#: 40, unsharded as sharded); on the quadratic they agree after 120.
NM_ROSEN_CUT = 20
NM_LONG_CUT = 120
#: BFGS on Rosenbrock from -1.2 is held to the world of one, not to JAX
#: (GSPMD's reordered sums move JAX's own sharded BFGS there), at this cut:
#: its first steps amplify a sum's last bit about a thousandfold an
#: iteration (four ranks from one, x apart: 1.8e-15 after one iteration,
#: 1.6e-12 after two, 7.8e-9 after three, 1.2e-4 after four).
BFGS_ROSEN_CUT = 2
#: Where the resumed cases are cut before the test resumes them unsharded.
RESUME_CUT = {"bfgs": 4, "nm": 4}

#: The dense suite's solvers: (class, arguments, objective mode).
DENSE_SOLVERS = {
    "bfgs": ("Bfgs", {}, "first"),
    "newton": ("NewtonDescent", {}, "second"),
    "tr": ("TrustRegionNewton", {}, "second"),
    "trhf": ("TrustRegionNewton", {"hessian_free": True}, "first"),
    "nm": ("NelderMead", {}, "none"),
    "lbfgs_pre": ("Lbfgs", {"m": 5, "use_hessian_preconditioner": True},
                  "second"),
}


def quadratic_whole(x):
    """tests/test_model_sharded.py's quadratic, its weights built from x's
    own width: a plain constant, which the sharded evaluation takes as
    replicated and the second-order evaluations (on the gathered x) as it
    is."""
    n = x.shape[-1]
    scale = 1.0 + torch.arange(n, dtype=x.dtype, device=x.device) / n
    return torch.sum(scale * x * x)


def dense_cases():
    """The dense suite's 1-D cases: (label, solver key, objective "quad" or
    "rosen", n, iteration cut (0: none), the x-delta, f-delta and plateau
    tests on).  The quadratic
    from ``linspace(-2, 2, n)`` (the JAX test's), Rosenbrock from -1.2, and
    each solver at a width that four ranks do not divide."""
    return [
        ("bfgs_quad", "bfgs", "quad", N_MODEL, 0, True),
        ("bfgs_uneven", "bfgs", "quad", N_UNEVEN, 0, True),
        ("bfgs_rosen", "bfgs", "rosen", N_DENSE, BFGS_ROSEN_CUT, True),
        ("bfgs_rosen_full", "bfgs", "rosen", N_DENSE, 0, True),
        ("newton_quad", "newton", "quad", N_DENSE, 0, True),
        ("newton_rosen", "newton", "rosen", N_DENSE, 0, True),
        ("newton_uneven", "newton", "quad", N_DENSE_UNEVEN, 0, True),
        ("tr_quad", "tr", "quad", N_DENSE, 0, True),
        ("tr_rosen", "tr", "rosen", N_DENSE, 0, True),
        ("tr_uneven", "tr", "quad", N_DENSE_UNEVEN, 0, True),
        ("trhf_quad", "trhf", "quad", N_MODEL, 0, True),
        ("trhf_rosen", "trhf", "rosen", N_DENSE, 0, True),
        ("trhf_uneven", "trhf", "quad", N_UNEVEN, 0, True),
        ("nm_rosen", "nm", "rosen", N_NM, 0, True),
        ("nm_long", "nm", "rosen", N_NM, NM_ROSEN_CUT, False),
        ("nm_uneven", "nm", "quad", N_NM_UNEVEN, NM_LONG_CUT, False),
        ("lbfgs_pre_quad", "lbfgs_pre", "quad", N_MODEL, 0, True),
        ("lbfgs_pre_rosen", "lbfgs_pre", "rosen", N_DENSE, 0, True),
        ("lbfgs_pre_uneven", "lbfgs_pre", "quad", N_UNEVEN, 0, True),
    ]


#: Cases solved under the collective log, by label.
DENSE_LOGGED = ("bfgs_quad", "newton_quad", "tr_quad", "trhf_quad",
                "nm_long", "lbfgs_pre_quad")


def dense_start(kind, n, lanes=0):
    """The start of a dense case: ``(n,)``, or ``(lanes, n)`` with each lane
    scaled by ``1 + 0.25 k``."""
    x = (np.full(n, -1.2) if kind == "rosen"
         else np.linspace(-2.0, 2.0, n))
    if lanes:
        x = x[None] * (1.0 + 0.25 * np.arange(lanes))[:, None]
    return x


def dense_problem(key, kind, cut=0, deltas=True):
    """``(function, mode, solver, stopping)`` of a dense case, float64."""
    import cppnumericalsolvers_tpu_torch as cns

    cls, kw, mode = DENSE_SOLVERS[key]
    solver = getattr(cns, cls)(**kw)
    stop = solver.default_stopping(torch.float64)
    if cut:
        stop = stop.replace(max_iterations=cut)
    if not deltas:
        stop = stop.replace(x_delta=0.0, f_delta=0.0, past=0)
    fn = rosenbrock_view if kind == "rosen" else quadratic_whole
    return fn, mode, solver, stop


def dense_suite(world, rank):
    import cppnumericalsolvers_tpu_torch as cns
    from torch.distributed.device_mesh import init_device_mesh

    from cppnumericalsolvers_tpu_torch.parallel import (
        make_mesh, minimize_model_sharded)

    cpu = dict(device="cpu")
    mesh = make_mesh(axis="model", **cpu)
    out = {}
    for label, key, kind, n, cut, deltas in dense_cases():
        fn, mode, solver, stop = dense_problem(key, kind, cut, deltas)
        x0 = torch.from_numpy(dense_start(kind, n))
        run = logged if label in DENSE_LOGGED else lambda f: summary(f())
        out[label] = run(lambda: minimize_model_sharded(
            cns.objective(fn, mode), x0, solver, stop, mesh=mesh, **cpu))
    # n = 9 over 4 ranks: the last rank holds no coordinate, so no column
    # of the Hessian.
    out["newton_tiny"] = summary(minimize_model_sharded(
        cns.objective(lambda x: torch.sum((x - 1.0) ** 4 + (x - 1.0) ** 2),
                      "second"),
        torch.zeros(9, dtype=torch.float64), cns.NewtonDescent(),
        mesh=mesh, **cpu))
    for key, cut in RESUME_CUT.items():
        kind = "rosen" if key == "nm" else "quad"
        n = N_NM if key == "nm" else N_MODEL
        fn, mode, solver, stop = dense_problem(key, kind, cut)
        res = minimize_model_sharded(
            cns.objective(fn, mode), torch.from_numpy(dense_start(kind, n)),
            solver, stop, mesh=mesh, **cpu)
        out[f"{key}_cut"] = res
    if world == 4:
        mesh2 = init_device_mesh("cpu", (2, 2),
                                 mesh_dim_names=("batch", "model"))
        for key in DENSE_SOLVERS:
            kind = "rosen" if key == "nm" else "quad"
            n = N_NM if key == "nm" else N_DENSE
            fn, mode, solver, stop = dense_problem(key, kind)
            out[f"{key}_2d"] = summary(minimize_model_sharded(
                cns.objective(fn, mode),
                torch.from_numpy(dense_start(kind, n, lanes=3)), solver,
                stop, mesh=mesh2, batch_axis="batch", **cpu))
    return out


#: The short budget of the dry run's float64 L-BFGS-B solve.
DRYRUN_SHORT = 5


def dryrun_draws(n):
    """entry_torch.dryrun_multichip(n)'s seed-1 draws (and
    __graft_entry__.dryrun_multichip(n)'s), in its order."""
    rng = np.random.default_rng(1)
    return {"lbfgs": rng.uniform(-2.0, 2.0, size=(4 * n, 4)),
            "lbfgsb": rng.uniform(1.0, 3.0, size=(2 * n, 4)),
            "al": rng.uniform(-1.0, 1.0, size=(2 * n, 4)),
            "mesh_2d": rng.uniform(-2.0, 2.0, size=(n // 2, 16))}


def examples_suite(world, rank):
    """examples_torch/pod_scale.py's ``main`` and entry_torch.py's
    ``dryrun_multichip(world)`` on this world, ``entry()``'s step, and the
    dry run's L-BFGS-B solve of its own draws in float64 on the same
    batch mesh, to its end ("dryrun_lbfgsb_float64") and cut at
    DRYRUN_SHORT iterations ("dryrun_lbfgsb_float64_short")."""
    import entry_torch
    from examples_torch import _common, pod_scale

    from cppnumericalsolvers_tpu_torch.parallel import (
        make_mesh, minimize_sharded)
    from cppnumericalsolvers_tpu_torch.solvers import Lbfgsb

    fn, args = entry_torch.entry("cpu")
    out = {"pod_scale": pod_scale.main("cpu"),
           "dryrun": entry_torch.dryrun_multichip(world, "cpu"),
           "entry": fn(*args).detach().cpu()}
    solver = Lbfgsb(m=5, lower=0.5, upper=4.0)
    mesh = make_mesh(world, device="cpu")
    stop = solver.default_stopping(torch.float64)
    for label, cut in (("", 0), ("_short", DRYRUN_SHORT)):
        res = minimize_sharded(
            entry_torch._flagship_objective(),
            torch.from_numpy(dryrun_draws(world)["lbfgsb"]), solver,
            stop.replace(max_iterations=cut) if cut else stop, mesh=mesh,
            device="cpu")
        out["dryrun_lbfgsb_float64" + label] = _common.lanes(res)
    return out


#: The scaling suite's sizes: benchmarks/scaling.py's batch leg (64 lanes a
#: rank at n = 16), the model leg at N_MODEL, the 2-D leg's (8, 1024), all
#: cut at SCALING_CUT iterations in float64.
SCALING_CUT = 10
SCALING_MESH_2D = (2, 2)


def scaling_sizes():
    from benchmarks_torch import scaling

    return scaling.Sizes(per_device_batch=64, dim=16, model_dim=N_MODEL,
                         lanes_2d=8, n_2d=1024, max_iters=SCALING_CUT,
                         repeats=1)


def scaling_suite(world, rank):
    """benchmarks_torch/scaling.py's three legs at this world, float64: the
    warm-up solve of each (the 2-D leg's on a SCALING_MESH_2D mesh, at W =
    4)."""
    from benchmarks_torch import scaling

    sizes, cpu = scaling_sizes(), torch.device("cpu")
    out = {"batch": summary(scaling.batch_leg(world, sizes, cpu,
                                              torch.float64)[0]),
           "model": summary(scaling.model_leg(world, sizes, cpu,
                                              torch.float64)[0])}
    if world == SCALING_MESH_2D[0] * SCALING_MESH_2D[1]:
        out["mesh_2d"] = summary(scaling.mesh_2d_leg(
            SCALING_MESH_2D, sizes, cpu, torch.float64)[0])
    return out


SUITES = {"batch": batch_suite, "model": model_suite, "dense": dense_suite,
          "examples": examples_suite, "scaling": scaling_suite}


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
