#!/usr/bin/env python3
"""Scaling harness: iterations/s against the number of ranks, with spread.

    python3 benchmarks_torch/scaling.py                # NCCL, one a card
    python3 benchmarks_torch/scaling.py --device cpu   # gloo on the host

The PyTorch/CUDA port's counterpart of ``benchmarks/scaling.py``, which
stays the JAX package's.  It prints one JSON line.

**Process model.**  The JAX harness builds a virtual 8-device mesh in one
process.  Here a world of W ranks is W processes of this script
(``--rank``), started afresh for each W, that join a new process group
through a ``FileStore`` in a directory of their own under ``build/``; each
builds the mesh of that size (``parallel.make_mesh``).  Under ``--device
cuda`` (the default) the group is NCCL's and rank r runs on card r
(``LOCAL_RANK`` = r); W takes 1, 2, 4 and 8 up to the number of visible
cards.  A world larger than that is not run: gloo ranks sharing a card
would say nothing of scaling.  Without a GPU it raises
(``core.driver.resolve_device``'s error).
Under ``--device cpu`` the group is gloo's on the host, W = 1, 2, 4, 8,
one thread a rank: JAX's virtual mesh.  Neither falls back to the other,
and a rank that fails fails the run (exit 1).

Each leg of a world gets one untimed warm-up solve (NCCL's set-up, the
allocator), as the JAX harness pays compilation.  Each timed rep starts on
every rank after a barrier and ends on rank 0 once the iteration count is
on the host; rank 0 writes the rates to the world's directory.

**Legs** (``benchmarks/scaling.py:112-188``: the same solvers, draws,
stopping and reps; every tolerance and ``past`` at 0, 60 iterations):

* batch axis (weak scaling): ``minimize_sharded`` with ``Lbfgs(m=10,
  two_loop_impl="xla")``, a constant batch a rank, drawn from
  ``default_rng(W)``;
* model axis (strong scaling): one instance, its n split over W by
  ``minimize_model_sharded`` with ``Lbfgs(m=10)`` (which that solve pins
  to ``"xla"``, as GSPMD takes XLA's lowering), ``default_rng(100 + W)``;
* 2-D mesh (batch x model): ``minimize_model_sharded(..., batch_axis=
  "batch")`` on a ("batch", "model") mesh, ``default_rng(7)``, a finite
  value on every lane asserted, one timed solve.  It runs in the world of
  as many ranks as the mesh has: (4, 2) on the CPU; on the card (cards/2,
  2), or (1, 1) with one card, which still goes through both axis groups.

The objective is the extended Rosenbrock in its view form, ``x.view(-1,
2)``: the same function as JAX's strided ``x[0::2], x[1::2]``, which
DTensor can only evaluate by gathering x (16 MB an evaluation at n =
4,194,304 float32).  Every shard must then hold whole pairs: n / W even
(:func:`check_shards`).

**Sizes**: on the CPU the JAX harness's (batch 64 a rank at n = 16; n =
262,144; 2-D (8, 1024)); on the card what a user of one runs (bench.py's
widest batch, (8192, 32) a card; n = 4,194,304; 2-D (256, 16,384)).
float32.  Flags override each.

**Output**: ``benchmarks/scaling.py``'s keys where they mean the same.
Where they do not:

* ``metric`` names the largest world run (``weak_scaling_efficiency_
  {W}dev``); with a world of one, ``value`` and ``vs_baseline`` are null:
  one card measures no scaling.
* ``model_axis.efficiency_vs_core_ceiling`` (speedup over min(W, host
  cores)) is the CPU's; on the card ``model_axis.efficiency`` is the
  speedup over W, each rank on its own card.
* ``backend`` is "nccl" or "gloo"; ``device`` the card's name and power
  limit (``nvidia-smi``) or "cpu"; ``cards`` the visible count; ``sizes``
  the worlds run; ``mesh_2d_batch_x_model.mesh`` the 2-D mesh's shape.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = 10
TARGET_EFFICIENCY = 0.80  # BASELINE.md's scaling target, as the JAX harness's
WORLD_TIMEOUT_S = 900  # a world's ranks, start to end


@dataclasses.dataclass(frozen=True)
class Sizes:
    per_device_batch: int
    dim: int
    model_dim: int
    lanes_2d: int
    n_2d: int
    max_iters: int = 60
    repeats: int = 5


#: benchmarks/scaling.py's constants (:76-81).
CPU_SIZES = Sizes(per_device_batch=64, dim=16, model_dim=262_144,
                  lanes_2d=8, n_2d=1024)
#: What a user of one card runs: bench.py's widest-batch throughput shape a
#: card, the model-sharded width of chip_smoke.py's part (c), a 2-D batch
#: whose lanes each hold 16,384 coordinates.
CARD_SIZES = Sizes(per_device_batch=8192, dim=32, model_dim=4_194_304,
                   lanes_2d=256, n_2d=16_384)
CPU_MESH_2D = (4, 2)


def rosenbrock_view(x):
    """The extended Rosenbrock over disjoint pairs, written so that DTensor
    keeps it sharded: ``view(-1, 2)`` splits each shard into whole pairs."""
    import torch

    p = x.view(-1, 2)
    return torch.sum(100.0 * (p[:, 1] - p[:, 0] ** 2) ** 2
                     + (1.0 - p[:, 0]) ** 2)


def objective():
    import cppnumericalsolvers_tpu_torch as cns

    return cns.objective(rosenbrock_view, mode="first")


def fixed_iter_stopping(dtype, max_iters):
    """``benchmarks/scaling.py``'s ``_fixed_iter_stopping``: every solve
    runs ``max_iters`` iterations unless a lane fails."""
    import cppnumericalsolvers_tpu_torch as cns

    return cns.default_stopping(dtype).replace(
        max_iterations=max_iters, x_delta=0.0, f_delta=0.0,
        gradient_norm=0.0, past=0)


def check_shards(n: int, parts: int) -> None:
    """Raise unless n splits over ``parts`` ranks into shards of whole
    pairs, which the view-form objective needs to stay sharded."""
    if n % parts or (n // parts) % 2:
        raise ValueError(
            f"n = {n} over {parts} ranks: each shard must hold an even "
            "number of coordinates (whole pairs of the view-form "
            "Rosenbrock)")


def batch_starts(world, sizes, dtype=np.float32, count=None):
    """The batch leg's starts at W = ``world``: ``default_rng(W)``'s draws
    in the JAX harness's order, one ``(batch a rank x W, dim)`` array a
    solve (warm-up first); ``count`` of them (default: all)."""
    rng = np.random.default_rng(world)
    batch = sizes.per_device_batch * world
    return [rng.uniform(-2.0, 2.0, size=(batch, sizes.dim)).astype(dtype)
            for _ in range(count or sizes.repeats + 1)]


def model_starts(world, sizes, dtype=np.float32, count=None):
    """The model leg's starts at W: ``default_rng(100 + W)``'s."""
    rng = np.random.default_rng(100 + world)
    return [rng.uniform(-2.0, 2.0, size=(sizes.model_dim,)).astype(dtype)
            for _ in range(count or sizes.repeats + 1)]


def mesh_2d_start(sizes, dtype=np.float32):
    """The 2-D leg's start: ``default_rng(7)``'s."""
    return np.random.default_rng(7).uniform(
        -2.0, 2.0, size=(sizes.lanes_2d, sizes.n_2d)).astype(dtype)


def _np_dtype(dtype):
    import torch

    return np.float64 if dtype == torch.float64 else np.float32


def _synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_rate(solve, x0, device) -> float:
    """One timed rep: summed iterations over this rank's host seconds, from
    the end of a barrier to the count on the host."""
    import torch.distributed as dist

    dist.barrier()
    _synchronize(device)
    t0 = time.perf_counter()
    res = solve(x0)
    iters = float(res.progress.num_iterations.sum().item())
    return iters / (time.perf_counter() - t0)


def measure(solve, starts, device):
    """The warm-up solve of ``starts[0]`` (untimed) and one timed rep of
    each other start: ``(warm-up result, iterations/s of each rep)``."""
    first = solve(starts[0])
    first.progress.num_iterations.sum().item()
    return first, [timed_rate(solve, x0, device) for x0 in starts[1:]]


def batch_leg(world, sizes, device, dtype):
    """Weak scaling over the batch axis at W = ``world`` (every rank of the
    default group calls it): ``(warm-up result, rates)``."""
    import torch

    import cppnumericalsolvers_tpu_torch as cns
    from cppnumericalsolvers_tpu_torch.parallel import (
        make_mesh, minimize_sharded)

    mesh = make_mesh(world, axis="batch", device=device)
    obj = objective()
    solver = cns.Lbfgs(m=M, two_loop_impl="xla")
    stop = fixed_iter_stopping(dtype, sizes.max_iters)
    starts = [torch.from_numpy(x).to(device)
              for x in batch_starts(world, sizes, _np_dtype(dtype))]
    return measure(lambda x0: minimize_sharded(
        obj, x0, solver, stop, mesh=mesh, device=device), starts, device)


def model_leg(world, sizes, device, dtype):
    """Strong scaling over the model axis: one instance, its n split over
    W = ``world``: ``(warm-up result, rates)``."""
    import torch

    import cppnumericalsolvers_tpu_torch as cns
    from cppnumericalsolvers_tpu_torch.parallel import (
        make_mesh, minimize_model_sharded)

    check_shards(sizes.model_dim, world)
    mesh = make_mesh(world, axis="model", device=device)
    obj = objective()
    solver = cns.Lbfgs(m=M)
    stop = fixed_iter_stopping(dtype, sizes.max_iters)
    starts = [torch.from_numpy(x).to(device)
              for x in model_starts(world, sizes, _np_dtype(dtype))]
    return measure(lambda x0: minimize_model_sharded(
        obj, x0, solver, stop, mesh=mesh, device=device), starts, device)


def mesh_2d_leg(shape, sizes, device, dtype):
    """Both axes at once on a ``shape`` = (batch, model) mesh spanning the
    default group: ``(warm-up result, {"lane_iters_per_s", "batch", "n",
    "mesh"})``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    import cppnumericalsolvers_tpu_torch as cns
    from cppnumericalsolvers_tpu_torch.parallel import minimize_model_sharded

    check_shards(sizes.n_2d, shape[1])
    mesh = init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=("batch", "model"))
    obj = objective()
    solver = cns.Lbfgs(m=M)
    stop = fixed_iter_stopping(dtype, sizes.max_iters)
    x0 = torch.from_numpy(mesh_2d_start(sizes, _np_dtype(dtype))).to(device)

    def solve(x):
        return minimize_model_sharded(obj, x, solver, stop, mesh=mesh,
                                      batch_axis="batch", device=device)

    first = solve(x0)
    if not bool(torch.isfinite(first.state.value).all()):
        raise RuntimeError("the 2-D leg's warm-up solve left a lane with a "
                           "value that is not finite")
    rate = timed_rate(solve, x0, device)
    return first, {"lane_iters_per_s": rate, "batch": sizes.lanes_2d,
                   "n": sizes.n_2d, "mesh": list(shape)}


# -- one rank ----------------------------------------------------------------


def rank_main(where: str, rank: int) -> int:
    """One rank of the world described by ``where/task.json``: join its
    group, run its legs, and (rank 0) write their rates to
    ``where/result.json``."""
    import torch
    import torch.distributed as dist

    with open(os.path.join(where, "task.json")) as f:
        task = json.load(f)
    world, sizes = task["world"], Sizes(**task["sizes"])
    if task["device"] == "cuda":
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank)
        device, backend = torch.device("cuda", rank), "nccl"
    else:
        torch.set_num_threads(1)
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(where, "store"), world),
        rank=rank, world_size=world)
    try:
        out = {"batch": batch_leg(world, sizes, device, torch.float32)[1],
               "model": model_leg(world, sizes, device, torch.float32)[1]}
        if task["mesh_2d"]:
            out["mesh_2d"] = mesh_2d_leg(task["mesh_2d"], sizes, device,
                                         torch.float32)[1]
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:  # the parent reads it once every rank has exited 0
        with open(os.path.join(where, "result.json"), "w") as f:
            json.dump(out, f)
    return 0


# -- the parent --------------------------------------------------------------


def run_world(world, device, sizes, mesh_2d, where) -> dict:
    """Start ``world`` rank processes in ``where`` and return rank 0's
    rates.  A rank that fails or a world that outlasts WORLD_TIMEOUT_S
    raises; every process is stopped."""
    os.makedirs(where)
    with open(os.path.join(where, "task.json"), "w") as f:
        json.dump({"world": world, "device": device,
                   "sizes": dataclasses.asdict(sizes),
                   "mesh_2d": mesh_2d}, f)
    env = dict(os.environ)
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    logs = [open(os.path.join(where, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank",
                 str(r), where], cwd=ROOT, env=env, stdout=logs[r],
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(
                    f"world {world}: rank {bad[0]} exited {codes[bad[0]]}:\n"
                    + _tail(os.path.join(where, f"rank{bad[0]}.log")))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"world {world}: not done after "
                                   f"{WORLD_TIMEOUT_S} s")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    with open(os.path.join(where, "result.json")) as f:
        return json.load(f)


def _tail(path, size=4000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-size:]


def stats(rates) -> dict:
    arr = np.asarray(rates, dtype=np.float64)
    return {"mean": float(arr.mean()),
            "std": float(arr.std(ddof=1)) if arr.size > 1 else 0.0,
            "min": float(arr.min()), "max": float(arr.max())}


def report(results, sizes, worlds, mesh_2d, device, cards, card) -> dict:
    """The JSON line from rank 0's rates of each world."""
    cores = os.cpu_count()
    batch = {w: stats(results[w]["batch"]) for w in worlds}
    eff = {w: batch[w]["mean"] / w / batch[1]["mean"] for w in worlds}
    band = {w: eff[w] * (batch[w]["std"] / batch[w]["mean"]
                         + batch[1]["std"] / batch[1]["mean"])
            for w in worlds}
    model = {w: stats(results[w]["model"]) for w in worlds}
    speedup = {w: model[w]["mean"] / model[1]["mean"] for w in worlds}
    if device == "cuda":
        model_eff = {"efficiency": {str(w): speedup[w] / w for w in worlds}}
    else:
        model_eff = {"efficiency_vs_core_ceiling": {
            str(w): speedup[w] / min(w, cores) for w in worlds}}
    top = max(worlds)
    if device == "cuda":
        note = (
            f"NCCL, one process a card, each rank on its own card of the "
            f"{cards} visible ({card}); worlds {worlds} ran, none larger "
            "than the cards. "
            + ("One card measures no scaling: value and vs_baseline are "
               "null, and the rates are the single-card rates of the three "
               "legs." if top == 1 else
               "Batch efficiency is the rate a card at W over one card's; "
               "the model axis's efficiency is its speedup over W."))
    else:
        note = (
            f"gloo ranks on a {cores}-core host, one thread each: a world "
            "of W shares the host's cores as JAX's virtual mesh does, so "
            "wall-clock efficiency is a check for hidden synchronisation, "
            "not interconnect evidence. The batch leg issues no collective "
            "inside its loop; the model leg all-reduces a scalar for each "
            "of its per-lane reductions.")
    return {
        "metric": f"weak_scaling_efficiency_{top}dev",
        "value": eff[top] if top > 1 else None,
        "unit": "frac",
        "vs_baseline": eff[top] / TARGET_EFFICIENCY if top > 1 else None,
        "repeats": sizes.repeats,
        "host_physical_cores": cores,
        "batch_axis": {
            "iters_per_s": {str(w): batch[w] for w in worlds},
            "per_device_efficiency": {str(w): eff[w] for w in worlds},
            "efficiency_noise_band": {str(w): band[w] for w in worlds},
        },
        "model_axis": {
            "dim": sizes.model_dim,
            "iters_per_s": {str(w): model[w] for w in worlds},
            "speedup_vs_1dev": {str(w): speedup[w] for w in worlds},
            **model_eff,
        },
        "mesh_2d_batch_x_model": results[mesh_2d[0] * mesh_2d[1]]["mesh_2d"],
        "per_device_batch": sizes.per_device_batch,
        "dim": sizes.dim,
        "backend": "nccl" if device == "cuda" else "gloo",
        "device": card if device == "cuda" else "cpu",
        "cards": cards,
        "sizes": worlds,
        "note": note,
    }


def _ints(text):
    return [int(v) for v in text.split(",")]


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default: NCCL, a process a card) or cpu "
                    "(gloo ranks on the host)")
    ap.add_argument("--sizes", type=_ints,
                    help="world sizes, comma-separated, starting at 1 "
                    "(default: 1, 2, 4, 8, on the card up to its count)")
    ap.add_argument("--mesh-2d", type=_ints,
                    help="the 2-D leg's (batch, model) mesh, e.g. 4,2; its "
                    "ranks must be one of the sizes")
    ap.add_argument("--repeats", type=int, help="timed reps a leg")
    ap.add_argument("--max-iters", type=int, help="iterations a solve")
    ap.add_argument("--per-device-batch", type=int)
    ap.add_argument("--dim", type=int, help="the batch leg's n")
    ap.add_argument("--model-dim", type=int, help="the model leg's n")
    ap.add_argument("--lanes-2d", type=int)
    ap.add_argument("--n-2d", type=int)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from benchmarks_torch.compare_scipy import card_line
    from cppnumericalsolvers_tpu_torch.core.driver import resolve_device

    resolve_device(args.device)  # no GPU: raises, no fallback
    cards = torch.cuda.device_count()
    if args.device == "cuda":
        base, card = CARD_SIZES, card_line()
        worlds = args.sizes or [w for w in (1, 2, 4, 8) if w <= cards]
        mesh_2d = args.mesh_2d or ([cards // 2, 2] if cards >= 2
                                   else [1, 1])
    else:
        base, card = CPU_SIZES, None
        worlds = args.sizes or [1, 2, 4, 8]
        mesh_2d = args.mesh_2d or list(CPU_MESH_2D)
    sizes = dataclasses.replace(base, **{
        k: v for k, v in (
            ("repeats", args.repeats), ("max_iters", args.max_iters),
            ("per_device_batch", args.per_device_batch), ("dim", args.dim),
            ("model_dim", args.model_dim), ("lanes_2d", args.lanes_2d),
            ("n_2d", args.n_2d)) if v is not None})
    if worlds[0] != 1 or sorted(set(worlds)) != worlds:
        raise ValueError(f"sizes must rise from 1, got {worlds}")
    if args.device == "cuda" and worlds[-1] > cards:
        raise ValueError(f"a world of {worlds[-1]} needs as many cards; "
                         f"{cards} visible")
    if len(mesh_2d) != 2 or mesh_2d[0] * mesh_2d[1] not in worlds:
        raise ValueError(f"the 2-D mesh {mesh_2d} must span one of the "
                         f"worlds {worlds}")
    for w in worlds:
        check_shards(sizes.model_dim, w)
    check_shards(sizes.n_2d, mesh_2d[1])

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    run_dir = tempfile.mkdtemp(prefix="scaling_",
                               dir=os.path.join(ROOT, "build"))
    results = {
        w: run_world(w, args.device, sizes,
                     mesh_2d if w == mesh_2d[0] * mesh_2d[1] else None,
                     os.path.join(run_dir, f"w{w}"))
        for w in worlds}
    shutil.rmtree(run_dir)
    print(json.dumps(report(results, sizes, worlds, mesh_2d, args.device,
                            cards, card)))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[3], int(sys.argv[2])))
    try:
        sys.exit(main())
    except (RuntimeError, ValueError) as e:
        print(f"scaling: {e}", file=sys.stderr)
        sys.exit(1)
