"""What the examples share: the ``--device`` flag and a solve's figures."""

from __future__ import annotations

import argparse


def parse_device(description: str, extra=None) -> argparse.Namespace:
    """The examples' command line: ``--device`` (default ``cuda``), and
    whatever ``extra(parser)`` adds.  On the CPU PyTorch keeps one thread,
    as the tests run it."""
    import torch

    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    if extra is not None:
        extra(parser)
    args = parser.parse_args()
    if args.device == "cpu":
        torch.set_num_threads(1)
    return args


def figures(result) -> dict:
    """x, f, iterations, nfev and status of an un-batched solve's result
    (a ``MinimizeResult`` or an ``AlResult``), as Python values; ``trips``
    is the solve's batched evaluations where the result counts them."""
    state, progress = result.state, result.progress
    out = {
        "x": [float(v) for v in state.x.detach().cpu().reshape(-1)],
        "iterations": int(progress.num_iterations),
        "nfev": int(state.nfev),
        "status": int(progress.status),
    }
    if hasattr(state, "value"):
        out["f"] = float(state.value)
    if hasattr(state, "max_violation"):
        out["max_violation"] = float(state.max_violation)
    out["trips"] = int(getattr(result, "trips", 0))
    return out


def join_world(device=None) -> bool:
    """Join the default process group unless it is up: as ``torchrun``
    launched this process (its ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``), else as a world of one (an in-memory store, no
    port).  NCCL on the card, gloo on the CPU; the card raises where there
    is none.  Returns whether it joined (the caller then leaves)."""
    import os

    import torch
    import torch.distributed as dist

    from cppnumericalsolvers_tpu_torch.core.driver import resolve_device
    from cppnumericalsolvers_tpu_torch.parallel import initialize_distributed

    if dist.is_initialized():
        return False
    kind = resolve_device(device).type
    backend = "nccl" if kind == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        initialize_distributed(backend=backend)
    else:
        initialize_distributed(backend=backend, store=dist.HashStore(),
                               rank=0, world_size=1)
    if kind != "cuda":
        torch.set_num_threads(1)
    return True


def lanes(result) -> dict:
    """A batched result's per-lane tensors on the host: x, f, nfev,
    iterations and status."""
    out = {"x": result.state.x, "nfev": result.state.nfev,
           "iterations": result.progress.num_iterations,
           "status": result.progress.status}
    if hasattr(result.state, "value"):
        out["f"] = result.state.value
    return {k: v.detach().cpu() for k, v in out.items()}
