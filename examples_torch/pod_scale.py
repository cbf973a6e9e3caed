"""Pod-scale batched solving: many instances split over every rank.

PyTorch counterpart of examples/pod_scale.py: a batch of 128 instances a
rank of the extended Rosenbrock at n = 16, float32, is split over every
rank of the default process group (``parallel.minimize_sharded``); each
rank's loop retires its own lanes (the flat solve, one ``flat_trip``
launch a trip on the card) with no collective inside it, and every rank
gets the whole result back.

Run on every card of a host (NCCL):
  torchrun --nproc-per-node <cards> examples_torch/pod_scale.py
As a world of one, without torchrun:
  python examples_torch/pod_scale.py [--device cuda|cpu]
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from cppnumericalsolvers_tpu_torch import objective  # noqa: E402
from cppnumericalsolvers_tpu_torch.parallel import (  # noqa: E402
    aggregate_metrics,
    make_mesh,
    minimize_sharded,
)
from cppnumericalsolvers_tpu_torch.parallel.comm import (  # noqa: E402
    rank_device)
from cppnumericalsolvers_tpu_torch.solvers import Lbfgs  # noqa: E402
from examples_torch import _common  # noqa: E402

LANES_PER_RANK = 128
DIM = 16


def ext_rosenbrock(x):
    even, odd = x[0::2], x[1::2]
    return torch.sum(100.0 * (odd - even ** 2) ** 2 + (1.0 - even) ** 2)


def starts(batch: int) -> np.ndarray:
    """The original's seed-0 starts, float32: the first 128 lanes are a
    world of one's whatever the world."""
    rng = np.random.default_rng(0)
    return rng.uniform(-2.0, 2.0, size=(batch, DIM)).astype(np.float32)


def main(device=None) -> dict:
    joined = _common.join_world(device)
    try:
        dev = rank_device(device)
        mesh = make_mesh(device=dev)
        n_dev = mesh.size()
        batch = LANES_PER_RANK * n_dev
        x0 = torch.from_numpy(starts(batch))

        if dist.get_rank() == 0:
            print(f"solving {batch} Rosenbrock-{DIM} instances over {n_dev} "
                  "rank(s)")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        result = minimize_sharded(objective(ext_rosenbrock, mode="first"),
                                  x0, Lbfgs(), mesh=mesh, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0

        metrics = aggregate_metrics(result)
        if dist.get_rank() == 0:
            print(
                f"converged {metrics['converged_pct']:.1f}%  "
                f"mean nfev {metrics['mean_nfev']:.1f}  "
                f"mean iters {metrics['mean_iterations']:.1f}  "
                f"wall {wall:.2f}s (incl. first use)"
            )
            print("result gathered on every rank:",
                  tuple(result.state.x.shape))
        return {"metrics": metrics, "wall_s": wall, "ranks": n_dev,
                "trips": result.trips, **_common.lanes(result)}
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main(_common.parse_device(__doc__.splitlines()[0]).device)
