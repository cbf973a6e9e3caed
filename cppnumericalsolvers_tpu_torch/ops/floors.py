"""The two calibration kernels of the bench's bound, with their plain
versions.

PyTorch counterparts of the Pallas kernels inside
``benchmarks/roofline.py``'s ``measure_loop_trip_overhead_us`` (its
``tiny_kernel``, :560) and ``measure_launch_overhead_us`` (:640).  Neither
does solver work: ``benchmarks_torch/roofline.py`` runs them to measure the
floor of one eager trip of the port (an evaluation, one launch, one status
read) and the cost of one launch of the port's kernels, which set the
per-trip term of ``bench_torch.py``'s bound.  Both launch through
``_kernel.launch``, the path of the port's solver kernels, and nothing on
that path synchronises or reads the card, so a chain of either can be
captured in a CUDA graph (a captured launch counts once, when captured).

CPU tensors take the plain versions; CUDA tensors launch the kernel or
raise.
"""

from __future__ import annotations

import torch

from ._kernel import check_args, check_float, launch

__all__ = [
    "TRIP_FLOOR_BUFFERS",
    "launch_floor",
    "launch_floor_reference",
    "trip_floor",
    "trip_floor_reference",
]

#: Buffers one trip-floor launch updates (roofline.py's ``NBUF``).
TRIP_FLOOR_BUFFERS = 8


def trip_floor_reference(bufs):
    """Every buffer of ``bufs`` updated in place to ``b * 0.999 + 1e-6``
    (two rounded operations); returns ``bufs``."""
    for b in bufs:
        b.mul_(0.999).add_(1e-6)
    return bufs


def trip_floor(bufs):
    """:func:`trip_floor_reference` on ``TRIP_FLOOR_BUFFERS`` tensors of one
    shape and float dtype, in place, by one launch of ``csrc/trip_floor.cu``
    for CUDA tensors.  ``trip_floor.launches`` counts kernel launches."""
    bufs = tuple(bufs)
    if len(bufs) != TRIP_FLOOR_BUFFERS:
        raise ValueError(f"trip_floor takes {TRIP_FLOOR_BUFFERS} buffers, "
                         f"got {len(bufs)}")
    shape, dtype = tuple(bufs[0].shape), bufs[0].dtype
    check_float("trip_floor", dtype)
    dev = check_args("trip_floor", {f"buffer {i}": (b, shape, dtype)
                                    for i, b in enumerate(bufs)})
    if dev.type == "cpu":
        return trip_floor_reference(bufs)
    launch("trip_floor", dev, dtype, bufs, (bufs[0].numel(),))
    trip_floor.launches += 1
    return bufs


trip_floor.launches = 0


def launch_floor_reference(x, out=None):
    """``x + 1``, into ``out`` where given."""
    return torch.add(x, 1.0, out=out)


def launch_floor(x, out=None):
    """:func:`launch_floor_reference` by one launch of
    ``csrc/launch_floor.cu`` (one block) for a CUDA tensor; ``out`` (of
    ``x``'s shape and dtype, not ``x`` itself) is allocated where not given.
    ``launch_floor.launches`` counts kernel launches."""
    check_float("launch_floor", x.dtype)
    if out is None:
        out = torch.empty_like(x)
    if out.data_ptr() == x.data_ptr():
        raise ValueError("launch_floor: out must not be x")
    dev = check_args("launch_floor", {
        "x": (x, tuple(x.shape), x.dtype),
        "out": (out, tuple(x.shape), x.dtype)})
    if dev.type == "cpu":
        return launch_floor_reference(x, out)
    launch("launch_floor", dev, x.dtype, (x, out), (x.numel(),))
    launch_floor.launches += 1
    return out


launch_floor.launches = 0
