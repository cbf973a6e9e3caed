"""What every kernel wrapper of the port does around its launch: check the
tensors it was given, check that the block's shared memory fits, and launch
on PyTorch's current stream.  A wrapper runs its kernel's plain version only
for CPU tensors; for CUDA tensors it launches or raises.
"""

from __future__ import annotations

import ctypes

import torch

import dataclasses

__all__ = ["SMEM_LIMIT", "LaneMapping", "check_args", "check_float",
           "check_smem", "lane_mapping", "lane_threads", "launch",
           "mapping_smem_bytes", "two_loop_smem_bytes"]

# Shared memory one block may use on Hopper (232,448 bytes).
SMEM_LIMIT = 227 * 1024
_MAX_WARPS = 8
_RED_SLOTS = 8
_SMS = 132  # streaming multiprocessors of an H100 SXM


def check_args(op: str, expect: dict) -> torch.device:
    """``expect`` maps a name to ``(tensor, shape, dtype)``.  Raises unless
    every tensor has that shape and dtype, is contiguous and lies on the
    first one's device; returns that device."""
    dev = next(iter(expect.values()))[0].device
    for name, (t, shape, dt) in expect.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != dt:
            raise ValueError(
                f"{op}: {name} must be {dt} of shape {tuple(shape)}, got "
                f"{t.dtype} of shape {tuple(t.shape)}"
            )
        if t.device != dev:
            raise ValueError(
                f"{op}: {name} is on device {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    return dev


def check_float(op: str, dtype) -> None:
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{op} supports float32/float64, got {dtype}")


def two_loop_smem_bytes(m: int, n: int, itemsize: int) -> int:
    """Dynamic shared memory of one block that runs the two-loop: ``q`` (n
    values), per-row alpha/rho (m each), the usable flags and the
    block-reduction scratch."""
    return (_RED_SLOTS * _MAX_WARPS + 2 * m + n) * itemsize + 4 * m


def check_smem(op: str, m: int, n: int, itemsize: int) -> None:
    smem = two_loop_smem_bytes(m, n, itemsize)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"{op}: n={n}, m={m} needs {smem} bytes of shared memory "
            f"per block, more than the {SMEM_LIMIT} a Hopper block has"
        )


# The lane mapping of the redesigned kernels (csrc/staged.cuh).
_WARP_N_MAX = 64          # a lane is one warp up to this n
_LANE_MAX_THREADS = 512   # else one block of up to this many threads
_LANE_MAX_WARPS = _LANE_MAX_THREADS // 32
_MAX_LANES_PER_BLOCK = 8
#: Where the two-loop reads the history rows (staged.cuh ``ROWS_*``;
#: ``ROWS_REGISTERS``, the whole history held in a warp's registers, is
#: push_two_loop.cu's alone, at n <= 64 and m <= ``_REG_ROWS``).
ROWS_STREAM, ROWS_STAGED, ROWS_DIRECT, ROWS_REGISTERS = 0, 1, 2, 3
_REG_ROWS = 10
_ELEMENTS_PER_THREAD = 8  # of a row, for n > 64
# The prologue stages a lane's rows where four such lanes fit an SM, the
# fused push where eight do (lane_sweep.py: at (1024, 256) staging was the
# faster in float32, 22 KB a lane, streaming in float64, 45 KB a lane).
_STAGE_LIMIT = {"lbfgs_prologue": SMEM_LIMIT // 4,
                "push_two_loop": SMEM_LIMIT // 8}
# The epilogue splits a lane over a cluster of up to 4 blocks while the
# grid has fewer blocks than the card has SMs, each block keeping at least
# 64 threads of 8 elements (lane_sweep.py: at (256, 4096), two blocks per
# SM, a cluster of 2 was slower than a block per lane).
_CLUSTER_MAX = 4
_CLUSTER_SLICE_MIN = 64 * _ELEMENTS_PER_THREAD


@dataclasses.dataclass(frozen=True)
class LaneMapping:
    """How a redesigned kernel maps lanes to threads: ``threads_per_lane``
    (32: one warp per lane, ``lanes_per_block`` lanes in a block; else one
    lane per block, or per cluster of ``cluster`` blocks that split its
    threads evenly), where its two-loop reads the history ``rows``
    (``ROWS_STAGED``: copied into shared memory; ``ROWS_STREAM``: streamed
    through shared-memory row buffers; ``ROWS_DIRECT``: from device memory
    in place; ``ROWS_REGISTERS``: held in registers), the block's shared
    memory and the grid."""

    lanes_per_block: int
    threads_per_lane: int
    rows: int
    smem_bytes: int
    blocks: int
    cluster: int = 1

    def scalars(self) -> tuple:
        """The three ints the C entry points take after ``b, n, m``
        (``lbfgs_epilogue`` reads no rows: it takes lanes per block,
        threads per lane and ``cluster`` after ``b, n``)."""
        return (self.lanes_per_block, self.threads_per_lane, self.rows)


def lane_smem_bytes(m: int, n: int, itemsize: int, rows: int,
                    lanes: int = 1, warp: bool = True) -> int:
    """Shared memory of a block of ``lanes`` lanes (csrc/staged.cuh
    ``lane_values`` and ``mapping_smem``): per lane alpha, rho, s.y and the
    usable flag per row, q, and the staged rows (2 m n) or the stream's two
    row buffers of s and y (4 n); a block-per-lane block adds its reduction
    scratch."""
    extra = {ROWS_STAGED: 2 * m * n, ROWS_STREAM: 4 * n, ROWS_DIRECT: 0,
             ROWS_REGISTERS: 0}
    lane = (4 * m + n + extra[rows]) * itemsize
    red = 0 if warp else 2 * _RED_SLOTS * _LANE_MAX_WARPS * itemsize
    return lanes * lane + red


def lane_threads(n: int) -> int:
    """Threads a lane gets at width ``n``: one warp for n <= 64, else 64 to
    512, each owning 8 elements of a row.  The batch-minor prologue adds its
    sums in the order these threads give (``fused_step_t.py``)."""
    if n <= _WARP_N_MAX:
        return 32
    return min(_LANE_MAX_THREADS,
               max(64, -(-n // (32 * _ELEMENTS_PER_THREAD)) * 32))


def _pick(op: str, b: int, n: int, m: int, itemsize: int):
    """``(lanes per block, threads per lane, rows, shared memory,
    cluster)``."""
    warp = n <= _WARP_N_MAX
    tpl = lane_threads(n)
    lpb = min(_MAX_LANES_PER_BLOCK, max(1, b // (2 * _SMS)))
    red = 2 * _RED_SLOTS * _LANE_MAX_WARPS * itemsize
    if op in ("mt_trip", "lbfgs_epilogue"):
        # No history: the block-per-lane kernel's only shared memory is
        # its reduction scratch (static).
        if warp:
            return lpb, 32, ROWS_DIRECT, 0, 1
        cl = 1
        while (op == "lbfgs_epilogue" and cl < _CLUSTER_MAX
               and b * cl < _SMS
               and n >= 2 * cl * _CLUSTER_SLICE_MIN):
            cl *= 2
        return 1, cl * lane_threads(-(-n // cl)), ROWS_DIRECT, red, cl
    if warp:
        rows = (ROWS_REGISTERS if op == "push_two_loop" and m <= _REG_ROWS
                else ROWS_DIRECT)
        return lpb, 32, rows, lane_smem_bytes(m, n, itemsize, rows, lpb), 1

    def smem(rows):
        return lane_smem_bytes(m, n, itemsize, rows, 1, False)

    rows = ROWS_STREAM
    if smem(ROWS_STAGED) <= _STAGE_LIMIT.get(op, 0):
        rows = ROWS_STAGED
    if smem(rows) > SMEM_LIMIT:
        rows = ROWS_DIRECT
    return 1, tpl, rows, smem(rows), 1


def mapping_smem_bytes(op: str, b: int, n: int, m: int, itemsize: int
                       ) -> int:
    """Shared memory of one block under :func:`lane_mapping`'s choice,
    whether or not it fits."""
    return _pick(op, b, n, m, itemsize)[3]


def lane_mapping(op: str, b: int, n: int, m: int, itemsize: int
                 ) -> LaneMapping:
    """Pick the lane mapping of ``flat_trip``, ``lbfgs_prologue``,
    ``push_two_loop``, ``mt_trip`` or ``lbfgs_epilogue`` (``op``) for a
    ``(b, n)`` batch with ``m`` history rows (the last two have none and
    ignore ``m``).  The rules follow a sweep of every mapping on the card
    (``lane_sweep.py``; PERF.md).

    * n <= 64: a warp per lane, reductions by shuffles alone, the rows read
      in place (at n = 32 a row is one cache line); ``b // 264`` lanes per
      block (so there are at least two blocks per SM), between 1 and 8; the
      last block may be ragged.  The fused push holds the whole history in
      registers instead where m <= 10 (``ROWS_REGISTERS``): its two-loop
      then waits on no load.
    * larger n: one block per lane of 64 to 512 threads, each owning 8
      elements of a row, which streams the rows through shared memory:
      small blocks keep many lanes in flight.  The prologue and the fused
      push (``push_two_loop``), where every live lane runs the two-loop,
      copy the rows into shared memory instead where four (the push: eight)
      such lanes fit an SM (n = 256 at m = 10 in float32); above that the
      shared memory it takes costs more lanes in flight than the reads it
      saves.  Where the stream's row buffers do not fit a block (n > 5,752
      in float64 and 11,563 in float32 at m = 10) the rows are read in
      place (``ROWS_DIRECT``), whose shared memory is q and the per-row
      scalars: that reaches n = 28,760 in float64 and 57,816 in float32.
      ``mt_trip`` and ``lbfgs_epilogue`` read no history (``ROWS_DIRECT``)
      and hold their 8 elements a thread in registers; the epilogue splits
      a lane over a cluster of 2 or 4 blocks while ``b`` times the cluster
      is below the card's 132 SMs and each block keeps at least 512
      elements.

    Raises ``ValueError`` where the chosen layout does not fit a block."""
    lpb, tpl, rows, need, cl = _pick(op, b, n, m, itemsize)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{op}: n={n}, m={m} needs {need} bytes of shared memory per "
            f"block, more than the {SMEM_LIMIT} a Hopper block has"
        )
    return LaneMapping(lpb, tpl, rows, need, -(-b // lpb) * cl, cl)


def launch(name: str, dev: torch.device, dtype, tensors, scalars=()) -> None:
    """Launch kernel ``name`` (``csrc/<name>.cu``, built at first use) on
    ``dev``'s current stream: the tensors' pointers, then ``scalars``, then
    the stream.  Raises if the kernel does not build or the launch is
    refused (a refused launch never runs, and no later synchronise reports
    it)."""
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    from . import _build

    lib = _build.load(name)
    suffix = "f32" if dtype == torch.float32 else "f64"
    ptr = ctypes.c_void_p
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"cppns_{name}_{suffix}")(
            *(ptr(t.data_ptr()) for t in tensors), *scalars, ptr(stream))
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {err} "
            f"({lib.cppns_error_string(err).decode()})"
        )
