"""What every kernel wrapper of the port does around its launch: check the
tensors it was given, check that the block's shared memory fits, and launch
on PyTorch's current stream.  A wrapper runs its kernel's plain version only
for CPU tensors; for CUDA tensors it launches or raises.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["SMEM_LIMIT", "check_args", "check_float", "check_smem", "launch",
           "two_loop_smem_bytes"]

# Shared memory one block may use on Hopper (232,448 bytes).
SMEM_LIMIT = 227 * 1024
_MAX_WARPS = 8
_RED_SLOTS = 8


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
