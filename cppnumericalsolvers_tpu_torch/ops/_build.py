"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
Libraries go to ``build/torch_kernels/`` in the directory that holds the
package (the repository root in a checkout), named by a hash of the source,
the shared headers and the flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["BUILD_DIR", "KERNELS", "NVCC_FLAGS", "build", "build_all", "load",
           "parse_ptxas", "ptxas_report"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_HEADERS = sorted(_CSRC.glob("*.cuh"))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_CRIT = [_D] * 4 + [_I] * 6
#: Kernel name -> argument types of its two C entry points
#: (``cppns_<name>_f32`` and ``cppns_<name>_f64``).
KERNELS = {
    "flat_trip": [_P] * 12 + [_I] * 7 + _CRIT + [_P],
    "mt_trip": [_P] * 8 + [_I] * 6 + [_P],
    "lbfgs_prologue": [_P] * 13 + [_I] * 6 + [_P],
    "lbfgs_epilogue": [_P] * 22 + [_I] * 5 + _CRIT + [_P],
    "lbfgs_prologue_t": [_P] * 14 + [_I] * 6 + [_P],
    "push_two_loop": [_P] * 9 + [_I] * 6 + [_P],
    "two_loop": [_P] * 6 + [_I] * 6 + [_P],
    # MGH 21's batched value and gradient (ops/objectives.py).
    "pairwise_rosenbrock": [_P] * 3 + [_I] * 4 + [_P],
    # The calibration kernels of benchmarks_torch/roofline.py (ops/floors.py).
    "trip_floor": [_P] * 8 + [_I] + [_P],
    "launch_floor": [_P] * 2 + [_I] + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns the library's path."""
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + b"".join(h.read_bytes() for h in _HEADERS)
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    # ptxas -v: registers, shared memory and spills of every kernel.
    lib.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def parse_ptxas(text: str) -> list:
    """``[(kernel symbol, registers, spill stores, spill loads, stack frame
    bytes)]`` from ptxas's ``-v`` output.  A register array indexed at run
    time goes to the stack frame (local memory) without a spill line, so
    the frame is reported beside the spills."""
    out, fn, props = [], None, None
    for line in text.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            fn, stores, loads, stack = found.group(1), 0, 0, 0
        found = re.search(r"Function properties for (\w+)", line)
        if found:
            props = found.group(1)
        frame = re.search(r"(\d+) bytes stack frame", line)
        if frame and fn and props == fn:
            stack = int(frame.group(1))
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill and fn and props == fn:
            stores, loads = int(spill.group(1)), int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and fn:
            out.append((fn, int(regs.group(1)), stores, loads, stack))
            fn = None
    return out


def ptxas_report(name: str) -> list:
    """:func:`parse_ptxas` of the built library of kernel ``name``."""
    return parse_ptxas(build(name).with_suffix(".ptxas.txt").read_text())


def build_all() -> dict:
    """:func:`build` every kernel, one ``nvcc`` per source, all started
    together; returns ``{name: library path}``."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        return dict(zip(KERNELS, pool.map(build, KERNELS)))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library of kernel ``name`` with its C signatures declared."""
    lib = ctypes.CDLL(str(build(name)))
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"cppns_{name}_{suffix}")
        fn.argtypes = KERNELS[name]
        fn.restype = _I
    lib.cppns_error_string.argtypes = [_I]
    lib.cppns_error_string.restype = ctypes.c_char_p
    return lib

