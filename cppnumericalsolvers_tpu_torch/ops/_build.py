"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
Libraries go to ``build/torch_kernels/`` in the directory that holds the
package (the repository root in a checkout), named by a hash of the source
and the flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load_flat_trip"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)


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
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
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
            f"nvcc failed for {src.name} ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_flat_trip() -> ctypes.CDLL:
    """The flat-trip library with its C signatures declared."""
    lib = ctypes.CDLL(str(build("flat_trip")))
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for fn in (lib.cppns_flat_trip_f32, lib.cppns_flat_trip_f64):
        fn.argtypes = [p] * 12 + [i] * 4 + [d] * 4 + [i] * 6 + [p]
        fn.restype = i
    lib.cppns_error_string.argtypes = [i]
    lib.cppns_error_string.restype = ctypes.c_char_p
    return lib
