"""ctypes bindings for the native C++ oracle library (native/cppns_oracle.cc).

The port's own copy of the JAX package's binding, over the same library.
The oracle provides independent implementations of the framework's hardest
numerics — MINPACK ``cstep`` and hand-derived MGH gradients — used by the
test suite for cross-language validation of the port's PyTorch versions.
It is a test oracle on the host, not a device path: it takes Python floats,
numpy arrays or tensors on the CPU and returns Python floats.  Built on
demand with the system compiler (native/build.sh); ``load_oracle`` returns
``None`` when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

__all__ = ["load_oracle", "NativeOracle", "MGH_ORACLE_IDS"]

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB = _NATIVE_DIR / "libcppns_oracle.so"

# Problem ids understood by mgh_eval (keep in sync with cppns_oracle.cc).
MGH_ORACLE_IDS = {
    "rosenbrock": (0, 2),
    "beale": (1, 2),
    "helical_valley": (2, 3),
    "powell_singular": (3, 4),
    "wood": (4, 4),
    "freudenstein_roth": (5, 2),
}


def _host_floats(x) -> list[float]:
    """The values of a sequence, numpy array or CPU tensor as floats."""
    if hasattr(x, "detach"):
        if x.device.type != "cpu":
            raise ValueError(
                f"the oracle reads host memory; got a tensor on {x.device}")
        x = x.detach().numpy()
    return [float(v) for v in np.asarray(x, dtype=np.float64).ravel()]


class NativeOracle:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.cstep_oracle.restype = ctypes.c_int
        lib.cstep_oracle.argtypes = [
            ctypes.POINTER(ctypes.c_double)
        ] * 7 + [
            ctypes.c_double,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_double,
            ctypes.c_double,
        ]
        lib.mgh_eval.restype = ctypes.c_int
        lib.mgh_eval.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
        ]

    def cstep(
        self, stx, fx, dx, sty, fy, dy, stp, fp, dp, brackt, stpmin, stpmax
    ):
        """Run MINPACK cstep; returns (info, dict-of-updated-scalars)."""
        c = ctypes.c_double
        vals = {
            "stx": c(stx), "fx": c(fx), "dx": c(dx),
            "sty": c(sty), "fy": c(fy), "dy": c(dy), "stp": c(stp),
        }
        br = ctypes.c_int(int(brackt))
        info = self._lib.cstep_oracle(
            ctypes.byref(vals["stx"]), ctypes.byref(vals["fx"]),
            ctypes.byref(vals["dx"]), ctypes.byref(vals["sty"]),
            ctypes.byref(vals["fy"]), ctypes.byref(vals["dy"]),
            ctypes.byref(vals["stp"]), c(fp), c(dp), ctypes.byref(br),
            c(stpmin), c(stpmax),
        )
        out = {k: v.value for k, v in vals.items()}
        out["brackt"] = bool(br.value)
        return info, out

    def mgh(self, name: str, x):
        """Value + analytic gradient for an oracle-known MGH function."""
        problem_id, n = MGH_ORACLE_IDS[name]
        vals = _host_floats(x)
        if len(vals) != n:
            raise ValueError(f"{name} takes {n} values, got {len(vals)}")
        arr = (ctypes.c_double * n)(*vals)
        f = ctypes.c_double()
        g = (ctypes.c_double * n)()
        rc = self._lib.mgh_eval(
            problem_id, arr, n, ctypes.byref(f), g
        )
        if rc != 0:
            raise RuntimeError(f"mgh_eval failed for {name}")
        return f.value, list(g)


def load_oracle(build: bool = True) -> NativeOracle | None:
    """Load (building if needed) the oracle library; None if unavailable."""
    if not _LIB.exists() and build:
        try:
            subprocess.run(
                ["sh", str(_NATIVE_DIR / "build.sh")],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            return None
    if not _LIB.exists():
        return None
    try:
        return NativeOracle(ctypes.CDLL(str(_LIB)))
    except OSError:
        return None
