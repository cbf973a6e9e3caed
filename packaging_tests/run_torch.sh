#!/usr/bin/env bash
# Packaging test of the PyTorch/CUDA port, cppnumericalsolvers_tpu_torch
# (run.sh's TEST 3 checks the JAX package's surface only).  Offline, on the
# CPU, following run.sh's recipe:
#   1. build the wheel and the sdist with --no-build-isolation;
#   2. check that each carries every ops/csrc/*.cu and *.cuh of the
#      checkout (pyproject.toml's package-data): the port builds its
#      kernels from them at first use;
#   3. install each into a venv with --system-site-packages (torch and
#      numpy come from the host) and, from a neutral working directory,
#      import the installed port on the CPU: every name of its __all__
#      lists resolves, parallel.minimize_model_sharded among them, the
#      installed csrc holds the sources, a small solve runs on the CPU, and
#      neither JAX nor the JAX package was imported.
#
#   bash packaging_tests/run_torch.sh        # from anywhere; exit 0: passed
set -euo pipefail

REPO="$(cd "$(dirname "$0")/.." && pwd)"
WORK="$(mktemp -d -t cppns_torch_pkg.XXXXXX)"
trap 'rm -rf "$WORK"' EXIT
cd "$REPO"

echo "== build sdist + wheel =="
python -m pip wheel . --no-deps --no-build-isolation -w "$WORK/dist" -q
python - "$WORK/dist" <<'EOF'
import sys
from setuptools import build_meta
print("sdist:", build_meta.build_sdist(sys.argv[1]))
EOF
WHEEL="$(ls "$WORK"/dist/*.whl)"
SDIST="$(ls "$WORK"/dist/*.tar.gz)"
echo "wheel: $WHEEL"
echo "sdist: $SDIST"

echo "== the kernel sources in each artifact =="
python - "$REPO" "$WHEEL" "$SDIST" <<'EOF'
import glob, os, sys, tarfile, zipfile
repo, wheel, sdist = sys.argv[1:]
csrc = "cppnumericalsolvers_tpu_torch/ops/csrc"
want = sorted(os.path.basename(p)
              for ext in ("*.cu", "*.cuh")
              for p in glob.glob(os.path.join(repo, csrc, ext)))
assert want, "no kernel source in the checkout"
with zipfile.ZipFile(wheel) as z:
    in_wheel = {n for n in z.namelist() if n.startswith(csrc + "/")}
with tarfile.open(sdist) as t:
    in_sdist = {n.split("/", 1)[1] for n in t.getnames() if "/" in n}
for label, names in (("wheel", in_wheel), ("sdist", in_sdist)):
    missing = [f for f in want if f"{csrc}/{f}" not in names]
    assert not missing, f"{label} lacks {missing}"
    print(f"{label}: all {len(want)} kernel sources")
EOF

HOST_SITE="$(python -c 'import numpy, os; print(os.path.dirname(os.path.dirname(numpy.__file__)))')"

check_install() {
  local venv="$1" artifact="$2" label="$3"
  echo "== $label: install + import surface =="
  python -m venv --system-site-packages "$venv"
  local site
  site="$("$venv/bin/python" -c 'import site; print(site.getsitepackages()[0])')"
  echo "$HOST_SITE" > "$site/host_deps.pth"
  "$venv/bin/python" -m pip install --no-deps --no-build-isolation -q "$artifact"
  (cd "$WORK" && "$venv/bin/python" - "$REPO" "$site" <<'EOF'
import importlib, os, sys
repo, site = sys.argv[1:]
import torch
import cppnumericalsolvers_tpu_torch as cns
where = os.path.dirname(cns.__file__)
assert where.startswith(site), f"imported from {where}, not the install"
for mod in ("", ".core", ".linesearch", ".models", ".ops", ".parallel",
            ".solvers", ".utils"):
    m = importlib.import_module("cppnumericalsolvers_tpu_torch" + mod)
    for name in getattr(m, "__all__", ()):
        assert hasattr(m, name), f"missing public symbol {mod}.{name}"
from cppnumericalsolvers_tpu_torch.parallel import minimize_model_sharded
csrc = os.path.join(where, "ops", "csrc")
have = sorted(os.listdir(csrc))
want = sorted(os.listdir(os.path.join(repo, "cppnumericalsolvers_tpu_torch",
                                      "ops", "csrc")))
assert have == want, (have, want)
torch.set_num_threads(1)
res = cns.minimize(cns.models.rosenbrock(),
                   torch.tensor([-1.2, 1.0], dtype=torch.float64),
                   cns.Lbfgs(m=10), device="cpu")
assert int(res.progress.status) in cns.CONVERGED_STATUSES, res.progress
assert float((res.state.x - 1.0).abs().max()) < 1e-4, res.state.x
jax_mods = [m for m in sys.modules
            if m.split(".")[0] in ("jax", "cppnumericalsolvers_tpu")]
assert not jax_mods, jax_mods
print("import surface: ok;", len(have), "kernel sources installed; "
      "Rosenbrock solved on the CPU")
EOF
  )
}

check_install "$WORK/venv_wheel" "$WHEEL" "wheel"
check_install "$WORK/venv_sdist" "$SDIST" "sdist"

echo "port packaging tests: ALL PASSED"
