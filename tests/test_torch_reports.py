"""The port's reports and its packaging, on the CPU:

* ``benchmarks_torch/compare_scipy.py`` against the JAX package's
  ``benchmarks/compare_scipy.py`` on the MGH suite's first problems
  (float64, one attempt per instance on each side);
* ``benchmarks_torch/trace_table.py`` on a Chrome trace that
  ``torch.profiler`` writes here (no device event: no table) and on a small
  hand-made trace carrying the port's kernel names;
* ``benchmarks/instance_diff.py`` (it imports neither package) on two of the
  port suite's per-instance artifacts, as ``suite_bench.py`` writes them;
* pyproject.toml's package-data covering every kernel source of the port
  (the wheel and sdist themselves: ``packaging_tests/run_torch.sh``).
"""

import importlib.util
import json
import os
import tomllib

import numpy as np
import pytest
import torch

import bench
from benchmarks_torch import compare_scipy, trace_table
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.models import mgh_benchmark_instances
import suite_bench

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The suite's first problems (Rosenbrock to Bard: 56 instances).
PROBLEMS = 8
#: Mean nfev over the compared instances, the ROADMAP's full-solve
#: contract: which rung stops a lane, and the evaluations it took, follow
#: the sums' last bits on ill-conditioned problems (JAX against the port:
#: 10 of the 56 instances apart, by 2 to 39, on Rosenbrock, Powell badly
#: scaled, Jennrich-Sampson and the helical valley; SciPy driven by either
#: package's gradient: 10, by 1 to 39).
MEAN_NFEV_TOL = 3.0


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_compare():
    return _load(os.path.join(ROOT, "benchmarks", "compare_scipy.py"),
                 "jax_compare_scipy")


@pytest.fixture(scope="module")
def batches():
    return (bench.benchmark_batches()[:PROBLEMS],
            mgh_benchmark_instances(suite_bench.TOTAL_INSTANCES,
                                    seed=0)[:PROBLEMS])


def test_same_instances(batches):
    for (jp, jx), (tp, tx) in zip(*batches):
        assert jp.name == tp.name
        np.testing.assert_array_equal(np.asarray(jx), tx)


def _held(got, want):
    (ok, nfev), (jok, jnfev) = got, want
    np.testing.assert_array_equal(ok, jok)
    assert abs(float(nfev.mean()) - float(jnfev.mean())) <= MEAN_NFEV_TOL


def test_ours_matches_jax_run_ours(batches, jax_compare):
    """The port's single float64 attempt: every instance's success as the
    JAX script's ``run_ours``, mean nfev within the contract."""
    jb, tb = batches
    want = jax_compare.run_ours(jb, bench.reliability_solver(),
                                bench.reliability_stopping())
    _held(compare_scipy.run_ours(tb, "cpu"), want)


def test_scipy_side_matches_the_jax_script(batches, jax_compare):
    jb, tb = batches
    _held(compare_scipy.run_scipy(tb), jax_compare.run_scipy(jb))


def test_compare_keys_are_the_jax_scripts():
    ok = np.array([True, True, False, True])
    out = compare_scipy.compare(ok, np.array([3.0, 5.0, 9.0, 4.0]),
                                np.array([True, True, True, False]),
                                np.array([4.0, 5.0, 2.0, 1.0]), 1.0, 2.0)
    assert out["both_solved"] == 2
    assert (out["nfev_wins"], out["nfev_ties"], out["nfev_losses"]) == (
        1, 1, 0)
    assert out["nfev_first_place"] == 1.5
    assert out["ours_converged_pct"] == 75.0
    assert set(out) == {
        "metric", "total_instances", "ours_converged_pct",
        "scipy_converged_pct", "ours_mean_nfev", "scipy_mean_nfev",
        "both_solved", "nfev_wins", "nfev_ties", "nfev_losses",
        "nfev_first_place", "ours_wall_s", "scipy_wall_s"}


def test_compare_scipy_needs_a_card_unless_told(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert compare_scipy.main([]) == 1
    assert capsys.readouterr().out == ""


# trace_table ---------------------------------------------------------------


def test_trace_from_the_profiler_on_the_cpu(tmp_path, capsys):
    """``record`` writes torch.profiler's own Chrome trace; taken on the
    CPU it holds no device event, so no table: SystemExit, and exit 1
    through the command line."""
    path = str(tmp_path / "cpu_trace.json")
    iters = trace_table.record(4, 8, path, device="cpu")
    assert iters > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    assert trace_table.load_device_events(path) == []
    with pytest.raises(SystemExit, match="no device event"):
        trace_table.format_table(path)
    assert trace_table.main([path]) == 1
    assert capsys.readouterr().out == ""


def _event(name, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": 0, "dur": dur}


def test_trace_grouped_by_the_ports_kernels(tmp_path):
    trace = {"traceEvents": [
        _event("void flat_trip_kernel<float, true, false>(Args<float>)", 300),
        _event("void flat_trip_kernel<float, true, false>(Args<float>)", 300),
        _event("void prologue_kernel<double, false, false>(Args<double>)",
               100),
        _event("void prologue_t_kernel<float, 8, 2>(Args<float>)", 50),
        _event("void push_two_loop_regs_kernel<float>(Args<float>)", 40),
        _event("void two_loop_kernel<float, true, false>(Args<float>)", 60),
        _event("void mt_trip_kernel<float, true, false>(Args<float>)", 20),
        _event("void epilogue_kernel<float, true, false>(Args<float>)", 30),
        _event("void at::native::vectorized_elementwise_kernel<4>()", 80),
        _event("Memcpy DtoH (Device -> Pinned)", 20, "gpu_memcpy"),
        _event("aten::add", 999, "cpu_op"),
    ]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    assert len(trace_table.load_device_events(str(path))) == 10
    table = trace_table.format_table(str(tmp_path), iters=10)
    rows = {line.split(" | ")[0].lstrip("| "): line.split(" | ")[1:]
            for line in table.splitlines() if line.startswith("| ")}
    flat = rows["flat trip kernel (search trip + iteration boundary)"]
    assert flat[:3] == ["0.600", "60.0%", "2"]
    assert flat[3] == "60.0 |"
    assert rows["prologue kernel (push + two-loop + LS setup)"][0] == "0.100"
    assert rows["batch-minor prologue kernel (push + two-loop + LS setup)"][
        0] == "0.050"
    assert rows["push + two-loop kernel"][0] == "0.040"
    assert rows["two-loop kernel"][0] == "0.060"
    assert rows["driver residue"][:3] == ["0.100", "10.0%", "2"]
    assert "total device time across 10 events: 1.000 ms" in table


def test_trace_gz_and_phase_of(tmp_path):
    import gzip

    with gzip.open(tmp_path / "t.json.gz", "wt") as f:
        json.dump({"traceEvents": [_event("void mt_trip_kernel<double>()",
                                          5)]}, f)
    assert "line-search kernel" in trace_table.format_table(
        str(tmp_path / "t.json.gz"))
    assert trace_table.phase_of("void launch_floor_kernel<float>()") == (
        "launch-floor calibration kernel")
    assert trace_table.phase_of("elementwise") == trace_table.RESIDUE


# instance_diff --------------------------------------------------------------


def _artifact(path, rows):
    with open(path, "w") as f:
        json.dump({"rows": rows, "summary": {}}, f)


def test_instance_diff_reads_the_ports_artifact(tmp_path):
    """Two artifacts in ``suite_bench.py``'s layout (its ``instance_rows``
    of the port's float64 records of two problems on the CPU), the second
    with one instance flipped each way: ``benchmarks/instance_diff.py``
    names both as they are."""
    diff = _load(os.path.join(ROOT, "benchmarks", "instance_diff.py"),
                 "instance_diff")
    batches = mgh_benchmark_instances(suite_bench.TOTAL_INSTANCES,
                                      seed=0)[:2]
    records = suite_bench.solve_problems(cns, batches, torch.float64, "cpu")
    for rec in records:
        rec["stage"] = np.ones(rec["ok"].size, np.int64)
    rows = suite_bench.instance_rows(records)
    assert all(r["ok"] for r in rows)
    flipped = [dict(r) for r in rows]
    flipped[1]["ok"] = False
    flipped[1]["nfev"] += 10.0
    old, new = tmp_path / "old.json", tmp_path / "new.json"
    _artifact(old, [dict(rows[0], ok=False)] + rows[1:])
    _artifact(new, flipped)
    got = diff.diff_files(str(old), str(new))
    name = rows[0]["problem"]
    assert got["common"] == len(rows)
    assert got["to_fail"] == [f"{name}[1]"]
    assert got["to_ok"] == [f"{name}[0]"]
    mean = sum(r["nfev"] for r in rows) / len(rows)
    assert got["nfev_mean_old"] == pytest.approx(mean)
    assert got["nfev_mean_new"] == pytest.approx(mean + 10.0 / len(rows))


# packaging ----------------------------------------------------------------


def test_package_data_covers_every_kernel_source():
    """Every file under the port's ``ops/csrc/`` matches one of
    pyproject.toml's package-data globs for ``..._torch.ops``, and the
    package finder includes the port."""
    import fnmatch

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        conf = tomllib.load(f)["tool"]["setuptools"]
    globs = conf["package-data"]["cppnumericalsolvers_tpu_torch.ops"]
    csrc = os.path.join(ROOT, "cppnumericalsolvers_tpu_torch", "ops", "csrc")
    files = sorted(os.listdir(csrc))
    assert files
    for name in files:
        assert any(fnmatch.fnmatch(f"csrc/{name}", g) for g in globs), name
    assert any(fnmatch.fnmatch("cppnumericalsolvers_tpu_torch", p)
               for p in conf["packages"]["find"]["include"])
