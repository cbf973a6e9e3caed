"""``BENCHMARK.json`` keeps to the benchmark's contract, and every cell
finds its configuration, traffic, problem, limits and metric readers by
name."""

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [
        c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in [m["name"] for m in SPEC["end_to_end"]]
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    fours = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert fours <= max(1, len(SPEC["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_its_files_by_name(cell):
    w = next(x for x in SPEC["workloads"] if x["name"] == cell)
    conf = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert conf["file"].startswith("perfbench/configs/")
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["reduced"] == conf["reduced"] == []
    traffic = json.loads(
        (ROOT / "perfbench/traffic" / f"{w['traffic']}.json").read_text())
    # Batched cells take B n = 2^27 on one card; a model-sharded cell one
    # problem over its cards.
    if cfg.get("path", "batched") == "batched":
        assert traffic["batch"] * cfg["n"] == 2 ** 27 and w["chips"] == 1
    else:
        assert cfg["path"] == "model_sharded"
        assert traffic["batch"] == 1 and cfg["cards"] == w["chips"]
    limits = json.loads(
        (ROOT / "perfbench/limits" / f"{cell}.json").read_text())
    assert set(limits) == {"step_gap", "eval_gap", "f_final"}
    assert {"solves", "lanes_per_solve", "trips"} <= set(traffic["check"])
    shares = [c["share"] for c in traffic["start"]]
    assert abs(sum(shares) - 1.0) < 1e-9
    problem = importlib.import_module(f"perfbench.problems.{cfg['problem']}")
    assert callable(problem.reference) and callable(problem.eval_bytes)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        if cell in m.get("workloads", CELLS):
            assert (ROOT / "perfbench/metrics" / f"{m['name']}.py").exists()


def test_every_config_is_used_and_every_file_named_from_a_name():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for p in (ROOT / "perfbench").rglob("*"):
        if "__pycache__" not in p.parts:
            rel = str(p.relative_to(ROOT))
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
