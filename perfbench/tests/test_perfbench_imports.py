"""Nothing the benchmark runs imports the JAX package, JAX or the
repository's other harnesses; the reference imports nothing of the program.
Module names are compared whole by their top-level part: the port's name
begins with the JAX package's."""

import ast
from pathlib import Path

from perfbench import bench

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "cppnumericalsolvers_tpu", "benchmarks",
             "benchmarks_torch"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def harness_files():
    return [p for p in HERE.rglob("*.py") if "tests" not in p.parts]


def test_harness_imports_none_of_the_forbidden():
    found = {str(p.relative_to(HERE)): top_level_imports(p) & FORBIDDEN
             for p in harness_files()}
    assert not {k: v for k, v in found.items() if v}
    assert len(found) > 10


def test_reference_imports_nothing_of_the_program():
    for p in (HERE / "reference").glob("*.py"):
        assert not top_level_imports(p) & (FORBIDDEN
                                           | {"cppnumericalsolvers_tpu_torch"})


def test_run_time_check_names_whole_modules():
    assert bench.forbidden_modules(["cppnumericalsolvers_tpu_torch.ops",
                                    "benchmarks_x", "jaxtyping"]) == []
    assert bench.forbidden_modules(["jax.numpy", "cppnumericalsolvers_tpu",
                                    "torch"]) == ["cppnumericalsolvers_tpu",
                                                  "jax"]
