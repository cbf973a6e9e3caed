"""examples_torch/expressions_tour.py against the JAX package's
examples/expressions_tour.py, on the CPU: every value, gradient and Hessian
entry it prints, the mode of a mixed product, and the augmented
Lagrangian's hand-checked 10.45, to their printed precision (the JAX
example runs as it is, in a process of its own: tests/torch_examples.py).
"""

import pytest
import torch

from examples_torch import expressions_tour

import torch_examples as tex

torch.set_num_threads(1)

#: (the JAX example's line prefix, the port's figure)
FIGURES = [
    ("f(x) =", "f"), ("g(x) =", "g"), ("(2f + g - 3)(x) =", "combo"),
    ("grad:", "combo_grad"), ("(f*g)(x) =", "prod"),
    ("min(0, c)(x) =", "min_zero"), ("max(0, c)(x) =", "max_zero"),
    ("d/dx max(0,c) at active side:", "max_zero_grad"),
    ("pure-penalty composite at x:", "penalty"),
    ("augmented Lagrangian at x:", "augmented_lagrangian"),
]


@pytest.fixture(scope="module")
def runs():
    proc = tex.start_jax_example("expressions_tour")
    port = expressions_tour.main("cpu")
    return port, tex.finish(proc)


def flat(v):
    if isinstance(v, list):
        return [y for x in v for y in flat(x)]
    return [v]


@pytest.mark.parametrize("prefix,key", FIGURES)
def test_figure_matches_jax(runs, prefix, key):
    port, text = runs
    line = tex.line_with(text, prefix)[len(prefix):]
    if key == "prod":
        line = line.split("grad:")[0]
    if key == "augmented_lagrangian":
        line = line.split("(expect")[0]
    printed = tex.numbers(line)
    got = flat(port[key])
    assert len(printed) == len(got)
    for v, p in zip(got, printed):
        assert tex.printed_close(v, p), (key, v, p)


def test_product_gradient_and_hessian_match_jax(runs):
    port, text = runs
    grad = tex.numbers(tex.line_with(text, "(f*g)(x) =").split("grad:")[1])
    assert [float(g) for g in grad] == port["prod_grad"]
    lines = text.splitlines()
    at = next(i for i, ln in enumerate(lines) if ln.startswith("hessian:"))
    hess = [float(v) for v in tex.numbers(" ".join(lines[at + 1:at + 3]))]
    assert hess == flat(port["combo_hessian"])


def test_mode_and_expected_value(runs):
    port, text = runs
    mode = tex.line_with(text, "mode of second*first product:").split()[-1]
    assert port["mode"] == mode == "first"
    assert abs(port["augmented_lagrangian"] - 10.45) < 1e-12
