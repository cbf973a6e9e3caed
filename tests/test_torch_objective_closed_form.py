"""MGH 21's closed-form batched value and gradient (``ops/objectives.py``,
carried by ``models.pairwise_rosenbrock()``'s function) on the CPU: its plain version
against ``vmap(grad_and_value(fn))`` bit for bit, which objectives take it,
and how often a solve evaluates through it.  The kernel
(``csrc/pairwise_rosenbrock.cu``) is held to the vmap path on the card by
``chip_smoke.py``'s ``objective_main``."""

import re
from pathlib import Path

import pytest
import torch
from torch.func import grad_and_value, vmap

import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch import models
from cppnumericalsolvers_tpu_torch.ops import _build, objectives

CSRC = Path(_build.__file__).resolve().parent / "csrc"
INT_VIEW = {torch.float32: torch.int32, torch.float64: torch.int64}


def _points(b, n, dtype, far, seed=0):
    gen = torch.Generator().manual_seed(seed + 7 * n + b)
    x = torch.rand(b, n, generator=gen, dtype=torch.float64) * 4.0 - 2.0
    if far:
        # Entries near 1e3: r = o - e^2 near -1e6, terms near 1e14.
        x = x + 1e3
    return x.to(dtype)


def _vmap_path(x):
    g, f = vmap(grad_and_value(models.pairwise_rosenbrock().fn))(x)
    return f, g


def _same_bits(a, b):
    view = INT_VIEW[a.dtype]
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


@pytest.mark.parametrize("far", [False, True], ids=["near", "far"])
@pytest.mark.parametrize("b", [1, 3, 64])
@pytest.mark.parametrize("n", [2, 4, 32, 64, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_plain_closed_form_has_the_vmap_paths_bits(dtype, n, b, far):
    x = _points(b, n, dtype, far)
    f0, g0 = _vmap_path(x)
    f1, g1 = objectives.pairwise_rosenbrock_value_and_grad_reference(x)
    assert _same_bits(f1, f0)
    assert _same_bits(g1, g0)


def test_signed_zeros_and_the_minimum_match_the_vmap_path():
    """At x* the even entries' two gradient terms are -0 and -0; the vmap
    path's slice backward adds them into zeros, giving +0."""
    x = torch.tensor([[1.0, 1.0, 0.0, -0.0, -0.0, 0.0, 1.0, 1.0]])
    f0, g0 = _vmap_path(x)
    f1, g1 = objectives.pairwise_rosenbrock_value_and_grad_reference(x)
    assert _same_bits(f1, f0) and _same_bits(g1, g0)
    assert not torch.signbit(g1[g1 == 0]).any()


@pytest.fixture
def closed_form_calls(monkeypatch):
    """Counts the closed form's evaluations on the CPU, where it runs its
    plain version and launches no kernel: ``calls[0]``."""
    calls = [0]
    plain = objectives.pairwise_rosenbrock_value_and_grad_reference

    def counted(x):
        calls[0] += 1
        return plain(x)

    monkeypatch.setattr(
        objectives, "pairwise_rosenbrock_value_and_grad_reference", counted)
    return calls


DISPATCH = {
    # name: (objective, takes the closed form)
    "plain": (lambda o: o, True),
    "mode_first": (lambda o: o.with_mode("first"), True),
    "plus_zero": (lambda o: o + 0.0, False),
    "times_two": (lambda o: o * 2.0, False),
    "mode_none": (lambda o: o.with_mode("none"), False),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_which_objectives_take_the_closed_form(case, dtype,
                                               closed_form_calls):
    """The closed form travels on ``fn``: the objective itself and its mode
    downgrade to "first" take it; a composition wraps ``fn`` in a new
    function and a value-only objective keeps its zero gradient, both by
    the vmap path, as does a dtype the closed form does not take."""
    make, closed = DISPATCH[case]
    base = models.pairwise_rosenbrock()
    obj = make(base)
    x = _points(5, 8, dtype, far=False)
    f, g = obj.batched_value_and_grad(x)
    closed = closed and dtype != torch.bfloat16
    assert closed_form_calls[0] == (1 if closed else 0)
    # Whichever path ran, the result is the vmap path's, bit for bit.
    want_g, want_f = vmap(obj._grad_and_value)(x)
    if obj.mode == "none":
        want_f, want_g = vmap(obj.fn)(x), torch.zeros_like(x)
    assert torch.equal(f, want_f) and torch.equal(g, want_g)
    assert f.dtype == dtype and g.dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_non_contiguous_input_gives_its_contiguous_copys_results(dtype):
    x = _points(6, 32, dtype, far=False)
    xt = x.t().contiguous().t()
    assert not xt.is_contiguous()
    f0, g0 = objectives.pairwise_rosenbrock_value_and_grad(x)
    f1, g1 = objectives.pairwise_rosenbrock_value_and_grad(xt)
    assert _same_bits(f1, f0) and _same_bits(g1, g0)
    assert g1.is_contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_minimize_batched_evaluates_through_the_closed_form(
        dtype, closed_form_calls):
    """One closed-form evaluation at the start and one a trip of the flat
    loop, and none by the vmap path: a solve through the closed form ends
    where the same solve through ``vmap(grad_and_value)`` ends, bit for
    bit."""
    obj = models.pairwise_rosenbrock()
    x0 = _points(16, 32, dtype, far=False, seed=11)
    solver = cns.Lbfgs(m=10)
    res = cns.minimize_batched(obj, x0, solver, device="cpu")
    assert closed_form_calls[0] == res.trips + 1
    generic = cns.Objective(lambda x, f=obj.fn: f(x), obj.mode)
    ref = cns.minimize_batched(generic, x0, solver, device="cpu")
    assert res.trips == ref.trips
    assert _same_bits(res.state.x, ref.state.x)
    assert torch.equal(res.progress.status, ref.progress.status)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_launches_count_only_kernel_launches(dtype):
    """On the CPU the closed form runs its plain version, which launches no
    kernel, so ``.launches`` stays where it was, as every other wrapper's
    counter does off the card."""
    kern = objectives.pairwise_rosenbrock_value_and_grad
    before = kern.launches
    kern(_points(4, 8, dtype, far=False))
    models.pairwise_rosenbrock().batched_value_and_grad(
        _points(4, 8, dtype, far=False))
    assert kern.launches == before


def test_rejects_what_the_closed_form_cannot_take():
    with pytest.raises(ValueError, match="n even"):
        objectives.pairwise_rosenbrock_value_and_grad(torch.zeros(2, 3))
    with pytest.raises(ValueError, match="n even"):
        objectives.pairwise_rosenbrock_value_and_grad(torch.zeros(4))
    with pytest.raises(TypeError, match="float32/float64"):
        objectives.pairwise_rosenbrock_value_and_grad(
            torch.zeros(2, 4, dtype=torch.bfloat16))


@pytest.mark.parametrize("n,dtype,want", [
    (32, torch.float32, (2, 8)),
    (4096, torch.float32, (2, 256)),
    (30, torch.float32, (1, 16)),
    (2, torch.float32, (1, 1)),
    (64, torch.float64, (1, 32)),
    (130, torch.float32, (1, 128)),
    (4096, torch.float64, (1, 256)),
])
def test_lane_mapping_follows_n_and_dtype_alone(n, dtype, want):
    """Units of 16 bytes where n allows (a float4 of two float32 pairs, a
    double2 of one float64 pair), else a float2 of one pair; threads a lane
    the power of two at or above the units, at most 256."""
    assert objectives.pairwise_rosenbrock_mapping(n, dtype) == want


def test_entry_points_match_the_build_declaration():
    """``cppns_pairwise_rosenbrock_f32/_f64`` take x, g, f, then b, n, the
    pairs a unit and the threads a lane, then the stream."""
    sig = _build.KERNELS["pairwise_rosenbrock"]
    src = (CSRC / "pairwise_rosenbrock.cu").read_text()
    for suffix in ("f32", "f64"):
        found = re.search(
            rf'extern "C" int cppns_pairwise_rosenbrock_{suffix}\((.*?)\)',
            src, re.S)
        params = [p.strip() for p in found.group(1).split(",")]
        assert sum("*" in p for p in params) == sig.count(_build._P) == 4
        assert sum(p.startswith("int ") for p in params) == sig.count(
            _build._I) == 4
