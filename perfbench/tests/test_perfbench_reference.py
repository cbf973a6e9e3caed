"""The plain reference against the port at small sizes on the CPU, in
float64: MGH 21's value and gradient, and the frozen trip's trial points
against the port's plain flat trip."""

import pytest
import torch

import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.ops import flat_solve as fs
from perfbench.reference import lbfgs_trip
from perfbench.reference import mgh21_rosenbrock as mgh21


@pytest.mark.parametrize("n", [2, 8, 32, 130])
def test_value_and_gradient_agree_with_the_port(n):
    g = torch.Generator().manual_seed(n)
    x = 4 * torch.rand(7, n, generator=g, dtype=torch.float64) - 2
    f, grad = mgh21.value_and_grad(x)
    f_p, g_p = cns.models.pairwise_rosenbrock().batched_value_and_grad(x)
    torch.testing.assert_close(f, f_p, rtol=1e-13, atol=0)
    torch.testing.assert_close(grad, g_p, rtol=1e-13, atol=1e-12)
    one = torch.ones(1, n, dtype=torch.float64)
    f1, g1 = mgh21.value_and_grad(one)
    assert float(f1) == mgh21.F_STAR and float(g1.abs().max()) == 0.0


def port_points(x0, trips, frozen):
    """The points the port's plain flat trip evaluates from ``x0`` (row 0
    the start, then one more trial than it evaluates), with the values and
    gradients there; with ``frozen`` its history stops taking pairs once
    full."""
    obj = cns.models.pairwise_rosenbrock()
    stop = cns.default_stopping(torch.float32)
    st, x = fs.init_flat_state(obj.evaluate(x0), 10, 20)
    f0, g0 = obj.batched_value_and_grad(x0)
    xs, vals, grads = [x0], [f0], [g0]
    for _ in range(trips):
        f_t, g_t = obj.batched_value_and_grad(x)
        xs.append(x.clone())
        vals.append(f_t)
        grads.append(g_t)
        full = (st.si[:, fs._I_COUNT] >= 10) & frozen
        s, y = st.s.clone(), st.y.clone()
        head = st.si[:, fs._I_HEAD].clone()
        fs.flat_trip_reference(st, f_t, g_t, x, stop, 20)
        st.s[full], st.y[full] = s[full], y[full]
        st.si[full, fs._I_HEAD] = head[full]
    xs.append(x.clone())
    return torch.stack(xs), torch.stack(vals), torch.stack(grads)


@pytest.mark.parametrize("b,n,half,trips", [(6, 16, 2.0, 40), (4, 64, 0.25, 70),
                                            (3, 256, 2.0, 12)])
def test_replay_follows_the_ports_plain_trip(b, n, half, trips):
    g = torch.Generator().manual_seed(b * n)
    centre = 0.0 if half == 2.0 else 1.0
    x0 = centre + half * (2 * torch.rand(b, n, generator=g,
                                         dtype=torch.float64) - 1)
    port, f, g = port_points(x0, trips, frozen=False)
    ref = lbfgs_trip.replay(port[:-1], f, g, 10, 20)
    torch.testing.assert_close(ref, port[1:], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("b,n,half", [(6, 16, 2.0), (4, 64, 0.25)])
def test_replay_parts_from_a_frozen_history(b, n, half):
    g = torch.Generator().manual_seed(7 * b + n)
    centre = 0.0 if half == 2.0 else 1.0
    x0 = centre + half * (2 * torch.rand(b, n, generator=g,
                                         dtype=torch.float64) - 1)
    port, f, g = port_points(x0, 30, frozen=True)
    ref = lbfgs_trip.replay(port[:-1], f, g, 10, 20)
    gap = (ref - port[1:]).abs().amax(-1).amax(-1)
    # Equal while the history has room; apart once a full one is used.
    assert float(gap[:10].max()) < 1e-9
    assert float(gap.max()) > 1e-3


def test_stopping_preset_is_the_ports_float32_default():
    port = cns.default_stopping(torch.float32)
    ref = lbfgs_trip.Stopping()
    for k in ("max_iterations", "x_delta", "x_delta_violations", "f_delta",
              "f_delta_violations", "gradient_norm", "past", "past_delta"):
        assert getattr(ref, k) == pytest.approx(getattr(port, k)), k
    assert port.gradient_norm_relative and not port.f_delta_relative
