"""The port's batched More-Thuente search against the JAX package.

Inputs are made with numpy from a seed and go through the JAX function and
its counterpart in the port, on the CPU, where the port's ``mt_trip`` runs
its plain version ``mt_trip_reference``.

* float64, against the XLA forms (``_mt_trip_core`` trip by trip and
  ``mt_xla_batched`` as a whole): integer outputs exact, floats within
  1e-12 (XLA on the CPU contracts a*b+c into fused multiply-adds and PyTorch
  does not, so the last bit may differ).
* float32, against the Pallas kernel in interpret mode, called as
  tests/test_fused_linesearch.py calls it: integer outputs exact, floats
  within rtol 2e-4 / atol 2e-5 (two orders of summation in the directional
  derivative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppnumericalsolvers_tpu.linesearch.dispatch import (
    run_line_search as jax_run_line_search,
)
from cppnumericalsolvers_tpu.linesearch.more_thuente import (
    more_thuente as jax_more_thuente,
)
from cppnumericalsolvers_tpu.ops.fused_linesearch import (
    _mt_trip_core,
    mt_pallas_batched,
    mt_xla_batched,
)
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.linesearch import (
    more_thuente,
    run_line_search,
)
from cppnumericalsolvers_tpu_torch.ops import fused_linesearch as fl

torch.set_num_threads(1)


def jax_rosen(x):
    return jnp.sum(100.0 * (x[1::2] - x[0::2] ** 2) ** 2 + (1.0 - x[0::2]) ** 2)


JVAG = jax.value_and_grad(jax_rosen)
TOBJ = cns.models.pairwise_rosenbrock()


def case(seed, dtype, b=24, n=8):
    """A batched start with its steepest-descent directions; lane 3 points
    uphill and lane 7 has a zero direction (both abort before evaluating)."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-2.0, 2.0, (b, n)).astype(dtype)
    f0, g0 = (np.asarray(a) for a in jax.vmap(JVAG)(jnp.asarray(x0)))
    d = -g0
    d[3] = g0[3]
    d[7] = 0.0
    alpha = rng.uniform(1e-3, 1.5, (b,)).astype(dtype)
    dginit = np.sum(g0 * d, axis=-1).astype(dtype)
    return x0, f0.astype(dtype), g0.astype(dtype), d, alpha, dginit


def port_search(args, max_fev):
    t = [torch.from_numpy(np.asarray(a)) for a in args]
    return fl.batched_more_thuente(TOBJ.batched_value_and_grad, *t,
                                   max_fev=max_fev)


def test_trip_matches_jax_core_float64():
    """Every trip of a search: the same carry through ``_mt_trip_core`` and
    through the port's plain trip."""
    x0, f0, g0, d, alpha, dginit = case(0, np.float64)
    b = x0.shape[0]
    tx0, td = torch.from_numpy(x0), torch.from_numpy(d)
    st = fl.init_search(tx0, torch.from_numpy(f0), torch.from_numpy(g0), td,
                        torch.from_numpy(alpha), torch.from_numpy(dginit), 20)
    trips = 0
    while bool((st.si[:, fl._I_INFO] == 0).any()):
        f_t, g_t = TOBJ.batched_value_and_grad(st.x_trial)
        sf, si = st.sf.numpy().copy(), st.si.numpy().copy()

        def col(a):
            return jnp.asarray(a).reshape(b, 1)

        want = _mt_trip_core(
            jnp.asarray(x0), jnp.asarray(d),
            *(col(sf[:, j]) for j in (fl._F_FINIT, fl._F_DGINIT,
                                      fl._F_DGTEST)),
            col(f_t.numpy()), jnp.asarray(g_t.numpy()),
            jnp.asarray(st.gacc.numpy()),
            *(col(sf[:, j]) for j in range(fl._F_FACC, fl._NF)),
            *(col(si[:, j]) for j in range(fl._NI)),
            max_fev=20,
        )
        fl.mt_trip_reference(tx0, td, f_t, g_t, st, 20)
        np.testing.assert_allclose(st.x_trial.numpy(), np.asarray(want[0]),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(st.gacc.numpy(), np.asarray(want[1]),
                                   rtol=1e-12, atol=1e-12)
        for k, j in enumerate(range(fl._F_FACC, fl._NF)):
            np.testing.assert_allclose(
                st.sf[:, j].numpy(), np.asarray(want[2 + k])[:, 0],
                rtol=1e-12, atol=1e-12, err_msg=f"float row {j}")
        for j in range(fl._NI):
            np.testing.assert_array_equal(
                st.si[:, j].numpy(), np.asarray(want[14 + j])[:, 0],
                err_msg=f"int row {j}")
        trips += 1
    assert trips >= 3


@pytest.mark.parametrize("seed,max_fev", [(0, 20), (1, 20), (2, 5)])
def test_search_matches_jax_xla_loop_float64(seed, max_fev):
    args = case(seed, np.float64)
    want = mt_xla_batched(JVAG, *(jnp.asarray(a) for a in args),
                          max_fev=max_fev)
    x, f, g, alpha, nfev, info, trips = port_search(args, max_fev)
    np.testing.assert_array_equal(nfev.numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(info.numpy(), np.asarray(want[5]))
    for got, ref in ((x, want[0]), (f, want[1]), (g, want[2]),
                     (alpha, want[3])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-12)
    assert trips == int(np.asarray(want[4]).max())


@pytest.mark.parametrize("seed,max_fev", [(0, 20), (1, 20), (2, 5)])
def test_search_matches_pallas_kernel_interpret_float32(seed, max_fev):
    args = case(seed, np.float32)
    want = mt_pallas_batched(JVAG, *(jnp.asarray(a) for a in args),
                             max_fev=max_fev, interpret=True)
    x, f, g, alpha, nfev, info, _ = port_search(args, max_fev)
    assert x.dtype == torch.float32
    np.testing.assert_array_equal(nfev.numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(info.numpy(), np.asarray(want[5]))
    for got, ref in ((x, want[0]), (f, want[1]), (g, want[2]),
                     (alpha, want[3])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                                   atol=2e-5)


def test_non_descent_lane_returns_start():
    args = case(0, np.float64)
    x0, f0, g0 = args[:3]
    x, f, g, alpha, nfev, info, _ = port_search(args, 20)
    for lane in (3, 7):
        assert info[lane] == -1 and nfev[lane] == 0
        np.testing.assert_array_equal(x[lane].numpy(), x0[lane])
        np.testing.assert_array_equal(f[lane].numpy(), f0[lane])
        np.testing.assert_array_equal(g[lane].numpy(), g0[lane])
        assert alpha[lane] == args[4][lane]


def test_finished_lane_keeps_its_bits():
    """A lane whose search is over is not touched by later trips."""
    x0, f0, g0, d, alpha, dginit = (
        torch.from_numpy(a) for a in case(1, np.float64))
    st = fl.init_search(x0, f0, g0, d, alpha, dginit, 20)
    seen = {}
    while bool((st.si[:, fl._I_INFO] == 0).any()):
        f_t, g_t = TOBJ.batched_value_and_grad(st.x_trial)
        fl.mt_trip(x0, d, f_t, g_t, st, 20)
        for lane in torch.nonzero(st.si[:, fl._I_INFO] != 0)[:, 0].tolist():
            snap = tuple(t[lane].clone() for t in
                         (st.x_trial, st.gacc, st.sf, st.si))
            if lane in seen:
                for a, c in zip(seen[lane], snap):
                    assert torch.equal(a, c)
            seen[lane] = snap
    assert len(seen) == x0.shape[0]


def test_single_search_matches_jax():
    x0, f0, g0, d, alpha, dginit = case(4, np.float64)
    for lane in (0, 3, 5):
        want = jax_more_thuente(
            JVAG, jnp.asarray(x0[lane]), jnp.asarray(f0[lane]),
            jnp.asarray(g0[lane]), jnp.asarray(d[lane]), alpha[lane])
        got = more_thuente(
            TOBJ.value_and_grad, torch.from_numpy(x0[lane]),
            torch.tensor(f0[lane]), torch.from_numpy(g0[lane]),
            torch.from_numpy(d[lane]), float(alpha[lane]))
        assert got.x.shape == (x0.shape[1],) and got.f.shape == ()
        assert int(got.nfev) == int(want.nfev)
        assert int(got.info) == int(want.info)
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(float(got.alpha), float(want.alpha),
                                   rtol=1e-12)


def test_run_line_search_dispatch():
    x0, f0, g0, d, alpha, dginit = (
        torch.from_numpy(a) for a in case(5, np.float64))
    bvag = TOBJ.batched_value_and_grad
    with_dg = run_line_search("more_thuente", bvag, x0, f0, g0, d, alpha,
                              dginit=dginit)
    without = run_line_search("more_thuente", bvag, x0, f0, g0, d, alpha)
    # numpy's and PyTorch's sums of dginit may differ in the last bit.
    np.testing.assert_allclose(with_dg.x.numpy(), without.x.numpy(),
                               rtol=1e-12, atol=1e-12)
    assert torch.equal(with_dg.nfev, without.nfev)
    assert with_dg.trips == int(with_dg.nfev.max())
    assert bool((with_dg.f[with_dg.nfev > 0] < f0[with_dg.nfev > 0]).all())
    # The other two searches run on the same inputs and match the JAX
    # package's run_line_search lane by lane (vmapped).  Armijo: nfev exact,
    # the accepted point within 1e-12.  Hager-Zhang: from these far starts
    # along steepest descent most lanes bisect until their interval is
    # machine-epsilon wide (about 56 evaluations), where each half is
    # decided by comparing samples a last bit apart, so last-bit differences
    # between XLA's arithmetic and PyTorch's move the end by one bisection
    # on a few lanes: nfev within 1 (measured: 4 of 24 lanes), the step, f
    # and x within 1e-9 relative (measured 2.4e-10, 2.9e-10, 2.8e-10).
    jx0, jf0, jg0, jd, jalpha = (jnp.asarray(t.numpy())
                                 for t in (x0, f0, g0, d, alpha))
    for name in ("armijo", "hager_zhang"):
        got = run_line_search(name, bvag, x0, f0, g0, d, alpha)
        want = jax.vmap(lambda *a, name=name: jax_run_line_search(
            name, JVAG, *a))(jx0, jf0, jg0, jd, jalpha)
        exact = name == "armijo"
        dnfev = np.abs(got.nfev.numpy() - np.asarray(want.nfev))
        assert dnfev.max() <= (0 if exact else 1), name
        assert int((dnfev > 0).sum()) <= (0 if exact else 4), name
        for field in ("x", "f", "alpha"):
            np.testing.assert_allclose(
                getattr(got, field).numpy(),
                np.asarray(getattr(want, field)),
                rtol=1e-12 if exact else 1e-9, atol=1e-12,
                err_msg=f"{name} {field}")
    with pytest.raises(ValueError, match="unknown line search"):
        run_line_search("wolfe", bvag, x0, f0, g0, d, alpha)


def test_mt_trip_on_cpu_takes_the_plain_version():
    x0, f0, g0, d, alpha, dginit = (
        torch.from_numpy(a) for a in case(6, np.float64))
    st = fl.init_search(x0, f0, g0, d, alpha, dginit, 20)
    ref = st.clone()
    before = fl.mt_trip.launches
    for _ in range(4):
        f_t, g_t = TOBJ.batched_value_and_grad(st.x_trial)
        fl.mt_trip(x0, d, f_t, g_t, st, 20)
        fl.mt_trip_reference(x0, d, f_t, g_t, ref, 20)
        for name in ("x_trial", "gacc", "sf", "si"):
            assert torch.equal(getattr(st, name), getattr(ref, name)), name
    assert fl.mt_trip.launches == before == 0


def test_mt_trip_checks_its_arguments():
    x0, f0, g0, d, alpha, dginit = (
        torch.from_numpy(a) for a in case(6, np.float64))
    st = fl.init_search(x0, f0, g0, d, alpha, dginit, 20)
    f_t, g_t = TOBJ.batched_value_and_grad(st.x_trial)
    with pytest.raises(ValueError, match="g_t"):
        fl.mt_trip(x0, d, f_t, g_t.float(), st, 20)
    with pytest.raises(ValueError, match="sdir"):
        fl.mt_trip(x0, d[:2], f_t, g_t, st, 20)
    with pytest.raises(ValueError, match="contiguous"):
        fl.mt_trip(x0, d, f_t, g_t.t().contiguous().t(), st, 20)
    with pytest.raises(TypeError):
        half = fl.SearchState(**{
            k: v.half() if v.is_floating_point() else v
            for k, v in vars(st).items()})
        fl.mt_trip(x0.half(), d.half(), f_t.half(), g_t.half(), half, 20)
    meta = fl.SearchState(**{k: v.to("meta") for k, v in vars(st).items()})
    with pytest.raises(ValueError, match="device"):
        fl.mt_trip(x0, d, f_t, g_t, meta, 20)
