"""The port's L-BFGS prologue and epilogue against the JAX package.

Inputs are made with numpy from a seed and go through the JAX function and
its counterpart in the port, on the CPU, where the port's wrappers run their
plain versions (``lbfgs_prologue_reference``, ``lbfgs_epilogue_reference``).

* float64, against the XLA forms (``_prologue_xla_single`` and
  ``_epilogue_xla_single`` under ``jax.vmap``): integer outputs exact,
  floats within 1e-12.
* float32, against the Pallas kernels in interpret mode, called as
  tests/test_fused_step.py calls them: integer outputs exact, floats within
  rtol 2e-4 / atol 2e-5 (two orders of summation, amplified by the two-loop
  recursion).

One difference is on purpose and is pinned here: for a done lane the port's
prologue emits the zero direction with ``dginit = 0`` and ``alpha_init = 1``
(the JAX form computes a direction that nothing uses), so those three
outputs are compared on live lanes only.  A done lane's internals, iterate
and progress record must come back bit-identical in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppnumericalsolvers_tpu as jcns
from cppnumericalsolvers_tpu.core.objective import (
    FunctionState as JaxFunctionState,
)
from cppnumericalsolvers_tpu.core.progress import (
    ProgressState as JaxProgressState,
)
from cppnumericalsolvers_tpu.ops.fused_step import (
    _epilogue_xla_single,
    _prologue_xla_single,
    epilogue_pallas_batched,
    prologue_pallas_batched,
)
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu_torch.ops import _kernel
from cppnumericalsolvers_tpu_torch.ops import fused_step as fstep

torch.set_num_threads(1)

TOL = {np.float64: dict(rtol=1e-12, atol=1e-12),
       np.float32: dict(rtol=2e-4, atol=2e-5)}
PROLOGUE_OUT = ["ls_dir", "alpha_init", "dginit", "s_memory", "y_memory",
                "mem_count", "gamma"]


def t(a):
    return torch.from_numpy(np.array(a))


def prologue_case(seed, dtype, b=12, m=5, n=20):
    """The inputs of tests/test_fused_step.py's prologue test; lane 0 is
    full, valid and live (its history shifts), lane 1 has a zero gradient,
    so no descent direction (its history resets)."""
    rng = np.random.default_rng(seed)
    f = dtype
    x = rng.standard_normal((b, n)).astype(f)
    g = rng.standard_normal((b, n)).astype(f)
    s = (rng.standard_normal((b, m, n)) * 0.1).astype(f)
    y = (s + 0.05 * rng.standard_normal((b, m, n))).astype(f)
    count = rng.integers(0, m + 1, (b,)).astype(np.int32)
    gamma = rng.uniform(0.5, 2.0, (b,)).astype(f)
    sn = (rng.standard_normal((b, n)) * 0.1).astype(f)
    yn = (sn + 0.05 * rng.standard_normal((b, n))).astype(f)
    valid = rng.integers(0, 2, (b,)).astype(bool)
    done = rng.integers(0, 2, (b,)).astype(bool)
    count[0], valid[0], done[0] = m, True, False
    g[1], count[1], done[1] = 0.0, m, False
    return x, g, s, y, count, gamma, sn, yn, valid, done


def run_prologue(args):
    x, g, s, y, count, gamma, sn, yn, valid, done = (t(a) for a in args)
    out = fstep.lbfgs_prologue(x, g, s, y, count, gamma, sn, yn, valid, done)
    # In place: the last four outputs are the tensors that went in.
    assert out[3] is s and out[4] is y and out[5] is count and out[6] is gamma
    return [o.numpy() for o in out]


def check_prologue(args, want, got, dtype):
    done = args[9]
    live = ~done
    for name, w, o in zip(PROLOGUE_OUT, want, got):
        w = np.asarray(w)
        if name == "mem_count":
            np.testing.assert_array_equal(o, w, err_msg=name)
        elif name in ("ls_dir", "alpha_init", "dginit"):
            np.testing.assert_allclose(o[live], w[live], err_msg=name,
                                       **TOL[dtype])
        else:
            np.testing.assert_allclose(o, w, err_msg=name, **TOL[dtype])
    # Done lanes: internals bit-identical, the zero direction out.
    for k, name in ((2, "s_memory"), (3, "y_memory"), (4, "mem_count"),
                    (5, "gamma")):
        np.testing.assert_array_equal(
            got[PROLOGUE_OUT.index(name)][done], args[k][done], err_msg=name)
    assert not got[0][done].any() and not got[2][done].any()
    assert (got[1][done] == 1.0).all()
    # The pinned lanes did what they were built for.
    m = args[2].shape[1]
    assert got[5][0] == m and got[5][1] == 0
    np.testing.assert_array_equal(got[0][1], -args[1][1])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_prologue_matches_jax_xla_float64(seed):
    args = prologue_case(seed, np.float64)
    want = jax.vmap(_prologue_xla_single)(*(jnp.asarray(a) for a in args))
    check_prologue(args, want, run_prologue(args), np.float64)


@pytest.mark.parametrize("shape", [(12, 5, 20), (16, 5, 128), (8, 10, 64)])
def test_prologue_matches_pallas_kernel_interpret_float32(shape):
    args = prologue_case(7, np.float32, *shape)
    want = prologue_pallas_batched(*(jnp.asarray(a) for a in args),
                                   interpret=True)
    got = run_prologue(args)
    assert got[0].dtype == np.float32
    check_prologue(args, want, got, np.float32)


def to_jax_state(state):
    return JaxFunctionState(**{k: jnp.asarray(v) for k, v in state.items()})


def epilogue_case(seed, dtype, b=16, n=12):
    """The inputs of tests/test_fused_step.py's epilogue test: lane 3's
    search returned NaN, lane 5's did not move."""
    rng = np.random.default_rng(seed)
    f = dtype
    state = dict(
        x=rng.standard_normal((b, n)).astype(f),
        value=rng.standard_normal((b,)).astype(f),
        gradient=rng.standard_normal((b, n)).astype(f),
        nfev=rng.integers(1, 50, (b,)).astype(np.int32),
    )
    x_ls = (state["x"] + 0.1 * rng.standard_normal((b, n))).astype(f)
    f_ls = (state["value"] - np.abs(rng.standard_normal(b))).astype(f)
    f_ls[3] = np.nan
    x_ls[5] = state["x"][5]
    g_ls = rng.standard_normal((b, n)).astype(f)
    ls_nfev = rng.integers(1, 10, (b,)).astype(np.int32)
    count = rng.integers(0, 10, (b,)).astype(np.int32)
    sp = rng.standard_normal((b, n)).astype(f)
    yp = rng.standard_normal((b, n)).astype(f)
    pv = rng.integers(0, 2, (b,)).astype(bool)
    done = rng.integers(0, 2, (b,)).astype(bool)
    done[3] = done[5] = False
    zi = np.zeros((b,), np.int32)
    progress = dict(
        num_iterations=rng.integers(0, 9, (b,)).astype(np.int32),
        x_delta=np.zeros((b,), f),
        x_delta_violations=rng.integers(0, 2, (b,)).astype(np.int32),
        f_delta=np.zeros((b,), f),
        f_delta_violations=zi.copy(),
        gradient_norm=np.zeros((b,), f),
        condition_hessian=rng.standard_normal((b,)).astype(f),
        status=np.where(done, 3, 0).astype(np.int32),
        past_ring=rng.standard_normal((b, 8)).astype(f),
        past_pos=rng.integers(0, 3, (b,)).astype(np.int32),
    )
    return (state, x_ls, f_ls, g_ls, ls_nfev, count, sp, yp, pv, done,
            progress)


CRITERIA = {
    "default": {},
    "relative_f": dict(f_delta=1e-2, f_delta_relative=True, past=0),
    "strikes": dict(x_delta=0.5, x_delta_violations=2, f_delta=2.0,
                    f_delta_violations=2, gradient_norm_relative=False,
                    max_iterations=6),
}


def run_epilogue(args, crit):
    state, x_ls, f_ls, g_ls, ls_nfev, count, sp, yp, pv, done, progress = args
    ts = cns.FunctionState(**{k: t(v) for k, v in state.items()})
    tp = cns.ProgressState(**{k: t(v) for k, v in progress.items()})
    out = fstep.lbfgs_epilogue(
        ts, t(x_ls), t(f_ls), t(g_ls), t(ls_nfev), t(count), t(sp), t(yp),
        t(pv), t(done), tp, crit)
    assert out[0] is ts and out[5] is tp  # in place
    new_state, s_pend, y_pend, pvalid, count1, new_progress = out
    return dict(
        state={k: v.numpy() for k, v in vars(new_state).items()},
        s_pend=s_pend.numpy(), y_pend=y_pend.numpy(), pvalid=pvalid.numpy(),
        count=count1.numpy(),
        progress={k: v.numpy() for k, v in vars(new_progress).items()},
    )


def check_epilogue(args, want, got, dtype, pass_through=True):
    w_state, w_sp, w_yp, w_pv, w_count, w_progress = want
    done = args[9]

    def close(o, w, name):
        w = np.asarray(w)
        if w.dtype.kind in "ib":
            np.testing.assert_array_equal(o, w, err_msg=name)
        else:
            np.testing.assert_allclose(o, w, err_msg=name, **TOL[dtype])

    for k, v in w_state._asdict().items():
        close(got["state"][k], v, k)
    close(got["s_pend"], w_sp, "s_pend")
    close(got["y_pend"], w_yp, "y_pend")
    close(got["pvalid"], w_pv, "pvalid")
    close(got["count"], w_count, "count")
    for k, v in w_progress._asdict().items():
        if k == "condition_hessian" and not pass_through:
            continue
        close(got["progress"][k], v, k)
    # Done lanes: everything bit-identical to what went in.
    state, _, _, _, _, count, sp, yp, pv, _, progress = args
    for k, v in state.items():
        np.testing.assert_array_equal(got["state"][k][done], v[done])
    for k, v in progress.items():
        np.testing.assert_array_equal(got["progress"][k][done], v[done])
    for name, v in (("s_pend", sp), ("y_pend", yp), ("pvalid", pv),
                    ("count", count)):
        np.testing.assert_array_equal(got[name][done], v[done])
    # The carried Hessian-condition figure passes through on every lane.
    np.testing.assert_array_equal(got["progress"]["condition_hessian"],
                                  progress["condition_hessian"])
    # The pinned lanes: NaN search result kept the iterate and marked the
    # pair invalid; the stalled lane's history count was reset.
    np.testing.assert_array_equal(got["state"]["x"][3], state["x"][3])
    assert not got["pvalid"][3] and got["count"][5] == 0


@pytest.mark.parametrize("crit", list(CRITERIA))
def test_epilogue_matches_jax_xla_float64(crit):
    args = epilogue_case(2, np.float64)
    jcrit = jcns.default_stopping(jnp.float64).replace(**CRITERIA[crit])
    tcrit = cns.default_stopping(torch.float64).replace(**CRITERIA[crit])
    state, *mid, progress = args
    want = jax.vmap(
        lambda st, *rest: _epilogue_xla_single(st, *rest, jcrit)
    )(to_jax_state(state), *(jnp.asarray(a) for a in mid),
      JaxProgressState(**{k: jnp.asarray(v) for k, v in progress.items()}))
    # The XLA form zeroes the Hessian-condition figure of live lanes; the
    # Pallas kernel and the port pass it through.
    check_epilogue(args, want, run_epilogue(args, tcrit), np.float64,
                   pass_through=False)
    statuses = set(np.asarray(want[5].status)[~args[9]].tolist())
    assert len(statuses) >= 2, statuses


@pytest.mark.parametrize("crit", list(CRITERIA))
def test_epilogue_matches_pallas_kernel_interpret_float32(crit):
    args = epilogue_case(2, np.float32)
    jcrit = jcns.default_stopping(jnp.float32).replace(**CRITERIA[crit])
    tcrit = cns.default_stopping(torch.float32).replace(**CRITERIA[crit])
    state, *mid, progress = args
    want = epilogue_pallas_batched(
        to_jax_state(state), *(jnp.asarray(a) for a in mid),
        JaxProgressState(**{k: jnp.asarray(v) for k, v in progress.items()}),
        jcrit, interpret=True)
    got = run_epilogue(args, tcrit)
    assert got["state"]["x"].dtype == np.float32
    check_epilogue(args, want, got, np.float32)


def test_wrappers_on_cpu_take_the_plain_versions():
    args = prologue_case(4, np.float64)
    got = run_prologue(args)
    x, g, s, y, count, gamma, sn, yn, valid, done = (t(a) for a in args)
    ref = fstep.lbfgs_prologue_reference(x, g, s, y, count, gamma, sn, yn,
                                         valid, done)
    for o, r in zip(got, ref):
        np.testing.assert_array_equal(o, r.numpy())
    assert fstep.lbfgs_prologue.launches == 0
    assert fstep.lbfgs_epilogue.launches == 0


def test_wrappers_check_their_arguments():
    x, g, s, y, count, gamma, sn, yn, valid, done = (
        t(a) for a in prologue_case(4, np.float64))
    with pytest.raises(ValueError, match="mem_count"):
        fstep.lbfgs_prologue(x, g, s, y, count.long(), gamma, sn, yn, valid,
                             done)
    with pytest.raises(ValueError, match="s_new"):
        fstep.lbfgs_prologue(x, g, s, y, count, gamma, sn[:, :4], yn, valid,
                             done)
    with pytest.raises(ValueError, match="contiguous"):
        fstep.lbfgs_prologue(x, g, s.transpose(1, 2).contiguous()
                             .transpose(1, 2), y, count, gamma, sn, yn,
                             valid, done)
    with pytest.raises(ValueError, match="valid"):
        fstep.lbfgs_prologue(x, g, s, y, count, gamma, sn, yn,
                             valid.to(torch.int32), done)
    with pytest.raises(TypeError):
        fstep.lbfgs_prologue(x.half(), g.half(), s.half(), y.half(), count,
                             gamma.half(), sn.half(), yn.half(), valid, done)

    args = epilogue_case(2, np.float64)
    state, x_ls, f_ls, g_ls, ls_nfev, count, sp, yp, pv, done, progress = args
    ts = cns.FunctionState(**{k: t(v) for k, v in state.items()})
    tp = cns.ProgressState(**{k: t(v) for k, v in progress.items()})
    crit = cns.default_stopping()
    with pytest.raises(ValueError, match="ls_nfev"):
        fstep.lbfgs_epilogue(ts, t(x_ls), t(f_ls), t(g_ls),
                             t(ls_nfev).long(), t(count), t(sp), t(yp),
                             t(pv), t(done), tp, crit)
    with pytest.raises(ValueError, match="g_ls"):
        fstep.lbfgs_epilogue(ts, t(x_ls), t(f_ls), t(g_ls).float(),
                             t(ls_nfev), t(count), t(sp), t(yp), t(pv),
                             t(done), tp, crit)
    tp.status = tp.status.to("meta")
    with pytest.raises(ValueError, match="device"):
        fstep.lbfgs_epilogue(ts, t(x_ls), t(f_ls), t(g_ls), t(ls_nfev),
                             t(count), t(sp), t(yp), t(pv), t(done), tp,
                             crit)


def test_prologue_shared_memory_bound_is_checked_before_launch():
    # The prologue's block holds q (n values) and O(m) scratch; above the
    # 227 KB a Hopper block can have the wrapper raises, with no fallback.
    _kernel.check_smem("lbfgs_prologue", 10, 4096, 4)
    _kernel.check_smem("lbfgs_prologue", 10, 4096, 8)
    with pytest.raises(ValueError, match="shared memory"):
        _kernel.check_smem("lbfgs_prologue", 10, 40000, 8)
