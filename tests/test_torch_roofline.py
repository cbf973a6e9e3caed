"""``benchmarks_torch/roofline.py`` against ``benchmarks/roofline.py`` on
the CPU.

What the two modules share is held equal: the traffic model's itemized
bytes (at n > 2048, where the JAX module adds no batch-minor transposes and
the port routes none), the bytes and operations of the three phase models
(at widths where the TPU's 8- and 128-padding changes nothing), the
combination of the attainable bound and its bottleneck label (given the
JAX module's own phase terms: exact labels, 1e-12 relative for the
bound), the fixed-iteration stopping, and a fixed-budget solve's summed
iterations and evaluations (float64, 5 iterations: the parity contract's
short budget).  What is the port's own is checked by itself: the flat
carry's bytes against ``FlatState``'s tensors, the chain term against the
lane mapping, the L2 regime, the bound's independence from any measured
kernel time, the report, and that every measurement raises without a
card.  Times come only from the card (``python3
benchmarks_torch/roofline.py`` there).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import roofline as jroofline
from benchmarks_torch import roofline
import cppnumericalsolvers_tpu_torch as cns
from cppnumericalsolvers_tpu.solvers import Lbfgs as JaxLbfgs
from cppnumericalsolvers_tpu_torch.ops import flat_solve as fs
from cppnumericalsolvers_tpu_torch.ops._kernel import lane_mapping

torch.set_num_threads(1)

CARD = roofline.card_params()
#: Any TPU kind the JAX module knows: the VPU rate only enters the terms
#: the tests read past.
KIND = "TPU v5 lite"
PEAK_GBPS = 819.2


@pytest.mark.parametrize("nfev", [1.0, 1.7])
@pytest.mark.parametrize("n", [4096, 8192])
@pytest.mark.parametrize("batch", [8, 256])
def test_traffic_model_equals_jax(batch, n, nfev):
    total, parts = roofline.traffic_model_bytes(batch, n, nfev)
    jtotal, jparts = jroofline.traffic_model_bytes(batch, n, nfev)
    assert jparts["transposes"] == 0
    assert total == jtotal
    assert parts == jparts


def _jax_phase_counts(monkeypatch, fn, *args):
    """``(bytes, element-ops)`` that a JAX phase model hands
    ``_phase_model_us``."""
    seen = {}

    def capture(bytes_, elems, peak_gbps, vpu_rate, chain_us=0.0):
        seen["counts"] = (bytes_, elems)
        return 0.0

    monkeypatch.setattr(jroofline, "_phase_model_us", capture)
    fn(*args)
    return seen["counts"]


@pytest.mark.parametrize("batch,n", [(8, 4096), (256, 4096), (8, 8192),
                                     (256, 8192)])
def test_direction_step_counts_equal_jax(monkeypatch, batch, n):
    assert n > 2048  # the JAX module's batch-major layout, no transposes
    want = _jax_phase_counts(monkeypatch, jroofline.kernel_model_us, batch,
                             n, PEAK_GBPS, KIND)
    assert roofline.phase_work("direction", batch, n) == want


@pytest.mark.parametrize("phase,jax_fn", [
    ("search", jroofline.linesearch_model_us),
    ("epilogue", jroofline.epilogue_model_us)])
@pytest.mark.parametrize("batch,n", [(8, 32), (1024, 1024), (256, 4096)])
def test_search_and_epilogue_counts_equal_jax(monkeypatch, phase, jax_fn,
                                              batch, n):
    want = _jax_phase_counts(monkeypatch, jax_fn, batch, n, PEAK_GBPS, KIND)
    assert roofline.phase_work(phase, batch, n) == want


@pytest.mark.parametrize("bytes_,ops,chain_us,peak", [
    (1e9, 1e6, 0.0, PEAK_GBPS), (1e3, 1e12, 5.0, PEAK_GBPS),
    (1e3, 1e3, 50.0, PEAK_GBPS), (1e9, 1e6, 0.0, None)])
def test_phase_model_combines_as_jax(bytes_, ops, chain_us, peak):
    rate = 8 * 128 * 4 * 0.94e9
    want = jroofline._phase_model_us(bytes_, ops, peak, rate, chain_us)
    got = roofline.phase_model_ms(bytes_, ops, rate, chain_us / 1e3,
                                  peak and peak * 1e9)
    assert got == pytest.approx(want / 1e3, rel=1e-12)


#: Made-up phase terms (us), evaluation, trip floor and peak for each
#: binding term of the bound.
BINDING = {
    "HBM bandwidth": dict(k=1.0, ls=0.5, ep=2.0, eval=3.0, trip=4.0,
                          peak=0.01),
    "direction-step kernel": dict(k=5000.0, ls=0.5, ep=2.0, eval=3.0,
                                  trip=4.0, peak=PEAK_GBPS),
    "line-search trips (eval + loop floor)": dict(
        k=1.0, ls=0.5, ep=2.0, eval=300.0, trip=400.0, peak=PEAK_GBPS),
}


@pytest.mark.parametrize("label", sorted(BINDING))
def test_attainable_bound_and_label_equal_jax(monkeypatch, label):
    """Given the JAX module's own phase terms, evaluation time and trip
    floor, the port's combination and label are the JAX module's."""
    c = BINDING[label]
    batch, n, nfev, per_iter_us = 256, 4096, 1.3, 900.0
    for name, key in (("kernel_model_us", "k"),
                      ("linesearch_model_us", "ls"),
                      ("epilogue_model_us", "ep")):
        monkeypatch.setattr(jroofline, name,
                            lambda *a, v=c[key], **kw: v)
    monkeypatch.setattr(jroofline, "_vmem_resident", lambda *a: False)
    monkeypatch.setattr(jroofline, "_flat_active", lambda *a: False)
    monkeypatch.setitem(jroofline._TRIP_US_CACHE, "v", c["trip"])
    jrow = {"batch": batch, "n": n, "nfev_per_iter": nfev,
            "per_batched_iter_us": per_iter_us}
    jattain, jlight, _, _ = jroofline.attainable_bound_us(
        jrow, c["peak"], KIND, c["eval"], c["trip"])
    jroofline.analyze_shape(jrow, c["peak"], KIND, c["eval"])
    assert jrow["bottleneck"] == label

    terms = {"working_set_bytes": 0, "l2_resident": False,
             "light_ms": jlight / 1e3, "kernel_model_ms": c["k"] / 1e3,
             "linesearch_model_ms_per_trip": c["ls"] / 1e3,
             "epilogue_model_ms": c["ep"] / 1e3}
    monkeypatch.setattr(roofline, "bound_terms", lambda *a, **kw: terms)
    card = dataclasses.replace(CARD, hbm_bytes_per_s=c["peak"] * 1e9)
    row = {"batch": batch, "n": n, "nfev_per_iter": nfev,
           "per_batched_iter_ms": per_iter_us / 1e3}
    attain = roofline.attainable_bound_ms(row, card, c["eval"] / 1e3,
                                          c["trip"] / 1e3)[0]
    assert attain == pytest.approx(jattain / 1e3, rel=1e-12)
    roofline.analyze_shape(row, card, c["eval"] / 1e3, c["trip"] / 1e3)
    assert row["bottleneck"] == label
    assert row["attainable_ms"] == pytest.approx(jrow["attainable_us"] / 1e3,
                                                 rel=1e-12)
    for key in ("pct_of_attainable", "hbm_utilization_pct",
                "model_bytes_per_iter"):
        assert row[key] == pytest.approx(jrow[key], rel=1e-12)
    assert row["achieved_gbps"] == pytest.approx(jrow["achieved_gbps"],
                                                 rel=1e-12)


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.float64, jnp.float64)])
def test_fixed_iteration_stopping_equals_jax(dtype, jdtype):
    got = roofline.fixed_iteration_stopping(37, dtype)
    want = jroofline.fixed_iteration_stopping(37, jdtype)
    for name in want._fields:
        # The port keeps Python scalars, cast to the solve's type where used.
        jv = np.asarray(getattr(want, name))
        assert np.asarray(getattr(got, name), dtype=jv.dtype) == jv, name
    assert got.max_iterations == 37 and got.past == 0


def test_fixed_budget_solve_equals_jax_run_pipelined():
    """Two (16, 32) float64 batches from the module's starts, 5 iterations
    each with the convergence tests off: the summed lane iterations and
    evaluations are the JAX module's ``_run_pipelined``'s."""
    b, n, iters = 16, 32, 5
    x0s = roofline.starts(b, n, 2, dtype=torch.float64)
    want = np.random.default_rng(0).uniform(-2.0, 2.0, (b, n))
    assert np.array_equal(x0s[0].numpy(), want)
    obj = cns.models.pairwise_rosenbrock().with_mode("first")
    _, its, nfev, trips = roofline._run_pipelined(
        obj, cns.Lbfgs(m=roofline.M), x0s,
        roofline.fixed_iteration_stopping(iters, torch.float64), "cpu")
    _, jits, jnfev = jroofline._run_pipelined(
        JaxLbfgs(m=jroofline.M), [jnp.asarray(x.numpy()) for x in x0s],
        jroofline.fixed_iteration_stopping(iters, jnp.float64))
    assert its == jits and its >= 2 * b * iters
    assert nfev == jnfev
    assert len(trips) == 2 and min(trips) > iters


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_working_set_is_the_flat_carry(dtype):
    b, n, m = 6, 10, 4
    obj = cns.models.pairwise_rosenbrock()
    x0 = roofline.starts(b, n, dtype=dtype)[0]
    st, _ = fs.init_flat_state(obj.evaluate(x0), m, 20)
    carry = sum(getattr(st, f.name).nbytes
                for f in dataclasses.fields(st))
    assert roofline.flat_working_set(b, n, m, x0.element_size()) == carry


@pytest.mark.parametrize("op,batch,n", [
    ("flat_trip", 1024, 32), ("flat_trip", 1024, 1024),
    ("lbfgs_prologue", 1024, 1024), ("lbfgs_prologue", 65536, 1024),
    ("push_two_loop", 1024, 32), ("two_loop", 1024, 1024),
    ("flat_trip", 256, 4096)])
def test_chain_term_follows_the_lane_mapping(op, batch, n):
    mp = lane_mapping(op, batch, n, roofline.M, 4)
    depth = {32: 5, 64: 7, 128: 8, 256: 9, 512: 10}[mp.threads_per_lane]
    assert roofline.reduction_depth(mp.threads_per_lane) == depth
    waves = roofline.waves(mp, CARD)
    assert waves >= 1 and waves * CARD.sms * roofline.SM_BLOCKS >= mp.blocks
    assert roofline.chain_ms(op, batch, n, CARD) == pytest.approx(
        2 * roofline.M * depth * waves * roofline.DEP_STEP_NS * 1e-6,
        rel=1e-12)
    if batch == 65536:  # more lanes than the card holds at once
        assert waves > 1


def test_l2_regime():
    """The carry fits the L2 at (1024, 32): no bytes term.  At (1024,
    1024) only its excess over the L2 is charged, once an iteration."""
    small = roofline.bound_terms(1024, 32, CARD)
    assert small["l2_resident"] and small["light_ms"] == 0.0
    big = roofline.bound_terms(1024, 1024, CARD)
    ws = roofline.flat_working_set(1024, 1024)
    assert not big["l2_resident"] and ws > CARD.l2_bytes
    assert big["light_ms"] == pytest.approx(
        (ws - CARD.l2_bytes) / CARD.hbm_bytes_per_s * 1e3, rel=1e-12)
    bigger = dataclasses.replace(CARD, l2_bytes=2 * ws)
    assert roofline.bound_terms(1024, 1024, bigger)["light_ms"] == 0.0
    for n, terms in ((32, small), (1024, big)):
        # The phases' bytes are the carry's, which light_ms charges.
        assert terms["kernel_model_ms"] == roofline.kernel_model_ms(
            "flat_trip", 1024, n, CARD)
        assert terms["kernel_model_ms"] < roofline.kernel_model_ms(
            "flat_trip", 1024, n, CARD, bytes_rate=CARD.hbm_bytes_per_s)


def _made_up_row(batch, n, per_iter_ms, kernel_ms):
    return {"batch": batch, "n": n, "nfev_per_iter": 1.25,
            "per_batched_iter_ms": per_iter_ms, "kernel_ms": kernel_ms,
            "kernel_gbps": 1000.0, "lane_iters_per_s": batch / per_iter_ms,
            "device_busy_ms_per_iter": 0.1, "device_busy_pct": 5.0}


@pytest.mark.parametrize("batch,n", [(1024, 32), (1024, 1024)])
def test_bound_reads_no_measured_kernel_time(batch, n):
    row = roofline.analyze_shape(_made_up_row(batch, n, 2.0, 0.05), CARD,
                                 0.04, 0.7)
    slower = roofline.analyze_shape(_made_up_row(batch, n, 20.0, 0.5), CARD,
                                    0.04, 0.7)
    assert slower["attainable_ms"] == row["attainable_ms"]
    assert slower["bottleneck"] == row["bottleneck"]
    assert slower["pct_of_attainable"] == pytest.approx(
        row["pct_of_attainable"] / 10, rel=1e-12)


def test_write_markdown_renders_every_row(tmp_path):
    rows = [roofline.analyze_shape(_made_up_row(b, n, 1.5, 0.02), CARD,
                                   0.04, 0.7)
            for b, n in roofline.GRID]
    rows[1]["kernel_ms"] = None
    sharded = {"n": 4096, "mesh_devices": 1, "reps": 8,
               "budgets": [50, 400], "per_iter_ms_model_sharded": 12.5,
               "per_eval_ms_model_sharded": 2.75,
               "nfev_per_iter": [1.16, 4.56]}
    cross = {"batch": 1024, "n": 256, "counted_bytes_per_iter": 2e7,
             "model_bytes_per_iter": 5e7, "counted_over_model": 0.4}
    path = tmp_path / "ROOFLINE_TORCH.md"
    roofline.write_markdown(rows, CARD, str(path), "700.00 W", sharded,
                            cross, [("(B=8, n=16)", "| phase |")])
    text = path.read_text()
    for r in rows:
        assert f"| {r['batch']} | {r['n']} |" in text
        assert r["bottleneck"] in text
    assert "700.00 W" in text and "12.500 ms" in text
    assert "2.750 ms an evaluation" in text
    assert "1.16 in the first 50" in text and "4.56 in the contrast" in text
    assert "n/a" in text and "ratio 0.400" in text
    assert "### (B=8, n=16)" in text


def test_main_without_a_card_prints_nothing_and_exits_1(capsys,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert roofline.main([]) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "no CUDA device" in out.err


MEASUREMENTS = {
    "measure_shape": lambda d: roofline.measure_shape(8, 16, device=d),
    "measure_solver_shape": lambda d: roofline.measure_solver_shape(
        8, 16, cns.Bfgs(), device=d),
    "measure_kernel_standalone": lambda d: roofline.measure_kernel_standalone(
        8, 16, device=d),
    "measure_eval_standalone": lambda d: roofline.measure_eval_standalone(
        8, 16, device=d),
    "measure_model_sharded": lambda d: roofline.measure_model_sharded(
        device=d),
    "trip_work_cross_check": lambda d: roofline.trip_work_cross_check(
        device=d),
    "card_params": roofline.card_params,
}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("name", sorted(MEASUREMENTS))
def test_measurements_raise_without_a_card(monkeypatch, name, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        MEASUREMENTS[name](device)


@pytest.mark.parametrize("name,shape,bound_ms,bound_by,regime", [
    ("flat_trip", (1024, 1024), 0.0237, "bytes", "bytes beyond L2"),
    ("mt_trip", (1024, 1024), 0.00469, "bytes", "fits L2"),
    ("push_two_loop", (1024, 32), 0.00069, "bytes", "fits L2, chain binds"),
    ("lbfgs_prologue_t", (1024, 1024), 0.0248, "bytes", "bytes beyond L2"),
    ("two_loop", (1024, 1024), 0.0001, "operations",
     "operations, chain binds"),
    ("lbfgs_epilogue", (1024, 1024), 0.5, "operations", "operations")])
def test_kernel_attainable_regimes(name, shape, bound_ms, bound_by, regime):
    """A bytes bound counts only beyond the L2, an operations bound stands,
    and a history kernel's chain is a floor beside either."""
    ops_ms = 1e-5
    got, got_regime = roofline.kernel_attainable_ms(
        name, *shape, bound_ms, bound_by, CARD, ops_ms)
    assert got_regime == regime
    beyond = max(0.0, bound_ms * 1e-3 * CARD.hbm_bytes_per_s - CARD.l2_bytes)
    base = (bound_ms if bound_by == "operations"
            else max(beyond / CARD.hbm_bytes_per_s * 1e3, ops_ms))
    chain = 0.0
    if name != "lbfgs_prologue_t" and name in roofline.HISTORY_KERNELS:
        chain = roofline.chain_ms(name, *shape, CARD)
    elif name == "lbfgs_prologue_t":
        chain = roofline.chain_ms("lbfgs_prologue", *shape, CARD) / (
            roofline.waves(lane_mapping("lbfgs_prologue", *shape,
                                        roofline.M, 4), CARD))
    assert got == pytest.approx(max(base, chain), rel=1e-12)
