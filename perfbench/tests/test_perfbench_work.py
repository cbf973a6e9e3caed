"""The frozen step count against the port's roofline harness's rule
(``benchmarks_torch.roofline.trip_work``, counted trip by trip while a
solve runs) on small float64 CPU solves, and the evaluation's count.

``work.step_work`` works the lane states out from what a solve returns
(evaluations, iterations, history count), taking every boundary but a
lane's last to push an accepted pair.  Where a pair is rejected, the
boundary reads the same rows but writes none: the frozen count is then
2 n itemsize bytes a rejected pair higher than the rule, and 10 n
operations a later boundary higher for each row it did not read."""

import pytest
import torch

import cppnumericalsolvers_tpu_torch as cns
from benchmarks_torch.roofline import HBM_BYTES_PER_S, PEAK_OPS_PER_S, trip_work
from perfbench import work
from perfbench.problems import mgh21_rosenbrock as mgh21


@pytest.mark.parametrize("b,n,seed,half", [(8, 16, 0, 2.0), (5, 64, 1, 2.0),
                                           (6, 32, 2, 0.25), (3, 256, 3, 2.0)])
def test_step_count_equals_the_rule(b, n, seed, half):
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(seed)
    centre = 0.0 if half == 2.0 else 1.0
    x0 = centre + half * (2 * torch.rand(b, n, generator=g,
                                         dtype=torch.float64) - 1)
    obj = cns.models.pairwise_rosenbrock()
    stop = cns.default_stopping(torch.float64)
    rule = trip_work(obj, x0, stop, m=10, max_fev=20)
    res = cns.minimize_batched(obj, x0, cns.Lbfgs(m=10), stop, device="cpu")
    assert res.trips == rule["trips"]
    byts, ops = work.step_work(res.trips, res.state.nfev,
                               res.progress.num_iterations,
                               res.internals.mem_count, n, 10, 8)
    assert float(byts) == pytest.approx(
        rule["bytes_per_trip"] * rule["trips"], rel=1e-12)
    assert float(ops) == pytest.approx(
        rule["ops_per_trip"] * rule["trips"], rel=1e-12)


def test_peaks_are_the_data_sheets():
    assert work.HBM_BYTES_PER_S == HBM_BYTES_PER_S
    assert work.PEAK_OPS_PER_S[4] == PEAK_OPS_PER_S["float32"]
    assert work.PEAK_OPS_PER_S[8] == PEAK_OPS_PER_S["float64"]
    assert work.bound_seconds(3.35e12, 0, 4) == pytest.approx(1.0)
    assert work.bound_seconds(0, 67e12, 4) == pytest.approx(1.0)


def test_evaluation_count():
    assert mgh21.eval_bytes(4, 8, 4) == (2 * 4 * 8 + 4) * 4
    assert mgh21.eval_ops(4, 8) == 13 * 4 * 4
