"""The batched evaluation's least bytes and operations at the published
peaks, over the device time of what was launched inside the benchmark's
evaluation spans."""

from perfbench.work import bound_seconds


def read(run):
    s = run.summary
    if s is None or s.eval_s <= 0:
        return None
    return 100.0 * bound_seconds(run.eval_bytes, run.eval_ops,
                                 run.itemsize) / s.eval_s
