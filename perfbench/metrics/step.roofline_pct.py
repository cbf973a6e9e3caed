"""The step's counted bytes and operations (``work.step_work``) at the
published peaks, over the device time of everything a solve launched
outside its evaluations: the trip kernel, the status reads' reductions, the
carry's set-up and the result's assembly."""

from perfbench.work import bound_seconds


def read(run):
    s = run.summary
    if s is None or s.step_s <= 0:
        return None
    return 100.0 * bound_seconds(run.step_bytes, run.step_ops,
                                 run.itemsize) / s.step_s
