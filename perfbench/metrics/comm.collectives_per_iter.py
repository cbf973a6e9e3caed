"""The collectives' (NCCL) kernel launches of the window's solves, as the
device trace counts them, over the solver iterations of those solves."""


def read(run):
    c, iterations = getattr(run, "comm", None), getattr(run, "iterations", 0)
    if c is None or c[1] == 0 or not iterations:
        return None
    return c[1] / iterations
