"""Share of the traced window in which the card ran the collectives' (NCCL)
kernels of the solves, waits on the slowest rank included: 100 times their
device seconds over the window."""


def read(run):
    c, s = getattr(run, "comm", None), run.summary
    if c is None or s is None or c[1] == 0 or s.window_s <= 0:
        return None
    return 100.0 * c[0] / s.window_s
