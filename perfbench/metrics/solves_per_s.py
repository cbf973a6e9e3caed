"""Lanes that stopped on a convergence status, over every solve the window
completed, per second from the window's start to the end of its last
solve."""


def read(run):
    return run.converged / run.window_s if run.window_s > 0 else None
