"""Trips of the flat loop a solve, the mean over the window's solves: each
trip is one batched evaluation, one step launch and one status read."""


def read(run):
    return sum(run.trips) / len(run.trips) if run.trips else None
