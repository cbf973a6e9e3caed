"""Card idle while the host was inside the port's ``cns.read`` or
``cns.trip`` spans or ``cns.solve``'s own time (the status read and the
step's launch), in ms a trip of the window.  Read from ``run.host_split``
(``host_spans.split``), which only a traced run with the port's span
recorder installed has."""


def read(run):
    h = getattr(run, "host_split", None)
    if h is None or h.trips <= 0:
        return None
    return 1e3 * h.loop_s / h.trips
