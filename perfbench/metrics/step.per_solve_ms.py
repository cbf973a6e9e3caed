"""Device time launched inside the port's ``cns.init`` and ``cns.assemble``
spans (the carry's set-up, the history's gather, the result's copies and
the solver's internals), in ms a solve of the window.  Read from
``run.host_split`` (``host_spans.split``), which only a traced run with the
port's span recorder installed has."""


def read(run):
    h = getattr(run, "host_split", None)
    if h is None or h.solves <= 0:
        return None
    return 1e3 * h.fixed_device_s / h.solves
