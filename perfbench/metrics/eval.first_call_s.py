"""Seconds of the process's first ``cns.eval`` span: the warm-up's first
batched ``torch.func`` call at the cell's shape.  Read from
``run.host_split`` (``host_spans.split``), which only a traced run with the
port's span recorder installed from before the warm-up has."""


def read(run):
    h = getattr(run, "host_split", None)
    return None if h is None else h.first_eval_s
