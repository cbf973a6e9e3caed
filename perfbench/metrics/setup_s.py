"""Process start to the first timed solve: imports, the card, the kernel's
library, the inputs and the warm-up."""


def read(run):
    return run.setup_s
