"""Seconds from the start of the process to the first timed job: import,
the kernel library (built or loaded from its cache in the checkout),
the inputs and one warm-up job of the cell's own shapes."""


def read(run):
    return run.setup_s
