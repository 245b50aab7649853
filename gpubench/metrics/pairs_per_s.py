"""(source, frequency) pairs solved to the cell's tolerance per second:
every pair of every job in the window over the whole window, from the
start of the first job to the end of the last (host clock; each job
ends in a synchronize)."""


def read(run):
    return run.pairs / run.window_s if run.window_s > 0 else None
