"""GiB per job copied between pageable host arrays and the device: the
program's counters ``copy.h2d_bytes`` (source and start fields, level
arrays) and ``copy.d2h_bytes`` (the returned field), from
``emg3d_tpu_torch.trace``.  None where the program counts neither."""


def read(run):
    try:
        from emg3d_tpu_torch import trace
    except ImportError:
        return None
    got = trace.counts()
    total = got.get('copy.h2d_bytes', 0) + got.get('copy.d2h_bytes', 0)
    if run.jobs == 0 or not total:
        return None
    return total / run.jobs / 2**30
