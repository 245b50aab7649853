"""Blocking device-to-host fetches per job: the number of the
program's ``sync`` spans (``emg3d_tpu_torch.trace``).  None where the
program records no such span."""


def read(run):
    try:
        from emg3d_tpu_torch import trace
    except ImportError:
        return None
    got = trace.totals().get('sync')
    if run.jobs == 0 or not got:
        return None
    return got['calls'] / run.jobs
