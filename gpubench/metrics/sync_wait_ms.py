"""Host ms per job spent in blocking device-to-host fetches: the
program's ``sync`` spans (``emg3d_tpu_torch.trace``: norms, inner
products, the returned field's components), each ending when the
device has finished the work the fetched value waits on.  None where
the program records no such span."""


def read(run):
    try:
        from emg3d_tpu_torch import trace
    except ImportError:
        return None
    got = trace.totals().get('sync')
    if run.jobs == 0 or not got:
        return None
    return got['ns'] / run.jobs / 1e6
