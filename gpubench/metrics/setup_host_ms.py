"""Host ms per job from a solve's entry to its first cycle: the
program's ``solve.setup`` spans (``emg3d_tpu_torch.trace``), summed over
the traced window's solves.  None where the program records no such
span."""


def read(run):
    try:
        from emg3d_tpu_torch import trace
    except ImportError:
        return None
    got = trace.totals().get('solve.setup')
    if run.jobs == 0 or not got:
        return None
    return got['ns'] / run.jobs / 1e6
