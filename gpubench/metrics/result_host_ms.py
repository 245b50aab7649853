"""Host ms per job from a solve's last cycle to its return: the
program's ``solve.result`` spans (``emg3d_tpu_torch.trace``), the
solution's fetch from the device and the Field built from it.  None
where the program records no such span."""


def read(run):
    try:
        from emg3d_tpu_torch import trace
    except ImportError:
        return None
    got = trace.totals().get('solve.result')
    if run.jobs == 0 or not got:
        return None
    return got['ns'] / run.jobs / 1e6
