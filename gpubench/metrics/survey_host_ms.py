"""Host ms per job in the survey layer around the solve: the program's
``survey.sfield`` (a pair's source field), ``survey.grid`` (a grid or
model per share key) and ``survey.responses`` (a pair's receiver
responses) spans (``emg3d_tpu_torch.trace``).  None where the program
records none of them."""

SPANS = ('survey.sfield', 'survey.grid', 'survey.responses')


def read(run):
    try:
        from emg3d_tpu_torch import trace
    except ImportError:
        return None
    got = trace.totals()
    ns = sum(got[name]['ns'] for name in SPANS if name in got)
    if run.jobs == 0 or not ns:
        return None
    return ns / run.jobs / 1e6
