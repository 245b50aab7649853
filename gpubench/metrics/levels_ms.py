"""Host ms per job in level set-up: ``solver.build_levels`` and the
smoother states (``line_gs.line_state``, ``point_gs.point_state``),
each call ending in a synchronize."""


def read(run):
    if run.jobs == 0:
        return None
    return run.recorder.host.get('levels', 0.0) / run.jobs * 1e3
