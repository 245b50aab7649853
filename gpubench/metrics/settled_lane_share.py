"""Share of the lanes a batched Krylov loop computes that had already
converged or broken down, whose results the loop discards: 100 ×
``krylov.settled_lane_iters`` / ``krylov.lane_iters``, the program's
counters (``emg3d_tpu_torch.trace``), in %.  None where the program
counts no lane."""


def read(run):
    try:
        from emg3d_tpu_torch import trace
    except ImportError:
        return None
    got = trace.counts()
    lanes = got.get('krylov.lane_iters', 0)
    if run.jobs == 0 or not lanes:
        return None
    return 100.0 * got.get('krylov.settled_lane_iters', 0) / lanes
