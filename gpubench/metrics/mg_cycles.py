"""Multigrid cycles per job: the sum of ``info['it_mg']`` over the
job's solves (a batched solve counts its shared cycles once)."""


def read(run):
    if run.jobs == 0 or not run.recorder.it_mg:
        return None
    return sum(run.recorder.it_mg) / run.jobs
