"""Job kind ``solve``: one standalone solve of a source on the
configuration's model.

Each job places the configuration's dipole at its centre plus the drawn
``source_offset``, builds its source field and calls ``solver.solve``
with the configuration's and the workload's solver options.  One pair a
job.  The source field is host-only work of the same size in every job:
its seconds (``host_s``) witness the host's speed.
"""
import time

import numpy as np

from .. import problem, reference

__all__ = ['prepare', 'run', 'check']


def prepare(config, workload, device, rehearse=False):
    import emg3d_tpu_torch as pt
    h, origin = problem.widths(config['grid'])
    if rehearse:
        h, origin = problem.rehearsal_grid(h, origin)
    opts = {**config.get('solver', {}), **workload.get('solver', {})}
    if rehearse:
        opts['device'] = 'cpu'
    grid = pt.TensorMesh(h, origin=origin)
    rho = problem.resistivity(config['model'], h)
    return {'pt': pt, 'config': config, 'h': h, 'origin': origin,
            'nodes': problem.nodes(h, origin), 'grid': grid, 'rho': rho,
            'model': pt.Model(grid, *rho, mapping='Resistivity'),
            'opts': opts}


def _source(prep, draw):
    spec = prep['config']['dipole']
    xyz = np.asarray(spec['centre'], float) + np.asarray(
        draw['source_offset'], float)
    return (*xyz.tolist(), float(spec['azimuth']), float(spec['dip']))


def run(prep, draw, rec):
    pt = prep['pt']
    from emg3d_tpu_torch import solver
    src = _source(prep, draw)
    freq = float(prep['config']['dipole']['frequency'])
    t0 = time.perf_counter()
    sfield = pt.get_source_field(prep['grid'], src, freq)
    host_s = time.perf_counter() - t0
    e, info = solver.solve(prep['grid'], prep['model'], sfield,
                           return_info=True, verb=0, **prep['opts'])
    return {'pairs': 1, 'converged': [info['exit_message'] == 'CONVERGED'],
            'keep': (src, (e.fx, e.fy, e.fz), float(info['rel_error'])),
            'host_s': host_s}


def check(prep, kept, device, control=False):
    """Over the kept jobs, the largest ``residual``, ‖s − A e‖ / ‖s‖
    with η, ζ and s of the reference, and the largest ``residual_gap``,
    its distance from the relative residual the solve reported for the
    field it returned.  ``control`` judges the fields rounded to
    complex64 instead."""
    freq = float(prep['config']['dipole']['frequency'])
    eta, zeta = reference.eta_zeta(prep['h'], prep['rho'], freq)
    worst = {'residual': 0.0, 'residual_gap': 0.0}
    for src, e, reported in kept:
        if control:
            e = tuple(np.asarray(c).astype(np.complex64) for c in e)
        s = reference.source_field(prep['nodes'], src, freq)
        r, ref = reference.residual_norms(e, s, eta, zeta, prep['h'],
                                          device)
        worst['residual'] = max(worst['residual'], _num(r / ref))
        worst['residual_gap'] = max(worst['residual_gap'],
                                    _num(abs(r / ref - reported)))
    return worst


def _num(x):
    """A reading, with NaN (a missing or broken answer) as infinity."""
    x = float(x)
    return float('inf') if np.isnan(x) else x
