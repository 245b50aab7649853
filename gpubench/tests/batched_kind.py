"""A job kind that lives only in the tests: ``Simulation.compute()`` of a
small survey, whose (source, frequency) pairs the port solves as one
batch through ``solver.solve_batched``.

It keeps the contract of ``gpubench/jobs/``: it reaches the solver only
through ``Simulation``, and its ``check`` returns ``residual`` and
``residual_gap`` over every pair of every job it keeps.  The tests run
the harness on a cell of this kind to show that the fault and control
tests hold a batched cell with no edit.  Its configuration gives the
grid and model as ``problem`` reads them, ``sources`` (x, y, z,
azimuth, dip; each job moves all of them by the drawn
``source_offset``), ``receivers`` and ``frequencies``.
"""
import numpy as np

from gpubench import problem, reference

__all__ = ['prepare', 'run', 'check']


def prepare(config, workload, device, rehearse=False):
    import emg3d_tpu_torch as pt
    h, origin = problem.widths(config['grid'])
    opts = {**config.get('solver', {}), **workload.get('solver', {}),
            'verb': 0}
    if rehearse:
        opts['device'] = 'cpu'
    grid = pt.TensorMesh(h, origin=origin)
    rho = problem.resistivity(config['model'], h)
    return {'pt': pt, 'config': config, 'h': h,
            'nodes': problem.nodes(h, origin), 'grid': grid, 'rho': rho,
            'model': pt.Model(grid, *rho, mapping='Resistivity'),
            'opts': opts}


def run(prep, draw, rec):
    pt, config = prep['pt'], prep['config']
    offset = np.asarray(draw['source_offset'], float)
    srcs = [tuple((np.asarray(s[:3], float) + offset).tolist()) + tuple(s[3:])
            for s in config['sources']]
    freqs = [float(f) for f in config['frequencies']]
    survey = pt.Survey('batched', tuple(np.array(srcs).T),
                       tuple(np.array(config['receivers'], float).T), freqs)
    sim = pt.Simulation('batched', survey, prep['grid'], prep['model'],
                        gridding='same', solver_opts=prep['opts'], verb=-1,
                        max_workers=1)
    sim.compute()
    pairs, converged = [], []
    for src, name in zip(srcs, survey.sources):
        for f in freqs:
            e = sim.get_efield(name, f)
            info = sim.get_efield_info(name, f)
            pairs.append((src, f, (e.fx, e.fy, e.fz),
                          float(info['rel_error'])))
            converged.append(info['exit_message'] == 'CONVERGED')
    return {'pairs': len(pairs), 'converged': converged, 'keep': pairs}


def check(prep, kept, device, control=False):
    """Over every pair of the kept jobs, the largest ``residual`` by the
    reference's ``relative_residuals`` and the largest ``residual_gap``
    from the lane's reported ``rel_error``.  ``control`` judges the
    fields rounded to complex64 instead."""
    worst = {'residual': 0.0, 'residual_gap': 0.0}
    zeta = None
    for pairs in kept:
        fields, sources, etas, reported = [], [], [], []
        for src, f, e, rel in pairs:
            if control:
                e = tuple(np.asarray(c).astype(np.complex64) for c in e)
            eta, zeta = reference.eta_zeta(prep['h'], prep['rho'], f)
            fields.append(e)
            sources.append(reference.source_field(prep['nodes'], src, f))
            etas.append(eta)
            reported.append(rel)
        rels = reference.relative_residuals(fields, sources, etas, zeta,
                                            prep['h'], device)
        for r, rel in zip(rels, reported):
            worst['residual'] = max(worst['residual'], _num(r))
            worst['residual_gap'] = max(worst['residual_gap'],
                                        _num(abs(r - rel)))
    return worst


def _num(x):
    x = float(x)
    return float('inf') if np.isnan(x) else x
