"""Job kind ``survey``: ``Simulation.compute()`` of a marine towline.

Each job moves the configuration's sources by the drawn ``tow_offset``
(x and y; altitude, receivers and frequencies never change), builds the
``Survey`` of those sources, the receivers and the frequencies, and runs
``Simulation(..., gridding='same', max_workers=1).compute()`` with the
configuration's and the workload's solver options.  Every (source,
frequency) pair shares the grid and the model, so the port solves them
all as one ``solver.solve_batched`` call, one lane a pair.

``check`` judges every pair of the kept jobs: the reference's relative
residual (``residual``), its distance from the lane's reported
``rel_error`` (``residual_gap``), and ``responses``, the largest
|``data.synthetic`` − the reference's response of the returned field|
over the receivers, over the largest |reference response|.
"""
import numpy as np

from .. import marine, problem, reference
from ..reference import receivers

__all__ = ['prepare', 'run', 'check']


def prepare(config, workload, device, rehearse=False):
    import emg3d_tpu_torch as pt
    h, origin = marine.widths(config, rehearse)
    opts = {**config.get('solver', {}), **workload.get('solver', {}),
            'verb': 0}
    if rehearse:
        opts['device'] = 'cpu'
    grid = pt.TensorMesh(h, origin=origin)
    rho = marine.resistivity(config['model'], h, origin)
    return {'pt': pt, 'config': config, 'h': h,
            'nodes': problem.nodes(h, origin), 'grid': grid, 'rho': rho,
            'model': pt.Model(grid, *rho, mapping='Resistivity'),
            'opts': opts}


def run(prep, draw, rec):
    pt = prep['pt']
    srcs, recs, freqs = marine.survey(prep['config'], draw['tow_offset'])
    survey = pt.Survey('tow', tuple(np.array(srcs).T),
                       tuple(np.array(recs).T), freqs)
    sim = pt.Simulation('tow', survey, prep['grid'], prep['model'],
                        gridding='same', solver_opts=prep['opts'], verb=-1,
                        max_workers=1)
    sim.compute()
    data = np.asarray(sim.data.synthetic)
    pairs, converged = [], []
    for i, (src, name) in enumerate(zip(srcs, survey.sources)):
        for k, f in enumerate(freqs):
            e = sim.get_efield(name, f)
            info = sim.get_efield_info(name, f)
            pairs.append((src, f, (e.fx, e.fy, e.fz),
                          float(info['rel_error']), data[i, :, k].copy()))
            converged.append(info['exit_message'] == 'CONVERGED')
    return {'pairs': len(pairs), 'converged': converged,
            'keep': (recs, pairs)}


def check(prep, kept, device, control=False):
    """Over every pair of the kept jobs, the largest ``residual`` by the
    reference's ``relative_residuals``, the largest ``residual_gap``
    from the lane's reported ``rel_error`` and the largest
    ``responses``.  ``control`` judges the fields rounded to complex64
    instead."""
    worst = {'residual': 0.0, 'residual_gap': 0.0, 'responses': 0.0}
    for recs, pairs in kept:
        fields, sources, etas, reported = [], [], [], []
        for src, f, e, rel, data in pairs:
            if control:
                e = tuple(np.asarray(c).astype(np.complex64) for c in e)
            eta, zeta = reference.eta_zeta(prep['h'], prep['rho'], f)
            fields.append(e)
            sources.append(reference.source_field(prep['nodes'], src, f))
            etas.append(eta)
            reported.append(rel)
            ref = receivers.responses(prep['nodes'], e, recs)
            with np.errstate(invalid='ignore', divide='ignore'):
                off = np.max(np.abs(data - ref)) / np.max(np.abs(ref))
            worst['responses'] = max(worst['responses'], _num(off))
        rels = reference.relative_residuals(fields, sources, etas, zeta,
                                            prep['h'], device)
        for r, rel in zip(rels, reported):
            worst['residual'] = max(worst['residual'], _num(r))
            worst['residual_gap'] = max(worst['residual_gap'],
                                        _num(abs(r - rel)))
    return worst


def _num(x):
    """A reading, with NaN (a missing or broken answer) as infinity."""
    x = float(x)
    return float('inf') if np.isnan(x) else x
