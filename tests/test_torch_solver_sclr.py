"""Port vs JAX package: semicoarsening and line relaxation, end to end.

Both packages solve the same problem on the CPU in complex128: equal
``exit_message`` and ``it_mg``, fields within rel 1e-9 (the solves take
the same iterations; the difference is rounding, ~1e-16 measured).
Rotating schedules compile one JAX program per (level shape, direction),
so this file holds one rotating case, at 8³.
"""
import pytest

pytest.importorskip('jax')

import numpy as np  # noqa: E402
import torch  # noqa: E402

import emg3d_tpu as jt  # noqa: E402

import emg3d_tpu_torch as pt  # noqa: E402
from emg3d_tpu_torch import convert  # noqa: E402

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-9


def _fullspace(n=8):
    grid = jt.TensorMesh([np.full(n, 100.)] * 3, origin=(-n * 50.,) * 3)
    model = jt.Model(grid, property_x=1.0, property_z=3.0)
    return grid, model, (0., 0., 0., 0., 0.)


def _triaxial(shape=(16, 8, 12), seed=11):
    """Stretched cells, random tri-axial resistivities, an x-dipole."""
    rng = np.random.default_rng(seed)
    h = [60. * 1.1 ** np.abs(np.arange(n) - (n - 1) / 2) for n in shape]
    grid = jt.TensorMesh(h, origin=tuple(-hh.sum() / 2 for hh in h))
    rho = 10 ** rng.uniform(0, 1, shape)
    model = jt.Model(grid, rho, rho * rng.uniform(1, 2, shape),
                     rho * rng.uniform(1, 3, shape))
    return grid, model, (-30., 30., 0., 0., 0., 0.)


def _mapped(n=8):
    """VTI in ln resistivity, with μr: η and ζ through the log map and
    the permeability term."""
    rng = np.random.default_rng(6)
    grid = jt.TensorMesh([np.full(n, 100.)] * 3, origin=(-n * 50.,) * 3)
    shape = (n,) * 3
    model = jt.Model(grid, rng.uniform(0, 1, shape),
                     property_z=rng.uniform(0.5, 1.5, shape),
                     mu_r=rng.uniform(1, 2, shape), mapping='LnResistivity')
    return grid, model, (0., 0., 0., 0., 0.)


def _both(grid_j, model_j, src, freq=1.0):
    grid_p = convert.mesh_to_torch(grid_j)
    model_p = convert.model_to_torch(model_j)
    return ((grid_j, model_j, jt.get_source_field(grid_j, src, freq)),
            (grid_p, model_p, pt.get_source_field(grid_p, src, freq)))


def check(ej, ij, ep, ip, exit_message='CONVERGED'):
    assert set(ip) == set(ij)
    assert ip['exit_message'] == ij['exit_message'] == exit_message
    assert ip['it_mg'] == ij['it_mg']
    assert ip['it_ssl'] == ij['it_ssl']
    fj = np.asarray(ej.field)
    if np.any(fj):
        assert tp.rel((ep.field,), (fj,)) < TOL
    else:                                   # an aborted Krylov solve
        assert not np.any(ep.field)
    # The residual may sit at the rounding floor (~1e-12 of the source's
    # norm) after a Krylov step: there it agrees to that floor only.
    assert (abs(ip['abs_error'] - ij['abs_error'])
            <= 1e-6 * ij['abs_error'] + 1e-12 * ij['ref_error'])


# (problem, solve options): a fixed sc/lr pair on the VTI fullspace,
# x/y/z lines together on a stretched tri-axial model, and the mirror of
# tests/test_solver.py:239-246 (sc 123, lr 456 rotating, nu_init 2) on a
# seeded tri-axial 8³ model, held against the JAX package instead of
# the golden file; a fixed sc/lr pair on a log-mapped VTI model with μr.
CASES = {
    'sc3-lr1': (_fullspace, {'semicoarsening': 3, 'linerelaxation': 1}),
    'lr7-triaxial': (_triaxial, {'linerelaxation': 7}),
    'sc123-lr456-rotating': (
        lambda: _triaxial((8, 8, 8), seed=2),
        {'semicoarsening': 123, 'linerelaxation': 456, 'tol': 1e-4,
         'maxit': 4, 'nu_init': 2, 'clevel': 10}),
    'sc2-lr3-mapped': (_mapped, {'semicoarsening': 2, 'linerelaxation': 3}),
}


@pytest.mark.parametrize('case', list(CASES))
def test_sclr_solve_matches_jax(case):
    problem, opts = CASES[case]
    (gj, mj, sj), (gp, mp, sp) = _both(*problem())
    ej, ij = jt.solve(gj, mj, sj, verb=1, return_info=True, **opts)
    ep, ip = pt.solve(gp, mp, sp, verb=1, return_info=True, device='cpu',
                      **opts)
    check(ej, ij, ep, ip)
