"""Port vs JAX package: the standalone multigrid solve, end to end.

Both packages solve the same problem on the CPU in complex128: equal
``exit_message`` and ``it_mg``, fields within rel 1e-9 (the solves take
the same iterations; the difference is rounding), equal info_dict keys.
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


def _fullspace(n=16):
    grid = jt.TensorMesh([np.full(n, 100.)] * 3,
                         origin=(-n * 50.,) * 3)
    model = jt.Model(grid, property_x=1.0, property_z=3.0)
    return grid, model, (0., 0., 0., 0., 0.)


def _triaxial():
    rng = np.random.default_rng(11)
    shape = (16, 8, 12)
    h = [60. * 1.1 ** np.abs(np.arange(n) - (n - 1) / 2) for n in shape]
    grid = jt.TensorMesh(h, origin=tuple(-hh.sum() / 2 for hh in h))
    rho = 10 ** rng.uniform(0, 1, shape)
    model = jt.Model(grid, rho, rho * rng.uniform(1, 2, shape),
                     rho * rng.uniform(1, 3, shape))
    return grid, model, (-30., 30., 0., 0., 0., 0.)


def _mapped(n=8):
    """HTI in log10 conductivity, with μr and εr: η and ζ through every
    term of the volume model."""
    rng = np.random.default_rng(4)
    grid = jt.TensorMesh([np.full(n, 100.)] * 3, origin=(-n * 50.,) * 3)
    shape = (n,) * 3
    model = jt.Model(grid, rng.uniform(-1, 0, shape),
                     property_y=rng.uniform(-1.5, -0.5, shape),
                     mu_r=rng.uniform(1, 2, shape),
                     epsilon_r=rng.uniform(1, 20, shape),
                     mapping='LgConductivity')
    return grid, model, (0., 0., 0., 0., 0.)


def _both(grid_j, model_j, src, freq=1.0):
    grid_p = convert.mesh_to_torch(grid_j)
    model_p = convert.model_to_torch(model_j)
    return ((grid_j, model_j, jt.get_source_field(grid_j, src, freq)),
            (grid_p, model_p, pt.get_source_field(grid_p, src, freq)))


def _check(ej, ij, ep, ip):
    assert set(ip) == set(ij)
    assert ip['exit_message'] == ij['exit_message'] == 'CONVERGED'
    assert ip['it_mg'] == ij['it_mg']
    assert np.asarray(ej.fx).dtype == ep.fx.dtype
    assert tp.rel((ep.field,), (ej.field,)) < TOL
    assert abs(ip['rel_error'] - ij['rel_error']) <= 1e-6 * ij['rel_error']


# (problem, frequency, solve options): the F/V/W cycles at 16³, a
# stretched tri-axial model, a rotating semicoarsening schedule (y, z
# alternately kept fine), the Laplace domain (real fields, f < 0) and a
# log-mapped HTI model with μr and εr.
CASES = {
    'fullspace-F': (lambda: _fullspace(), 1.0, {'cycle': 'F'}),
    'fullspace-V': (lambda: _fullspace(), 1.0, {'cycle': 'V'}),
    'fullspace-W': (lambda: _fullspace(), 1.0, {'cycle': 'W'}),
    'triaxial-F': (_triaxial, 1.0, {'cycle': 'F'}),
    'semicoarsening-F': (lambda: _fullspace(8), 1.0,
                         {'cycle': 'F', 'semicoarsening': 23}),
    'laplace-F': (lambda: _fullspace(8), -1.0, {'cycle': 'F'}),
    'mapped-F': (_mapped, 1.0, {'cycle': 'F'}),
}


@pytest.mark.parametrize('case', list(CASES))
def test_solve_matches_jax(case):
    problem, freq, opts = CASES[case]
    (gj, mj, sj), (gp, mp, sp) = _both(*problem(), freq=freq)
    ej, ij = jt.solve(gj, mj, sj, verb=1, return_info=True, **opts)
    ep, ip = pt.solve(gp, mp, sp, verb=1, return_info=True, device='cpu',
                      **opts)
    _check(ej, ij, ep, ip)


def test_warm_start_in_place():
    (gj, mj, sj), (gp, mp, sp) = _both(*_fullspace())
    # Two cycles, then continue from the partial field in place.
    fj = jt.solve(gj, mj, sj, verb=0, maxit=2)
    fp = pt.solve(gp, mp, sp, verb=0, maxit=2, device='cpu')
    assert tp.rel((fp.field,), (fj.field,)) < TOL
    buf = fp.fx
    ij = jt.solve(gj, mj, sj, efield=fj, verb=0, return_info=True)
    ip = pt.solve(gp, mp, sp, efield=fp, verb=0, return_info=True,
                  device='cpu')
    assert fp.fx is buf                    # updated in place
    _check(fj, ij, fp, ip)
    # Already converged: nothing done, no cycle run.
    ij2 = jt.solve(gj, mj, sj, efield=fj, verb=0, return_info=True)
    ip2 = pt.solve(gp, mp, sp, efield=fp, verb=0, return_info=True,
                   device='cpu')
    assert ip2['exit_message'] == ij2['exit_message'] == 'CONVERGED'
    assert ip2['it_mg'] == ij2['it_mg'] == 0


def test_zero_source():
    (gj, mj, _), (gp, mp, _) = _both(*_fullspace(4))
    sj = jt.SourceField.zeros(gj, frequency=1.0)
    sp = pt.SourceField.zeros(gp, frequency=1.0)
    ej, ij = jt.solve(gj, mj, sj, verb=0, return_info=True)
    ep, ip = pt.solve(gp, mp, sp, verb=0, return_info=True, device='cpu')
    assert ip['exit_message'] == ij['exit_message'] == 'CONVERGED'
    assert not np.any(ep.field) and not np.any(np.asarray(ej.field))
    # With an initial field: zeroed in place.
    fp = pt.Field(*(np.ones(s, complex) for s in
                    (gp.shape_edges_x, gp.shape_edges_y, gp.shape_edges_z)),
                  frequency=1.0)
    assert pt.solve(gp, mp, sp, efield=fp, verb=0, device='cpu') is None
    assert not np.any(fp.field)


def test_convert_round_trip():
    grid_j, par = tp.level(jt, (5, 4, 3), seed=2)
    t = convert.params_to_torch(par)
    assert t[0].dtype == torch.complex128 and t[3].dtype == torch.float64
    for a, b in zip(convert.params_to_numpy(t), par):
        np.testing.assert_array_equal(a, b)
    iso = (par[0], par[0], par[0]) + par[3:]
    ti = convert.params_to_torch(iso)
    assert ti[1] is ti[0] and ti[2] is ti[0]

    f = tp.random_fields((5, 4, 3), seed=1)
    ft = convert.fields_to_torch(f)
    ft[0][0, 0, 0] = 0                      # a copy, not a view
    assert f[0][0, 0, 0] != 0
    for a, b in zip(convert.fields_to_numpy(convert.fields_to_torch(f)),
                    f):
        np.testing.assert_array_equal(a, b)

    grid_p = convert.mesh_to_torch(grid_j)
    back = convert.mesh_to_numpy(grid_p)
    for a, b in zip(back['h'], grid_j.h):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back['origin'], grid_j.origin)
    assert grid_p.shape_cells == grid_j.shape_cells

    rng = np.random.default_rng(3)
    model_j = jt.Model(grid_j, *(rng.uniform(1, 5, (5, 4, 3))
                                 for _ in range(3)), mu_r=1.5,
                       mapping='Conductivity')
    model_p = convert.model_to_torch(model_j)
    assert model_p.map.name == 'Conductivity' and model_p.case == 3
    model_j2 = jt.Model.from_dict(convert.model_to_numpy(model_p))
    assert model_j2 == model_j
    sj = jt.SourceField.zeros(grid_j, frequency=2.0)
    vj = jt.VolumeModel(grid_j, model_j, sj)
    vp = pt.VolumeModel(grid_p, model_p,
                        pt.SourceField.zeros(grid_p, frequency=2.0))
    for name in ('eta_x', 'eta_y', 'eta_z', 'zeta'):
        np.testing.assert_array_equal(np.asarray(getattr(vp, name)),
                                      np.asarray(getattr(vj, name)))
