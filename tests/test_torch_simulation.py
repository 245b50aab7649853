"""Port vs JAX package: receivers, Survey, Simulation and the gradient.

- The receivers (``get_receiver``, ``get_receiver_response``,
  ``get_h_field``) equal the JAX package's at rel 1e-12 on the same
  fields.
- A Simulation over an 8³ survey of two sources and two frequencies
  (``sslsolver=False``; the pairs run as one batched solve):
  ``compute(observed=True)`` with a fixed noise seed, ``misfit`` and
  ``gradient`` within rel 1e-8 of ``emg3d_tpu``'s.
- The housekeeping of tests/test_simulations.py:34-235: ``to_dict`` /
  ``from_dict``, ``clean``, ``expand_grid_model``,
  ``estimate_gridding_opts`` and the threaded per-pair solves.
"""
import pytest

pytest.importorskip('jax')

import numpy as np  # noqa: E402
import torch  # noqa: E402

import emg3d_tpu as jt  # noqa: E402

import emg3d_tpu_torch as pt  # noqa: E402
from emg3d_tpu_torch import optimize  # noqa: E402
from emg3d_tpu_torch.simulations import (  # noqa: E402
    expand_grid_model, estimate_gridding_opts)

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

CPU = {'device': 'cpu'}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)
    return float(np.max(np.abs(a[fin] - b[fin])) / np.max(np.abs(b[fin])))


# ----------------------------------------------------------------------
# Receivers
# ----------------------------------------------------------------------

def _grid_and_field(pkg, electric=True):
    rng = np.random.default_rng(7)
    h = [rng.uniform(80, 120, n) for n in (6, 7, 8)]
    grid = pkg.TensorMesh(h, origin=(0., 0., 0.))
    nx, ny, nz = grid.shape_cells
    shapes = ((grid.shape_edges_x, grid.shape_edges_y, grid.shape_edges_z)
              if electric else     # a magnetic field lives on the faces
              ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)))
    comps = [rng.standard_normal(sh) + 1j * rng.standard_normal(sh)
             for sh in shapes]
    return grid, pkg.Field(*comps, frequency=1.0)


REC = (np.array([250., 300., 420., 5000.]), np.array([260., 310., 330.,
                                                      300.]), 350.)


@pytest.mark.parametrize('extrapolate', [False, True])
@pytest.mark.parametrize('method', ['cubic', 'linear'])
def test_get_receiver_matches_jax(method, extrapolate):
    (gj, fj), (gp, fp) = _grid_and_field(jt), _grid_and_field(pt)
    for cj, cp in zip(jt.get_receiver(gj, fj, REC, method, extrapolate),
                      pt.get_receiver(gp, fp, REC, method, extrapolate)):
        assert isinstance(cp, pt.EMArray)
        assert _rel(cp, cj) < 1e-12
    # Model values at cell centres come back as a plain array.
    vals = np.arange(gj.n_cells, dtype=float).reshape(gj.shape_cells)
    assert _rel(pt.get_receiver(gp, vals, REC, method, extrapolate),
                jt.get_receiver(gj, vals, REC, method, extrapolate)) < 1e-12


@pytest.mark.parametrize('electric', [True, False])
def test_get_receiver_response_matches_jax(electric):
    (gj, fj), (gp, fp) = (_grid_and_field(jt, electric),
                          _grid_and_field(pt, electric))
    for azm, dip in ((0, 0), (90, 0), (30, 20), (0, 90)):
        rec = REC + (azm, dip)
        assert _rel(pt.get_receiver_response(gp, fp, rec),
                    jt.get_receiver_response(gj, fj, rec)) < 1e-12
    with pytest.raises(ValueError, match='x, y, z, azimuth, dip'):
        pt.get_receiver_response(gp, fp, (0, 0, 0))
    with pytest.raises(ValueError, match='Field'):
        pt.get_receiver_response(gp, fp.fx, REC + (0, 0))


@pytest.mark.parametrize('mu_r', [None, 2.5])
def test_get_h_field_matches_jax(mu_r):
    (gj, fj), (gp, fp) = _grid_and_field(jt), _grid_and_field(pt)
    rng = np.random.default_rng(2)
    mu = None if mu_r is None else rng.uniform(1, mu_r, gj.shape_cells)
    hj = jt.get_h_field(gj, jt.Model(gj, 1.0, mu_r=mu), fj)
    hp = pt.get_h_field(gp, pt.Model(gp, 1.0, mu_r=mu), fp)
    assert not hp.is_electric and hp._frequency == 1.0
    assert tp.rel((hp.fx, hp.fy, hp.fz), (hj.fx, hj.fy, hj.fz)) < 1e-12


# ----------------------------------------------------------------------
# Simulation, misfit and gradient
# ----------------------------------------------------------------------

def _sim_inputs(pkg, tol=1e-8):
    mesh = pkg.TensorMesh([np.ones(8) * 200] * 3, origin=(0, 0, 0))
    rng = np.random.default_rng(5)
    model = pkg.Model(mesh, rng.uniform(0.5, 2, mesh.shape_cells),
                      mapping='Conductivity')
    survey = pkg.Survey('s', ([500, 700], 800, 800, 0, 0),
                        ([1000, 1200], 800, 800, 0, 0), [1.0, 2.0],
                        noise_floor=1e-15, relative_error=0.05)
    opts = {'sslsolver': False, 'semicoarsening': False,
            'linerelaxation': False, 'tol': tol}
    return mesh, model, survey, opts


def _run(pkg, extra):
    """Observed data (noise seeded) on the true model, then the misfit
    and gradient of a homogeneous start model."""
    mesh, model, survey, opts = _sim_inputs(pkg)
    opts.update(extra)
    sim = pkg.Simulation('t', survey, mesh, model, gridding='same',
                         solver_opts=opts, verb=-1, max_workers=1)
    np.random.seed(3)
    sim.compute(observed=True)
    obs = np.array(sim.data.observed)
    start = pkg.Model(mesh, np.ones(mesh.shape_cells), mapping='Conductivity')
    sim2 = pkg.Simulation('t', sim.survey, mesh, start, gridding='same',
                          solver_opts=opts, verb=-1)
    return sim, obs, sim2.misfit, sim2.gradient, np.array(sim2.data.synthetic)


def test_simulation_misfit_gradient_match_jax():
    sj, *rj = _run(jt, {})
    sp, *rp = _run(pt, CPU)
    for a, b in zip(rp, rj):
        assert _rel(a, b) < 1e-8
    info = sp.get_efield_info('Tx0', 1.0)
    assert info['exit_message'] == 'CONVERGED'
    assert isinstance(info['rel_error'], float)
    # The four pairs ran as one batched solve: one shared it_mg.
    assert {sp.get_efield_info(s, f)['it_mg'] for s in sp.survey.sources
            for f in (1.0, 2.0)} == {info['it_mg']}
    h = sp.get_hfield('Tx1', 2.0)
    assert np.all(np.isfinite(h.fx))


def test_threaded_nonbatchable_solves():
    """gcrotmk pairs cannot batch: they run from host threads, and the
    responses equal a serial run (tests/test_simulations.py:49)."""
    mesh = pt.TensorMesh([np.ones(16) * 200] * 3, origin=(0, 0, 0))
    model = pt.Model(mesh, np.ones(mesh.shape_cells), mapping='Conductivity')
    survey = pt.Survey('Threads', ([850, 1250], 1600, 1600, 0, 0),
                       (2350, 1600, 1600, 0, 0), 1.0,
                       noise_floor=1e-15, relative_error=0.05)
    opts = {'sslsolver': 'gcrotmk', 'tol': 5e-5, 'semicoarsening': False,
            'linerelaxation': False, **CPU}
    out = {}
    for nw in (1, 2):
        sim = pt.Simulation('t', survey, mesh, model, gridding='same',
                            solver_opts=opts, max_workers=nw, verb=-1)
        sim.compute()
        for src in survey.sources:
            assert sim.get_efield_info(src, 1.0)['exit_message'] == \
                'CONVERGED'
        out[nw] = np.asarray(sim.data.synthetic).copy()
    np.testing.assert_allclose(out[2], out[1], rtol=1e-10)


def test_dict_roundtrip_clean_and_files(tmp_path):
    mesh, model, survey, opts = _sim_inputs(pt, tol=1e-3)
    sim = pt.Simulation('t', survey, mesh, model, gridding='same',
                        solver_opts={**opts, **CPU}, verb=-1)
    sim2 = pt.Simulation.from_dict(sim.to_dict('plain'))
    assert sim2.name == sim.name and sim2.gridding == 'same'
    assert sim2.survey.shape == sim.survey.shape
    assert sim2.solver_opts['device'] == 'cpu'
    sim.compute()
    assert sim._dict_efield['Tx0'][1.0] is not None
    copy = sim.copy()
    assert np.array_equal(copy.get_efield('Tx1', 2.0).field,
                          sim.get_efield('Tx1', 2.0).field)
    sim.clean('computed')
    assert sim._dict_efield['Tx0'][1.0] is None
    with pytest.raises(TypeError, match='Unrecognized'):
        sim.clean('nope')
    # Files (io is ported): both round-trip through npz.
    for obj in (sim, sim.survey):
        fname = str(tmp_path / f'{type(obj).__name__}.npz')
        obj.to_file(fname)
        back = type(obj).from_file(fname)
        assert isinstance(back, type(obj)) and back.name == obj.name
    assert pt.Simulation.from_file(
        str(tmp_path / 'Simulation.npz')).solver_opts == sim.solver_opts


def test_gradient_errors():
    mesh, _, survey, opts = _sim_inputs(pt)
    sim = pt.Simulation('t', survey, mesh, pt.Model(mesh, 1, 2, 3),
                        gridding='same', solver_opts=opts, verb=-1)
    with pytest.raises(NotImplementedError, match='isotropic'):
        optimize.gradient(sim)
    sim = pt.Simulation('t', survey, mesh, pt.Model(mesh, 1, epsilon_r=3),
                        gridding='same', solver_opts=opts, verb=-1)
    with pytest.raises(NotImplementedError, match='el. permittivity'):
        optimize.gradient(sim)
    survey.noise_floor = None
    survey.relative_error = None
    sim = pt.Simulation('t', survey, mesh, pt.Model(mesh, 1),
                        gridding='same', solver_opts=opts, verb=-1)
    with pytest.raises(ValueError, match='noise_floor'):
        optimize.misfit(sim)


def test_expand_grid_model_matches_jax():
    args = ([[100., 100.], [100., 100.], [100., 100.]],)
    out = []
    for pkg in (jt, pt):
        mesh = pkg.TensorMesh(*args, origin=(0, 0, 0))
        model = pkg.Model(mesh, 1.0, mapping='Conductivity')
        out.append(pkg.simulations.expand_grid_model(mesh, model,
                                                     [3.33, 1e-8], 250.0))
    (gj, mj), (gp, mp) = out
    assert gp.shape_cells[2] == 4 and gp.nodes_z[-2] == 250.0
    assert np.array_equal(gp.h[2], gj.h[2])
    assert np.array_equal(mp.property_x, mj.property_x)
    assert mp.property_x[0, 0, 3] == 1e-8
    assert expand_grid_model is pt.expand_grid_model


def test_estimate_gridding_opts_matches_jax():
    out = []
    for pkg in (jt, pt):
        mesh = pkg.TensorMesh([np.ones(8) * 500] * 3,
                              origin=(-2000, -2000, -3500))
        model = pkg.Model(mesh, np.arange(1, 8**3 + 1).reshape(
            mesh.shape_cells) / 100, mapping='Resistivity')
        survey = pkg.Survey('T', (0, 0, -1000, 0, 0),
                            ([-500, 500], 100, -1100, 0, 0), [0.5, 2.0])
        out.append(pkg.simulations.estimate_gridding_opts(
            {}, mesh, model, survey))
    gj, gp = out
    assert gp['frequency'] == gj['frequency'] == 1.0
    assert gp['mapping'] == 'Resistivity'
    np.testing.assert_allclose(gp['center'], gj['center'])
    np.testing.assert_allclose(gp['properties'], gj['properties'])
    np.testing.assert_allclose(np.asarray(gp['domain']),
                               np.asarray(gj['domain']))
    assert estimate_gridding_opts is pt.simulations.estimate_gridding_opts


def test_simulation_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    mesh, model, survey, opts = _sim_inputs(pt)
    sim = pt.Simulation('t', survey, mesh, model, gridding='same',
                        solver_opts=opts, verb=-1)
    with pytest.raises(RuntimeError, match='CUDA'):
        sim.compute()
