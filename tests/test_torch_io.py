"""Port vs JAX package: files (``emg3d_tpu_torch.io``).

- Round trips of every known class in npz, json and (with h5py) h5, as
  tests/test_io.py.
- A file saved by ``emg3d_tpu.io`` loads in ``emg3d_tpu_torch.io`` and
  the reverse, with equal meshes, models, fields and survey data.
- ``Survey`` and ``Simulation`` ``to_file``/``from_file``.
"""
import pytest

pytest.importorskip('jax')

import numpy as np  # noqa: E402
import torch  # noqa: E402

import emg3d_tpu as jt  # noqa: E402

import emg3d_tpu_torch as pt  # noqa: E402
from emg3d_tpu_torch import io  # noqa: E402

try:
    import h5py
except ImportError:
    h5py = None

torch.set_num_threads(1)

EXTS = ['npz', 'json'] + (['h5'] if h5py is not None else [])


def _objs(pkg):
    """tests/test_io.py's objects, in either package."""
    rng = np.random.default_rng(4)
    grid = pkg.TensorMesh([rng.uniform(10, 20, 4), rng.uniform(10, 20, 4),
                           rng.uniform(10, 20, 4)], origin=(1, 2, 3))
    model = pkg.Model(grid, property_x=rng.uniform(1, 10, grid.shape_cells),
                      property_z=rng.uniform(1, 10, grid.shape_cells),
                      mu_r=1.5, mapping='Resistivity')
    sfield = pkg.get_source_field(grid, [20, 40, 30, 30, 30, 30], 0.8)
    survey = pkg.Survey('io-test', (25, 25, 25, 0, 0),
                        ([30, 40], 30, 30, 0, 0), [0.8, 1.2],
                        relative_error=0.05)
    survey.data.observed[:] = rng.normal(size=survey.shape) + \
        1j * rng.normal(size=survey.shape)
    return grid, model, sfield, survey


def _check(out, objs, pkg):
    grid, model, sfield, survey = objs
    assert isinstance(out['mesh'], pkg.TensorMesh)
    assert isinstance(out['model'], pkg.Model)
    assert isinstance(out['survey'], pkg.Survey)
    assert isinstance(out['sfield'], (pkg.SourceField, pkg.Field))
    for a, b in zip(out['mesh'].h, grid.h):
        assert np.array_equal(a, b)
    assert np.array_equal(out['mesh'].origin, grid.origin)
    for name in ('property_x', 'property_y', 'property_z', 'mu_r'):
        a, b = getattr(out['model'], name), getattr(model, name)
        assert (a is None and b is None) or np.array_equal(a, b), name
    assert out['model'].map.name == model.map.name
    assert np.array_equal(out['sfield'].field, sfield.field)
    assert out['sfield']._frequency == 0.8
    assert out['survey'].name == 'io-test'
    assert np.array_equal(out['survey'].frequencies, survey.frequencies)
    assert np.array_equal(out['survey'].data.observed,
                          survey.data.observed)
    assert np.array_equal(out['survey'].standard_deviation,
                          survey.standard_deviation)


def _save(mod, fname, objs):
    grid, model, sfield, survey = objs
    mod.save(fname, mesh=grid, model=model, sfield=sfield, survey=survey,
             arr=np.arange(5.), scalar=3.14, string='hello', none=None)


@pytest.mark.parametrize('ext', EXTS)
def test_roundtrip(tmp_path, ext):
    objs = _objs(pt)
    fname = str(tmp_path / f'data.{ext}')
    _save(io, fname, objs)
    out = io.load(fname)
    assert out['mesh'] == objs[0]
    assert out['model'] == objs[1]
    _check(out, objs, pt)
    np.testing.assert_allclose(out['arr'], np.arange(5.))
    assert float(out['scalar']) == 3.14
    assert str(out['string']) == 'hello'
    assert out['none'] is None
    assert '_date' in out
    assert str(out['_version']).startswith('emg3d_tpu_torch v')


@pytest.mark.parametrize('ext', EXTS)
@pytest.mark.parametrize('writer', ['jax', 'torch'])
def test_files_cross_packages(tmp_path, writer, ext):
    """A file of one package loads in the other with equal objects."""
    src, dst = (jt, pt) if writer == 'jax' else (pt, jt)
    objs = _objs(src)
    fname = str(tmp_path / f'data.{ext}')
    _save(src.io, fname, objs)
    _check(dst.io.load(fname), objs, dst)


def test_survey_to_file(tmp_path):
    *_, survey = _objs(pt)
    for ext in ('npz', 'json'):
        fname = str(tmp_path / f'survey.{ext}')
        survey.to_file(fname)
        s2 = pt.Survey.from_file(fname)
        assert s2.name == survey.name
        assert np.array_equal(s2.data.observed, survey.data.observed)
        # And in the JAX package.
        s3 = jt.Survey.from_file(fname)
        assert np.array_equal(s3.data.observed, survey.data.observed)


def test_simulation_to_file(tmp_path):
    """A computed Simulation round-trips through npz with equal data,
    fields and solver options."""
    grid = pt.TensorMesh([np.full(4, 400.)] * 3, origin=(-800.,) * 3)
    survey = pt.Survey('s', (0., 0., 0., 0., 0.), (200., 0., 0., 0., 0.),
                       1.0, noise_floor=1e-15, relative_error=0.05)
    sim = pt.Simulation('s', survey, grid, pt.Model(grid, 1.0),
                        gridding='same', solver_opts={'device': 'cpu',
                                                      'verb': 0})
    sim.compute()
    fname = str(tmp_path / 'sim.npz')
    sim.to_file(fname)
    s2 = pt.Simulation.from_file(fname)
    assert s2.solver_opts == sim.solver_opts
    assert np.array_equal(s2.data.synthetic, sim.data.synthetic)
    src = next(iter(survey.sources))
    assert np.array_equal(s2.get_efield(src, 1.0).field,
                          sim.get_efield(src, 1.0).field)


def test_unknown_extension(tmp_path):
    grid, *_ = _objs(pt)
    fname = str(tmp_path / 'data.xyz')
    if h5py is None:
        with pytest.raises(ImportError):
            io.save(fname, mesh=grid)
    else:
        io.save(fname, mesh=grid)
        assert io.load(fname + '.h5')['mesh'] == grid
    with pytest.raises(TypeError, match='Unexpected'):
        io.load(fname + '.h5', bogus=1)


@pytest.mark.parametrize('ext', ['npz', 'json'])
def test_ragged_list_raises(tmp_path, ext):
    """A list of arrays with equal leading and unequal trailing shapes is
    refused by both packages (neither writes it as ``#i`` groups)."""
    value = {'a': [np.zeros((2, 3)), np.zeros((2, 4))]}
    for pkg in (jt, pt):
        with pytest.raises(ValueError):
            pkg.io.save(str(tmp_path / f'ragged.{ext}'), data=value)
