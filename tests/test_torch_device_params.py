"""η and ζ derived on the device (``models.DeviceVolumeModel``) against
the host's ``models.VolumeModel``, on the CPU.

Every map, the four anisotropy cases, with and without μr and εr, in the
frequency and the Laplace domain, rounded to complex128 and to complex64
(the x64-off solve's dtype) as ``solver.build_levels`` rounds the host's
arrays: bitwise for the linear maps, whose backward is one IEEE
operation, within rel 1e-15 for the log maps (``torch.pow``,
``torch.exp`` against numpy's); η_y and η_z are η_x where the host's
are.  The solves that take this path are held to the JAX package in
tests/test_torch_solver.py and test_torch_solver_sclr.py.
"""
import itertools

import numpy as np
import pytest
import torch

import emg3d_tpu_torch as pt
from emg3d_tpu_torch import dtypes, models, solver

SHAPE = (6, 5, 4)
MAPS = ('Conductivity', 'Resistivity', 'LgConductivity', 'LgResistivity',
        'LnConductivity', 'LnResistivity')
DTYPES = {'complex128': torch.complex128, 'complex64': torch.complex64}


def _grid():
    rng = np.random.default_rng(5)
    h = [rng.uniform(20., 200., n) for n in SHAPE]
    return pt.TensorMesh(h, origin=(-300., -250., -100.))


def _model(grid, mapping, case, mu_r, epsilon_r, seed):
    rng = np.random.default_rng(seed)
    shape = tuple(grid.shape_cells)

    def prop():
        if mapping.startswith('L'):
            return rng.uniform(-1.5, 1.5, shape)
        return rng.uniform(0.2, 20., shape)
    kw = {'property_x': prop()}
    if case in (1, 3):
        kw['property_y'] = prop()
    if case in (2, 3):
        kw['property_z'] = prop()
    if mu_r:
        kw['mu_r'] = rng.uniform(1., 3., shape)
    if epsilon_r:
        kw['epsilon_r'] = rng.uniform(1., 80., shape)
    return pt.Model(grid, mapping=mapping, **kw)


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('mapping', MAPS)
def test_device_params_match_host(mapping, dtype):
    grid = _grid()
    cdt = DTYPES[dtype]
    tol = 0 if mapping in ('Conductivity', 'Resistivity') else 1e-15
    combos = itertools.product(range(4), (False, True), (False, True),
                               (1.25, -3.0))
    for seed, (case, mu_r, eps, freq) in enumerate(combos):
        model = _model(grid, mapping, case, mu_r, eps, seed)
        sfield = pt.SourceField.zeros(grid, frequency=freq)
        host = models.VolumeModel(grid, model, sfield)
        dev = models.DeviceVolumeModel(grid, model, sfield, 'cpu', cdt)
        where = (mapping, case, mu_r, eps, freq, dtype)
        for name in ('eta_x', 'eta_y', 'eta_z', 'zeta'):
            got = getattr(dev, name)
            want = torch.tensor(np.asarray(getattr(host, name)),
                                dtype=got.dtype)
            assert got.dtype == (cdt if name != 'zeta'
                                 else dtypes.REAL_OF[cdt]), where
            assert got.shape == SHAPE and got.is_contiguous(), where
            if tol == 0:
                assert torch.equal(got, want), (name, where)
            else:
                assert torch.all((got - want).abs() <= tol * want.abs()), \
                    (name, where)
        for name in ('eta_y', 'eta_z'):
            assert (getattr(dev, name) is dev.eta_x) == \
                (getattr(host, name) is host.eta_x), (name, where)
        if freq < 0:     # Laplace domain: a real η promoted to complex
            assert not torch.any(dev.eta_x.imag), where


@pytest.mark.parametrize('case', range(4))
def test_levels_take_device_params(case):
    """``build_levels`` takes the device η/ζ as they are, and its levels
    equal those built from the host's arrays; a hierarchy given the
    finest arrays of another shares them and computes the same coarse
    levels."""
    grid = pt.TensorMesh([np.full(8, 50.)] * 3, origin=(-200.,) * 3)
    model = _model(grid, 'Resistivity', case, True, False, 7)
    sfield = pt.SourceField.zeros(grid, frequency=0.5)
    host = models.VolumeModel(grid, model, sfield)
    dev = models.DeviceVolumeModel(grid, model, sfield, 'cpu')
    want = solver.build_levels(grid, host, 0, 3, 'cpu', {'bytes': 0})
    got = solver.build_levels(grid, dev, 0, 3, 'cpu', {'bytes': 0})
    assert all(a is b for a, b in zip(
        got[0].arrays, (dev.eta_x, dev.eta_y, dev.eta_z, dev.zeta)))
    shared = solver.build_levels(grid, None, 3, 3, 'cpu', {'bytes': 0},
                                 fine=got[0].arrays)
    assert shared[0].arrays is got[0].arrays
    apart = solver.build_levels(grid, host, 3, 3, 'cpu', {'bytes': 0})
    for a, b in ((got, want), (shared, apart)):
        assert len(a) == len(b)
        for la, lb in zip(a, b):
            assert la.shape == lb.shape
            for x, y in zip(la.arrays, lb.arrays):
                assert torch.equal(x, y)
            assert (la.arrays[1] is la.arrays[0]) == \
                (lb.arrays[1] is lb.arrays[0])
