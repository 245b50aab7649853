"""Port vs JAX package: the host modules on the survey path.

Cases of tests/test_meshes.py, test_models.py, test_surveys.py and
test_fields.py, run through both packages in complex128/float64 on the
same inputs (numpy, from seeds): every output, nested dicts and lists
included, equal within rel ``REL`` (both packages are numpy and scipy
here, so most agree bitwise).  The functions are those the survey path
calls: ``construct_mesh``, ``grid2grid`` (cubic, as
``optimize._pair_gradient`` uses it; linear and volume) and
``interp3d``, ``edges2cellaverages`` and the maps' ``forward``,
``backward`` and ``derivative_chain``, ``Survey``'s ``select``,
standard deviation and dict round trips, and the fields' constructors,
sources and receivers.
"""
import numpy as np
import pytest

pytest.importorskip('jax')

import emg3d_tpu as jt  # noqa: E402

import emg3d_tpu_torch as pt  # noqa: E402

REL = 1e-12


def _same(a, b, path='out'):
    """Recursively: equal structure, strings and flags; numbers within
    rel ``REL`` of the largest magnitude."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), path
        for k in b:
            _same(a[k], b[k], f'{path}[{k!r}]')
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f'{path}[{i}]')
    elif b is None or isinstance(b, (str, bool)):
        assert a == b, (path, a, b)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.dtype,
                                                           b.dtype)
        fin = np.isfinite(b)
        assert np.array_equal(np.isfinite(a), fin), path
        if fin.any():
            scale = max(float(np.max(np.abs(b[fin]))), 1e-300)
            assert np.max(np.abs(a[fin] - b[fin])) <= REL * scale, path


# ----------------------------------------------------------------------
# Meshes (tests/test_meshes.py)
# ----------------------------------------------------------------------

MESHES = {
    'basic': dict(frequency=1.0, properties=1.0, center=(0, 0, 0),
                  domain=([-800, 800], [-800, 800], [-800, 800])),
    'per_direction': dict(
        frequency=0.5, properties=[3.3, 1e5, 1e5, 1e5, 1e5, 1.0, 1e5],
        center=(0, 0, -600),
        domain=([-1000, 1000], [-1000, 1000], [-1200, 0])),
    'vector': dict(frequency=1.0, properties=1.0, center=(0, 0, 0),
                   vector=(np.arange(-400., 401., 100.),) * 3),
    'stretching': dict(frequency=2.0, properties=[1.0, 100.0],
                       center=(0, 0, -500),
                       domain=([-300, 300], [-300, 300], [-900, -100])),
    'seasurface': dict(frequency=0.2, properties=[0.3, 1, 50],
                       center=(0, 0, -950), seasurface=0.0,
                       domain=([-2000, 2000], [-2000, 2000], [-2000, -1000])),
}


@pytest.mark.parametrize('case', list(MESHES))
def test_construct_mesh(case):
    out = []
    for pkg in (jt, pt):
        g = pkg.construct_mesh(**MESHES[case])
        out.append((list(g.h), g.origin, g.shape_cells,
                    g.cell_volumes, g.to_dict()))
    _same(out[1], out[0])


def test_mesh_helpers():
    _same(pt.good_mg_cell_nr(max_nr=1024, max_prime=5, min_div=3),
          jt.good_mg_cell_nr(max_nr=1024, max_prime=5, min_div=3))
    for f in (0.5, 1.0, -2.0):
        _same(pt.skin_depth(f, 3.3, 1.5), jt.skin_depth(f, 3.3, 1.5))


# ----------------------------------------------------------------------
# Maps and models (tests/test_models.py)
# ----------------------------------------------------------------------

def _grids(pkg):
    rng = np.random.default_rng(4)
    grid = pkg.TensorMesh([rng.uniform(80, 120, n) for n in (5, 6, 7)],
                          origin=(-300., -250., -400.))
    # Linear and cubic grid2grid map values between grids of the same
    # counts (cells or nodes along each axis).
    new = pkg.TensorMesh([rng.uniform(70, 130, n) for n in (5, 6, 7)],
                         origin=(-350., -200., -420.))
    return grid, new


@pytest.mark.parametrize('extrapolate', [True, False])
@pytest.mark.parametrize('method', ['cubic', 'linear', 'volume'])
def test_grid2grid(method, extrapolate):
    out = []
    for pkg in (jt, pt):
        grid, new = _grids(pkg)
        rng = np.random.default_rng(5)
        vals = rng.uniform(0.5, 3, grid.shape_cells)
        res = [pkg.grid2grid(grid, vals, new, method, extrapolate)]
        if method != 'volume':
            comps = [rng.standard_normal(s) + 1j * rng.standard_normal(s)
                     for s in (grid.shape_edges_x, grid.shape_edges_y,
                               grid.shape_edges_z)]
            f = pkg.grid2grid(grid, pkg.Field(*comps, frequency=1.0), new,
                              method, extrapolate)
            res.append((f.fx, f.fy, f.fz))
        out.append(res)
    _same(out[1], out[0])


@pytest.mark.parametrize('method', ['cubic', 'linear', 'nearest'])
def test_interp3d(method):
    out = []
    for pkg in (jt, pt):
        grid, new = _grids(pkg)
        rng = np.random.default_rng(6)
        vals = rng.uniform(0.5, 3, grid.shape_cells)
        pts = (grid.cell_centers_x, grid.cell_centers_y,
               grid.cell_centers_z)
        xi = np.stack(np.broadcast_arrays(
            *np.meshgrid(new.cell_centers_x, new.cell_centers_y,
                         new.cell_centers_z, indexing='ij')), axis=-1)
        out.append([pkg.maps.interp3d(pts, vals, xi, method, fill_value=fv)
                    for fv in (0.0, None)])
    _same(out[1], out[0])


def test_edges2cellaverages_and_volume_average():
    out = []
    for pkg in (jt, pt):
        grid, new = _grids(pkg)
        rng = np.random.default_rng(7)
        e = [rng.standard_normal(s) for s in (
            grid.shape_edges_x, grid.shape_edges_y, grid.shape_edges_z)]
        vals = rng.uniform(1, 10, grid.shape_cells)
        va = pkg.maps.volume_average(
            (grid.nodes_x, grid.nodes_y, grid.nodes_z), vals,
            (new.nodes_x, new.nodes_y, new.nodes_z), new.cell_volumes)
        out.append([pkg.maps.edges2cellaverages(*e, grid.cell_volumes), va])
    _same(out[1], out[0])


@pytest.mark.parametrize('name', list(jt.maps.MAPLIST))
def test_maps(name):
    out = []
    sigma = np.array([0.01, 0.5, 1.0, 3.3, 100.0])
    for pkg in (jt, pt):
        m = pkg.maps.MAPLIST[name]()
        x = m.forward(sigma)
        grad = np.linspace(1., 2., sigma.size)
        m.derivative_chain(grad, x)
        out.append([x, m.backward(x), grad, m.to_dict()])
    _same(out[1], out[0])


@pytest.mark.parametrize('mapping', ['Conductivity', 'LgResistivity'])
def test_model_and_volume_model(mapping):
    out = []
    for pkg in (jt, pt):
        grid, new = _grids(pkg)
        rng = np.random.default_rng(8)
        props = [rng.uniform(0.5, 3, grid.shape_cells) for _ in range(3)]
        if mapping == 'LgResistivity':
            props = [np.log10(p) for p in props]
        m = pkg.Model(grid, *props, mu_r=rng.uniform(1, 2, grid.shape_cells),
                      mapping=mapping)
        vm = pkg.VolumeModel(grid, m, pkg.SourceField.zeros(grid, 0.7))
        m2 = m.interpolate2grid(grid, new)
        out.append([m.to_dict(), vm.eta_x, vm.eta_y, vm.eta_z, vm.zeta,
                    m2.property_x, m2.property_z, (m + m).property_y])
    _same(out[1], out[0])


# ----------------------------------------------------------------------
# Surveys (tests/test_surveys.py)
# ----------------------------------------------------------------------

def _survey(pkg):
    srv = pkg.Survey('T', (0, [0, 100, 200], -950, 0, 0),
                     ([1000, 2000], 0, -1000, [0, 30], [0, 10]),
                     [1.0, 2.0, 4.0], noise_floor=1e-15, relative_error=0.05)
    rng = np.random.default_rng(9)
    srv.data.observed[:] = (rng.standard_normal(srv.shape)
                            + 1j * rng.standard_normal(srv.shape))
    return srv


def _survey_record(srv):
    return [srv.shape, list(srv.sources), list(srv.receivers),
            srv.frequencies, srv.src_coords, srv.rec_coords, srv.rec_types,
            srv.data.observed, srv.standard_deviation, srv.to_dict()]


@pytest.mark.parametrize('case', ['plain', 'select', 'std', 'roundtrip',
                                  'fixed'])
def test_survey(case):
    out = []
    for pkg in (jt, pt):
        srv = _survey(pkg)
        if case == 'select':
            srv = srv.select(sources=['Tx0', 'Tx2'], frequencies=[2.0])
        elif case == 'std':
            srv.standard_deviation = np.full(srv.shape, 0.5)
            srv.noise_floor = 1e-3
            srv.relative_error = np.full((1, 2, 1), 0.1)
        elif case == 'roundtrip':
            srv = pkg.Survey.from_dict(srv.to_dict()).copy()
        elif case == 'fixed':
            srv = pkg.Survey('Fix', (0, [0, 1000], 0, 0, 0),
                             ([100, 1100, 200, 1200], 0, 0, 0, 0), 1.0,
                             fixed=1)
        out.append(_survey_record(srv))
    _same(out[1], out[0])


# ----------------------------------------------------------------------
# Fields (tests/test_fields.py)
# ----------------------------------------------------------------------

SOURCES = {
    'point': ([310, 310, 310, 30, 40], {}),
    'finite': ([250, 350, 300, 310, 280, 330], {}),
    'strength': ([310, 310, 310, 0, 0], {'strength': 2.5}),
    'loop': ([300, 300, 300, 20, 70], {'electric': False}),
    'polyline': (([150, 450, 450, 150], [150, 150, 450, 450],
                  [300, 300, 300, 350]), {'strength': 3.0}),
    'laplace': ([310, 310, 310, 30, 40], {'freq': -2.0}),
}


@pytest.mark.parametrize('case', list(SOURCES))
def test_source_field(case):
    src, kw = SOURCES[case]
    kw = dict(kw)
    freq = kw.pop('freq', 1.0)
    out = []
    for pkg in (jt, pt):
        grid = pkg.TensorMesh([np.full(6, 100.)] * 3, origin=(0, 0, 0))
        sf = pkg.get_source_field(grid, src, freq, **kw)
        out.append([sf.fx, sf.fy, sf.fz, sf.field, sf.vector, sf.moment,
                    sf.smu0])
    _same(out[1], out[0])


def test_field_layout_and_receivers():
    out = []
    for pkg in (jt, pt):
        grid = pkg.TensorMesh([np.full(6, 100.)] * 3, origin=(0, 0, 0))
        rng = np.random.default_rng(10)
        flat = rng.normal(size=grid.n_edges) + 1j * rng.normal(
            size=grid.n_edges)
        f = pkg.Field.from_flat(grid, flat, frequency=2.0)
        g = f.ensure_pec()
        rec = (np.array([150., 260., 420.]), np.array([210., 330., 90.]),
               300., [0, 30, 90], [0, 20, 45])
        out.append([f.fx, f.fy, f.fz, g.fx, g.fy, g.fz, f.sval, f.smu0,
                    f.amp(), f.pha(deg=True),
                    pkg.get_receiver_response(grid, f, rec),
                    pkg.Field.zeros(grid, frequency=-3.0).fx])
    _same(out[1], out[0])
