"""Sources held by the edges they touch, and placed on the device from them.

``get_source_field`` returns a :class:`SourceField` that keeps, per
component, the flat indices of its nonzero edges and their values
(``record``).  On the CPU, against the JAX package and the dense path:

- every source format, strength 0 and not, frequency and Laplace domain:
  the dense arrays built on access equal the JAX package's byte for byte
  (signed zeros included), ``norm()`` is the JAX package's, the record's
  own norm is within 1e-15, and the solver's placement of the record
  equals the upload of the dense arrays byte for byte; the same where the
  scatter sums past 1 ± 1e-6 and is renormalized;
- a single solve and a 3-lane ``solve_batched`` of recorded sources
  against the same sources made dense: the same exit, ``it_mg``,
  ``it_ssl`` (and the single solve's field to the bit);
- a source whose dense arrays were handed out and written into is solved
  as written (the record is gone);
- under a profiler, ``source.compact`` counts the lanes placed from
  records and ``copy.h2d_bytes`` counts only the records' bytes;
- ``Simulation.compute()`` leaves every source it built without dense
  arrays.
"""
import types

import pytest

pytest.importorskip('jax')

import numpy as np  # noqa: E402
import torch  # noqa: E402

import emg3d_tpu as jt  # noqa: E402

import emg3d_tpu_torch as pt  # noqa: E402
from emg3d_tpu_torch import convert, dtypes, solver, trace  # noqa: E402

torch.set_num_threads(1)

FORMATS = {
    'finite': ((-120., 130., -10., 15., -5., 25.), True),
    'point': ((10., -20., 5., 30., 60.), True),
    'loop': ((10., -20., 5., 30., 60.), False),
    'polyline': ([[-100., 50., 120.], [-30., 40., 10.], [0., 20., -40.]],
                 True),
}


def _grids():
    grid_j = jt.TensorMesh([np.full(8, 80.), np.full(6, 90.),
                            np.full(7, 70.)], origin=(-320, -270, -245))
    return grid_j, convert.mesh_to_torch(grid_j)


def _bytes_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _tensor_bytes_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and \
        bytes(a.contiguous().view(torch.uint8).reshape(-1).numpy()) == \
        bytes(b.contiguous().view(torch.uint8).reshape(-1).numpy())


def _check_placement(sp):
    """The record placed on the CPU equals the dense arrays uploaded,
    in the source's solve precision and in complex64."""
    rec = sp.record
    dense = list(pt.fields._record_arrays(sp.shape, rec))
    for dtype in (dtypes.precision(sp.dtype)[1], torch.complex64):
        placed = solver._place([rec], sp.shape, dtype, 'cpu')
        for t, d in zip(placed, dense):
            assert t.shape == (1,) + d.shape
            assert _tensor_bytes_equal(
                t[0], torch.tensor(d, dtype=dtype))


@pytest.mark.parametrize('freq', [1.5, -2.0])
@pytest.mark.parametrize('strength', [0, 2.5])
@pytest.mark.parametrize('fmt', list(FORMATS))
def test_record_matches_dense(fmt, strength, freq):
    src, electric = FORMATS[fmt]
    grid_j, grid_p = _grids()
    sj = jt.get_source_field(grid_j, src, freq, strength=strength,
                             electric=electric)
    sp = pt.get_source_field(grid_p, src, freq, strength=strength,
                             electric=electric)
    assert sp.record is not None
    assert sp.dtype == np.asarray(sj.fx).dtype
    assert sp.shape == tuple(np.asarray(c).shape
                             for c in (sj.fx, sj.fy, sj.fz))
    norm = float(sp.norm())
    assert norm == float(sj.norm())
    assert abs(sp._record_norm() - norm) <= 1e-15 * norm
    _check_placement(sp)
    assert sp.record is not None            # nothing above kept arrays
    for a, b in zip((sj.fx, sj.fy, sj.fz), (sp.fx, sp.fy, sp.fz)):
        assert _bytes_equal(a, b)
    assert sp.record is None                # handed out: record dropped
    np.testing.assert_array_equal(sj.moment, sp.moment)
    assert float(sp.norm()) == norm


def test_renormalizing_source():
    """Widths far below the node spacing put the trilinear weights'
    rounding past 1e-6: both packages renormalize (and warn), and the
    record still defines the JAX package's arrays to the byte."""
    grid_j, _ = _grids()
    fake = types.SimpleNamespace(
        nodes_x=grid_j.nodes_x, nodes_y=grid_j.nodes_y,
        nodes_z=grid_j.nodes_z, h=[np.asarray(h) * 3e-6 for h in grid_j.h],
        shape_edges_x=grid_j.shape_edges_x,
        shape_edges_y=grid_j.shape_edges_y,
        shape_edges_z=grid_j.shape_edges_z)
    src = FORMATS['finite'][0]
    with pytest.warns(UserWarning, match='Normalizing Source'):
        sj = jt.get_source_field(fake, src, 1.5)
    with pytest.warns(UserWarning, match='Normalizing Source'):
        sp = pt.get_source_field(fake, src, 1.5)
    norm = float(sp.norm())
    assert norm == float(sj.norm())
    assert abs(sp._record_norm() - norm) <= 1e-15 * norm
    _check_placement(sp)
    for a, b in zip((sj.fx, sj.fy, sj.fz), (sp.fx, sp.fy, sp.fz)):
        assert _bytes_equal(a, b)


# ----------------------------------------------------------------------
# Solves of recorded sources
# ----------------------------------------------------------------------

N = 8
XS = (-100., 0., 100.)


def _problem():
    grid = pt.TensorMesh([np.full(N, 100.)] * 3, origin=(-400.,) * 3)
    model = pt.Model(grid, property_x=1.0, property_y=2.0, property_z=3.0)
    return grid, model


def _source(grid, x, freq=1.0):
    return pt.get_source_field(grid, (x, 20., -30., 20., 10.), freq)


def _dense(sf):
    """The same source made from arrays (no record)."""
    d = pt.SourceField(*(np.array(c) for c in pt.fields._record_arrays(
        sf.shape, sf.record)), frequency=sf._frequency)
    assert d.record is None
    return d


def _traced(fn):
    """``fn()`` under a profiler: (its result, the counters it added)."""
    trace.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    counts = trace.counts()
    trace.reset()
    return out, counts


@pytest.mark.parametrize('opts', [{}, {'semicoarsening': True,
                                       'linerelaxation': True}],
                         ids=['point', 'sclr'])
def test_single_solve(opts):
    grid, model = _problem()
    sf = _source(grid, 30.)
    dense = _dense(sf)

    def run(s):
        return pt.solve(grid, model, s, verb=0, device='cpu',
                        return_info=True, **opts)
    (e0, i0), c0 = _traced(lambda: run(dense))
    (e1, i1), c1 = _traced(lambda: run(sf))
    assert sf.record is not None
    for key in ('exit_message', 'it_mg', 'it_ssl'):
        assert i0[key] == i1[key]
    assert i1['exit_message'] == 'CONVERGED'
    assert i0['ref_error'] == i1['ref_error']
    for a, b in zip((e0.fx, e0.fy, e0.fz), (e1.fx, e1.fy, e1.fz)):
        assert _bytes_equal(a, b)
    assert c0['source.dense'] == 1 and 'source.compact' not in c0
    assert c1['source.compact'] == 1 and 'source.dense' not in c1
    # Only the record's indices and values cross, not the dense arrays.
    rec = sum(i.nbytes + v.nbytes for i, v, _ in sf.record)
    whole = sum(np.asarray(c).nbytes for c in (dense.fx, dense.fy,
                                               dense.fz))
    assert c0['copy.h2d_bytes'] - c1['copy.h2d_bytes'] == whole - rec


def test_batched_solve():
    """Three lanes, two frequencies, under BiCGSTAB (the survey's
    batched solve)."""
    grid, model = _problem()
    sfs = [_source(grid, x, f) for x, f in zip(XS, (1.0, 2.0, 1.0))]
    dense = [_dense(sf) for sf in sfs]

    def run(s):
        return pt.solve_batched(grid, model, s, verb=0, device='cpu',
                                sslsolver='bicgstab')
    (e0, i0), c0 = _traced(lambda: run(dense))
    (e1, i1), c1 = _traced(lambda: run(sfs))
    assert all(sf.record is not None for sf in sfs)
    for key in ('exit_message', 'it_mg', 'it_ssl'):
        assert i0[key] == i1[key]
    assert i1['exit_message'] == 'CONVERGED'
    np.testing.assert_allclose(i1['ref_error'], i0['ref_error'],
                               rtol=1e-15, atol=0)
    for f0, f1 in zip(e0, e1):
        for a, b in zip((f0.fx, f0.fy, f0.fz), (f1.fx, f1.fy, f1.fz)):
            np.testing.assert_allclose(b, a, rtol=1e-12,
                                       atol=1e-12 * np.abs(a).max())
    assert c0['source.dense'] == 3 and 'source.compact' not in c0
    assert c1['source.compact'] == 3 and 'source.dense' not in c1
    rec = sum(i.nbytes + v.nbytes for sf in sfs for i, v, _ in sf.record)
    whole = 3 * sum(np.asarray(c).nbytes for c in (dense[0].fx,
                                                   dense[0].fy, dense[0].fz))
    assert c0['copy.h2d_bytes'] - c1['copy.h2d_bytes'] == whole - rec


def test_written_source_is_solved_as_written():
    """Once its arrays are handed out the record is gone: a write into
    them is what the solve sees."""
    grid, model = _problem()
    sf = _source(grid, 30.)
    sf.fx[...] *= 2
    assert sf.record is None
    doubled = _source(grid, 30.)
    want = pt.SourceField(np.array(doubled.fx) * 2, np.array(doubled.fy),
                          np.array(doubled.fz), frequency=1.0)
    (e0, i0), c0 = _traced(lambda: pt.solve(
        grid, model, sf, verb=0, device='cpu', return_info=True))
    e1, i1 = pt.solve(grid, model, want, verb=0, device='cpu',
                      return_info=True)
    assert c0['source.dense'] == 1 and 'source.compact' not in c0
    assert i0['ref_error'] == i1['ref_error'] == float(want.norm())
    for a, b in zip((e0.fx, e0.fy, e0.fz), (e1.fx, e1.fy, e1.fz)):
        assert _bytes_equal(a, b)


@pytest.mark.parametrize('ssl', ['bicgstab', 'gcrotmk'],
                         ids=['batched', 'single'])
def test_simulation_keeps_records(ssl):
    """``compute()`` solves every pair (batched, or one by one where the
    Krylov solver has no batched form) without building a source's
    dense arrays."""
    grid, model = _problem()
    survey = pt.Survey('s', ([-100, 100], 0, 0, 0, 0),
                       ([150, 200], 0, 0, 0, 0), 1.0,
                       noise_floor=1e-15, relative_error=0.05)
    sim = pt.Simulation('t', survey, grid, model, gridding='same', verb=-1,
                        max_workers=1,
                        solver_opts={'sslsolver': ssl, 'device': 'cpu'})
    _, counts = _traced(sim.compute)
    sfields = [f for d in sim._dict_sfield.values() for f in d.values()]
    assert len(sfields) == 2
    assert all(sf.record is not None for sf in sfields)
    assert counts['source.compact'] == 2 and 'source.dense' not in counts
    assert np.isfinite(sim.data.synthetic).all()
