"""The marine survey cell's own pieces: the layered model's reader, the
receiver reference, a fault only a survey can have, and the readers of
its two per-layer metrics."""
import importlib
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gpubench import harness, marine, problem
from gpubench.reference import receivers

ROOT = Path(__file__).resolve().parents[2]
CELL = 'marine_cw06.compute'
CONFIG = json.loads((ROOT / 'gpubench' / 'configs'
                     / 'marine_cw06.json').read_text())
MODEL = CONFIG['model']


def _centres(h, origin):
    return [o + np.cumsum(w) - w / 2 for w, o in zip(h, origin)]


def test_grid_shape_and_interfaces_on_nodes():
    h, origin = marine.widths(CONFIG)
    assert tuple(len(w) for w in h) == (128, 64, 96)
    x, y, z = problem.nodes(h, origin)
    for top, bottom, _ in MODEL['layers'][:-1]:
        for depth in (top, bottom):
            assert np.min(np.abs(z - depth)) < 1e-6, depth
    # The core: 200 m in x and y over the survey, 50 m in z over
    # [-3200, 0] m; the padding grows 1.25x (1.3x in the air).
    assert np.allclose(h[0][16:112], 200.0) and np.isclose(x[16], -9600.0)
    assert np.allclose(h[1][16:48], 200.0) and np.isclose(y[16], -3200.0)
    assert np.allclose(h[2][16:80], 50.0) and np.isclose(z[16], -3200.0)
    assert np.isclose(z[80], 0.0)
    assert np.allclose(h[0][113:] / h[0][112:-1], 1.25)
    assert np.allclose(h[2][81:] / h[2][80:-1], 1.3)
    assert np.allclose(h[2][:15] / h[2][1:16], 1.25)


@pytest.mark.parametrize('rehearse', [False, True])
def test_layers_resistivity(rehearse):
    h, origin = marine.widths(CONFIG, rehearse)
    rho = marine.resistivity(MODEL, h, origin)
    assert rho[0].shape == tuple(len(w) for w in h)
    assert all(np.array_equal(rho[0], r) for r in rho)
    zc = _centres(h, origin)[2]
    col = rho[0][3, 2]
    assert np.all(rho[0] == col[None, None, :])
    want = np.where(zc >= 0, 1e8, np.where(
        zc >= -1000, 0.3, np.where(zc >= -2000, 1.0, np.where(
            zc >= -2100, 100.0, 1.0))))
    assert np.array_equal(col, want)
    # Every layer, and the air, in at least one cell.
    assert set(col.tolist()) == {1e8, 0.3, 1.0, 100.0}
    if not rehearse:
        assert np.sum(col == 100.0) == 2 and np.sum(col == 0.3) == 20


def test_survey_geometry():
    srcs, recs, freqs = marine.survey(CONFIG, (30.0, -40.0))
    assert len(srcs) == 8 and len(recs) == 37 and freqs == [0.25, 0.5, 1.0]
    assert [s[0] for s in srcs] == [-3470.0 + 1000 * i for i in range(8)]
    assert {tuple(s[1:]) for s in srcs} == {(-40.0, -950.0, 0.0, 0.0)}
    assert [r[0] for r in recs] == [-9000.0 + 500 * i for i in range(37)]
    assert {tuple(r[1:]) for r in recs} == {(0.0, -1000.0, 0.0, 0.0)}


def _grid(n=(7, 6, 5), seed=3):
    rng = np.random.default_rng(seed)
    h = [rng.uniform(50, 150, k) for k in n]
    origin = (-300.0, -200.0, -250.0)
    nodes = problem.nodes(h, origin)
    centres = [(a[:-1] + a[1:]) / 2 for a in nodes]
    return nodes, centres


def _linear_field(nodes, centres, coef):
    """Each component a + b·x + c·y + d·z on its own staggered points."""
    out = []
    for comp in range(3):
        axes = [(centres if ax == comp else nodes)[ax] for ax in range(3)]
        X, Y, Z = np.meshgrid(*axes, indexing='ij')
        a, b, c, d = coef[comp]
        out.append((a + b * X + c * Y + d * Z) * (1 + 0.5j))
    return out


def test_receiver_reference_hand_computed_cases():
    """A spline through the points: at a component's own point it reads
    the stored value, a constant field reads the constant anywhere
    inside, and a field linear along x reads exactly in the middle of a
    long axis (the spline's end conditions die out within ~20 points)."""
    nodes, centres = _grid()
    rng = np.random.default_rng(5)
    field = [rng.standard_normal((len(a) - (ax == 0), len(b) - (ax == 1),
                                  len(c) - (ax == 2)))
             * (1 + 0.5j) for ax, (a, b, c) in enumerate([nodes] * 3)]
    for comp, (az, dip) in enumerate(((0, 0), (90, 0), (0, 90))):
        axes = [(centres if ax == comp else nodes)[ax] for ax in range(3)]
        idx = (2, 2, 2)
        rec = [[axes[0][2], axes[1][2], axes[2][2], az, dip]]
        got = receivers.responses(nodes, field, rec)[0]
        assert got == pytest.approx(field[comp][idx], rel=1e-13)
    const = [np.full_like(f, 2.5 - 1j) for f in field]
    # Inside every component's stripped points.
    pts = np.stack([rng.uniform(c[1], c[-2], 6) for c in centres]
                   + [np.full(6, 30.0), np.full(6, 20.0)], axis=1)
    w = receivers.weights(pts)
    np.testing.assert_allclose(receivers.responses(nodes, const, pts),
                               (2.5 - 1j) * w.sum(0), rtol=1e-13)
    nodes, centres = _grid((48, 5, 5))
    nodes = (100.0 * np.arange(49.0) - 2400.0,) + nodes[1:]   # uniform x
    centres = [(a[:-1] + a[1:]) / 2 for a in nodes]
    lin = (3.0 + 0.02 * centres[0])[:, None, None] * np.ones(
        (1, len(nodes[1]), len(nodes[2])))
    mid = centres[0][23] + 0.37 * (centres[0][24] - centres[0][23])
    rec = [[mid, nodes[1][2], nodes[2][2], 0.0, 0.0]]
    got = receivers.responses(nodes, [lin, None, None], rec)[0]
    assert got == pytest.approx(3.0 + 0.02 * mid, rel=1e-12)


def test_receiver_reference_outside_is_nan_and_weights_exact():
    nodes, centres = _grid()
    field = _linear_field(nodes, centres, [(1.0, 0, 0, 0)] * 3)
    rec = [[0.0, 0.0, 0.0, 0.0, 0.0], [5000.0, 0.0, 0.0, 0.0, 0.0]]
    got = receivers.responses(nodes, field, rec)
    assert got[0] == pytest.approx(1.0 + 0.5j) and np.isnan(got[1])
    w = receivers.weights([[0, 0, 0, 90.0, 0.0], [0, 0, 0, 0.0, 90.0]])
    assert w.tolist() == [[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]


def test_responses_read_the_stored_field():
    """Each pair's stored responses against the reference: the port's
    ``get_receiver_response`` on a random field agrees to rounding, and
    another field's responses are far off."""
    import emg3d_tpu_torch as pt
    h, origin = marine.widths(CONFIG, rehearse=True)
    grid = pt.TensorMesh(h, origin=origin)
    rng = np.random.default_rng(11)
    shapes = (grid.shape_edges_x, grid.shape_edges_y, grid.shape_edges_z)
    comps = [rng.standard_normal(s) + 1j * rng.standard_normal(s)
             for s in shapes]
    _, recs, _ = marine.survey(CONFIG)
    got = pt.get_receiver_response(grid, pt.Field(*comps, frequency=1.0),
                                   tuple(np.array(recs).T))
    ref = receivers.responses(problem.nodes(h, origin), comps, recs)
    assert np.max(np.abs(got - ref)) <= 1e-14 * np.max(np.abs(ref))
    other = receivers.responses(problem.nodes(h, origin),
                                [c[::-1] for c in comps], recs)
    assert np.max(np.abs(other - ref)) > 0.1 * np.max(np.abs(ref))


def test_swapped_responses_make_correct_false(monkeypatch):
    """A fault of the survey layer alone: two pairs' stored responses
    swapped once every pair is stored (the fields are right)."""
    from emg3d_tpu_torch.simulations import Simulation
    real = Simulation._store_responses

    def swapped(self, source, frequency):
        real(self, source, frequency)
        data = self.data.synthetic
        if not getattr(self, '_swapped', False) and \
                not np.isnan(data).any():
            self._swapped = True
            a, b = data[0, :, 0].copy(), data[-1, :, -1].copy()
            data[0, :, 0], data[-1, :, -1] = b, a

    monkeypatch.setattr(Simulation, '_store_responses', swapped)
    out = harness.run(CELL, 3_000_000_017, 0.0, rehearse=True)
    assert out['checks']['responses']['value'] > 0.1
    assert out['checks']['residual']['value'] <= 1e-6
    assert out['correct'] is False


def _reader(name):
    return importlib.import_module(f'gpubench.metrics.{name}')


@pytest.fixture
def recorded():
    """Synthetic spans and counters of the survey layer and the lane
    loop, recorded under a profiler; the record emptied after."""
    from emg3d_tpu_torch import trace
    trace.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span('survey.compute'):
            for name in ('survey.grid', 'survey.sfield', 'survey.sfield',
                         'survey.responses'):
                with trace.span(name):
                    pass
        trace.count('krylov.lane_iters', 48)
        trace.count('krylov.settled_lane_iters', 12)
    yield trace.totals()
    trace.reset()


def test_survey_readers_hold_to_the_record(recorded):
    ns = sum(recorded[n]['ns'] for n in ('survey.grid', 'survey.sfield',
                                          'survey.responses'))
    assert ns > 0
    assert _reader('survey_host_ms').read(SimpleNamespace(jobs=2)) \
        == ns / 2 / 1e6
    assert _reader('settled_lane_share').read(SimpleNamespace(jobs=2)) \
        == 25.0
    for name in ('survey_host_ms', 'settled_lane_share'):
        assert _reader(name).read(SimpleNamespace(jobs=0)) is None


@pytest.mark.parametrize('name', ['survey_host_ms', 'settled_lane_share'])
def test_survey_readers_none_without_a_record(name):
    from emg3d_tpu_torch import trace
    trace.reset()
    assert _reader(name).read(SimpleNamespace(jobs=2)) is None


def test_traced_rehearsal_records_the_survey_layer():
    """A traced rehearsal of the cell records the survey's spans and
    the lane counters, which the readers then read."""
    from emg3d_tpu_torch import trace
    trace.reset()
    try:
        out = harness.run(CELL, 3_000_000_019, 0.0, trace=True,
                          rehearse=True)
        assert out['correct'] is True
        assert out['rehearsal']['calls'] > 0
        tot, counts = trace.totals(), trace.counts()
        # The one traced job: one compute of 24 pairs in one batch.
        assert tot['survey.compute']['calls'] == 1
        assert tot['survey.sfield']['calls'] == 24
        assert counts['survey.pairs'] == 24
        assert counts['survey.batches'] == 1
        assert counts['krylov.lane_iters'] % 24 == 0
        # Every reader of the program's record that the cell lists.
        for name in ('survey_host_ms', 'settled_lane_share',
                     'setup_host_ms', 'result_host_ms', 'sync_wait_ms',
                     'host_syncs', 'pageable_gib'):
            assert _reader(name).read(SimpleNamespace(jobs=1)) is not None
    finally:
        trace.reset()
