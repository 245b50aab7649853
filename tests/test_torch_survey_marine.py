"""A marine survey through the port's ``Simulation.compute()`` on the CPU.

Constable & Weiss's canonical model (``gpubench/configs/marine_cw06.json``:
air, 0.3 Ω·m sea, 1 Ω·m sediments, a 100 Ω·m reservoir) on its small
stretched grid (8³, every layer in at least one cell), each cell's
ρx, ρy, ρz perturbed at random from a seed; 2 sources × 2 frequencies,
Simulation's defaults (sc+lr BiCGSTAB, tol 1e-6), one 4-lane
``solve_batched`` call.

- (a) each lane's relative residual by the benchmark's plain reference
  is within tol and within 1e-9 of the lane's ``rel_error``;
- (b) ``data.synthetic`` equals the plain receiver reference's
  responses of the returned fields within 1e-12;
- (c) the JAX package's ``Simulation`` of the same survey gives equal
  ``exit_message``, ``it_mg``, ``it_ssl``, fields within 1e-9 and
  synthetic data within 1e-9;
- (d) under a profiler the survey's spans nest in ``survey.compute``,
  its counters count 4 pairs in 1 batch, and the Krylov loop counts
  lanes × iterations lane-iterations, the settled ones among them;
  untraced nothing is recorded.
"""
import collections
import json
from pathlib import Path

import pytest

pytest.importorskip('jax')

import numpy as np  # noqa: E402
import torch  # noqa: E402

import emg3d_tpu as jt  # noqa: E402

import emg3d_tpu_torch as pt  # noqa: E402
from emg3d_tpu_torch import trace  # noqa: E402
from gpubench import marine, problem, reference  # noqa: E402
from gpubench.reference import receivers  # noqa: E402

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

CONFIG = json.loads((Path(__file__).resolve().parents[1] / 'gpubench'
                     / 'configs' / 'marine_cw06.json').read_text())
TOL = 1e-6


def _inputs():
    """Widths, origin, perturbed (ρx, ρy, ρz), and the survey's first and
    last sources, receivers and first two frequencies."""
    h, origin = marine.widths(CONFIG, rehearse=True)
    rng = np.random.default_rng(24)
    rho = tuple(r * 10 ** rng.uniform(-0.1, 0.1, r.shape)
                for r in marine.resistivity(CONFIG['model'], h, origin))
    srcs, recs, freqs = marine.survey(CONFIG, (37.0, -12.0))
    return h, origin, rho, [srcs[0], srcs[-1]], recs, freqs[:2]


def _simulation(pkg, opts):
    h, origin, rho, srcs, recs, freqs = _inputs()
    grid = pkg.TensorMesh(h, origin=origin)
    survey = pkg.Survey('marine', tuple(np.array(srcs).T),
                        tuple(np.array(recs).T), freqs)
    return pkg.Simulation('marine', survey, grid,
                          pkg.Model(grid, *rho, mapping='Resistivity'),
                          gridding='same', verb=-1, max_workers=1,
                          solver_opts={'tol': TOL, **opts})


def _pairs(sim):
    """(source name, frequency) of every pair."""
    return [(s, f) for s in sim.survey.sources
            for f in sim.survey.frequencies]


# The pairs by index: (source, frequency).
PAIRS = [(i, k) for i in range(2) for k in range(2)]


def _pair(sim, pair):
    i, k = pair
    return list(sim.survey.sources)[i], float(sim.survey.frequencies[k])


@pytest.fixture(scope='module')
def runs():
    """The port's survey untraced and traced (one profiler session),
    with what the trace recorded."""
    trace.reset()
    off = _simulation(pt, {'device': 'cpu'})
    off.compute()
    untraced = (trace.spans(), trace.counts())
    on = _simulation(pt, {'device': 'cpu'})
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on.compute()
    out = dict(off=off, on=on, untraced=untraced, spans=trace.spans(),
               counts=trace.counts())
    trace.reset()
    return out


@pytest.mark.parametrize('pair', PAIRS)
def test_lane_meets_the_reference(runs, pair):
    """(a): the lane's residual by the plain reference."""
    sim = runs['off']
    h, origin, rho, srcs, _, _ = _inputs()
    name, f = _pair(sim, pair)
    info = sim.get_efield_info(name, f)
    assert info['exit_message'] == 'CONVERGED'
    e = sim.get_efield(name, f)
    eta, zeta = reference.eta_zeta(h, rho, f)
    s = reference.source_field(problem.nodes(h, origin), srcs[pair[0]], f)
    (rel,) = reference.relative_residuals([(e.fx, e.fy, e.fz)], [s], eta,
                                          zeta, h)
    assert rel <= TOL
    assert abs(rel - info['rel_error']) <= 1e-9


@pytest.mark.parametrize('pair', PAIRS)
def test_responses_equal_the_reference(runs, pair):
    """(b): the pair's stored responses are the plain reference's of its
    returned field."""
    sim = runs['off']
    h, origin, _, _, recs, _ = _inputs()
    e = sim.get_efield(*_pair(sim, pair))
    ref = receivers.responses(problem.nodes(h, origin), (e.fx, e.fy, e.fz),
                              recs)
    assert np.all(np.isfinite(ref))
    data = np.asarray(sim.data.synthetic)[pair[0], :, pair[1]]
    assert tp.rel([data], [ref]) <= 1e-12


@pytest.fixture(scope='module')
def jax_run():
    """(c): the JAX package's Simulation of the same survey."""
    sim = _simulation(jt, {})
    sim.compute()
    return sim


@pytest.mark.parametrize('pair', PAIRS)
def test_survey_matches_jax(runs, jax_run, pair):
    """(c): the pair's solve and responses against the JAX package's."""
    sim, ref = runs['off'], jax_run
    name, f = _pair(sim, pair)
    ij, ip = ref.get_efield_info(name, f), sim.get_efield_info(name, f)
    for key in ('exit_message', 'it_mg', 'it_ssl'):
        assert ip[key] == ij[key], key
    ej, ep = ref.get_efield(name, f), sim.get_efield(name, f)
    assert tp.rel((ep.fx, ep.fy, ep.fz), (ej.fx, ej.fy, ej.fz)) <= 1e-9
    i, k = pair
    assert tp.rel([np.asarray(sim.data.synthetic)[i, :, k]],
                  [np.asarray(ref.data.synthetic)[i, :, k]]) <= 1e-9


def test_survey_spans_and_counters(runs):
    """(d): the survey's spans under ``survey.compute``, its counters,
    and the batched Krylov loop's lane counts; untraced, nothing."""
    assert runs['untraced'] == ([], {})
    spans, counts, sim = runs['spans'], runs['counts'], runs['on']
    parents = collections.defaultdict(set)
    for s in spans:
        parent = spans[s['parent']]['name'] if s['parent'] >= 0 else None
        parents[s['name']].add(parent)
        if s['parent'] >= 0:
            p = spans[s['parent']]
            assert p['start_ns'] <= s['start_ns'] <= s['end_ns'] \
                <= p['end_ns']
    assert parents['survey.compute'] == {None}
    for name in ('survey.grid', 'survey.sfield', 'survey.responses',
                 'solve'):
        assert parents[name] == {'survey.compute'}, name
    names = collections.Counter(s['name'] for s in spans)
    assert names['survey.compute'] == names['solve'] == 1
    # A grid and a model for the one share key of gridding='same'; a
    # source field and a response per pair.
    assert names['survey.grid'] == 2
    assert names['survey.sfield'] == names['survey.responses'] == 4
    assert counts['survey.pairs'] == 4 and counts['survey.batches'] == 1
    assert 'survey.unbatched' not in counts
    info = sim.get_efield_info(*_pairs(sim)[0])
    assert info['it_ssl'] > 0
    assert counts['krylov.lane_iters'] == 4 * info['it_ssl']
    assert 0 <= counts.get('krylov.settled_lane_iters', 0) \
        <= counts['krylov.lane_iters']
    # The traced survey is the untraced one.
    assert np.array_equal(np.asarray(sim.data.synthetic),
                          np.asarray(runs['off'].data.synthetic))


def test_lane_counters_of_one_step():
    """``_lanes_done`` counts a step's lanes and its settled ones (the
    converged and the already inactive) only where the loop goes on."""
    from emg3d_tpu_torch import solver
    r = tuple(torch.zeros(4, 2, 2, 2, dtype=torch.complex128)
              for _ in range(3))
    r[0][1] += 1.0                       # lane 1 above atol
    r[0][2] += 1.0                       # lane 2 above, but inactive
    active = torch.tensor([True, True, False, True])
    trace.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        settled, converged, act = solver._lanes_done(r, active,
                                                     np.full(4, 0.5))
        assert not settled and not converged
        assert act.tolist() == [False, True, False, False]
        assert trace.counts() == {'krylov.lane_iters': 4,
                                  'krylov.settled_lane_iters': 3}
        # Every lane settled: the loop ends, and counts nothing more.
        settled, _, _ = solver._lanes_done(
            r, torch.tensor([True, False, False, True]), np.full(4, 0.5))
        assert settled
        assert trace.counts()['krylov.lane_iters'] == 4
    trace.reset()
