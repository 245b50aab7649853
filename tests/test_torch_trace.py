"""emg3d_tpu_torch.trace: the solve's spans and counters, on the CPU at 8³.

A point solve, an sc+lr solve, a BiCGSTAB solve and a 2-lane
``solve_batched`` run once untraced and once under one
``torch.profiler`` session: untraced nothing is recorded; traced each
records the spans of its layers under one solve id, nested in time, the
profiler holds the same spans as ``emg3d.<name>`` events with the same
nesting, the fetch and copy counts follow from the shapes, and fields
and ``info`` are the same as untraced.
"""
import collections
import sys
import threading

import numpy as np
import pytest
import torch

import emg3d_tpu_torch as pt
from emg3d_tpu_torch import solver, trace
from emg3d_tpu_torch.parallel import halo

torch.set_num_threads(1)

N = 8
OPTS = {
    'point': {},
    'sclr': {'semicoarsening': True, 'linerelaxation': True},
    'bicgstab': {'sslsolver': True},
    'batched': {},
}
CASES = list(OPTS)


def _problem():
    """A tri-axial model (three η arrays) and two sources."""
    grid = pt.TensorMesh([np.full(N, 100.)] * 3, origin=(-400.,) * 3)
    model = pt.Model(grid, property_x=1.0, property_y=2.0, property_z=3.0)
    sources = [pt.get_source_field(grid, (x, 0., 0., 0., 0.), 1.0)
               for x in (0., 100.)]
    return grid, model, sources


def _solve(case, grid, model, sources):
    """(fields, info) of one case."""
    if case == 'batched':
        return pt.solve_batched(grid, model, sources, verb=0, device='cpu')
    e, info = pt.solve(grid, model, sources[0], verb=0, device='cpu',
                       return_info=True, **OPTS[case])
    return [e], info


def _counting(calls, mp):
    """Count the calls of ``Space.norm`` and ``solver._dot``."""
    for owner, name in ((halo.Space, 'norm'), (solver, '_dot')):
        real = getattr(owner, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        mp.setattr(owner, name, counted)


@pytest.fixture(scope='module')
def runs():
    grid, model, sources = _problem()
    trace.reset()
    off = {c: _solve(c, grid, model, sources) for c in CASES}
    untraced = (trace.spans(), trace.counts())
    on, counts, fetches = {}, {}, {}
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for c in CASES:
            before = trace.counts()
            fetches[c] = collections.Counter()
            with pytest.MonkeyPatch.context() as mp:
                _counting(fetches[c], mp)
                on[c] = _solve(c, grid, model, sources)
            counts[c] = {k: v - before.get(k, 0)
                         for k, v in trace.counts().items()
                         if v != before.get(k, 0)}
    record = trace.spans()
    events = _nest([e for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(trace.PREFIX)])
    trace.reset()
    ids = list(dict.fromkeys(s['solve'] for s in record))
    per_case = {c: [s for s in record if s['solve'] == i]
                for c, i in zip(CASES, ids)}
    return dict(grid=grid, model=model, sources=sources, off=off, on=on,
                untraced=untraced, record=record, ids=ids,
                per_case=per_case, counts=counts, fetches=fetches,
                events=events)


def test_untraced_records_nothing(runs):
    assert runs['untraced'] == ([], {})
    assert not trace.enabled()
    assert trace.span('solve') is trace.span('sync')
    steps = range(3)
    assert trace.each('mg.cycle', steps) is steps
    trace.count('copy.h2d_bytes', 5)
    assert trace.counts() == {} and trace.spans() == []


@pytest.mark.parametrize('case', CASES)
def test_traced_solve_is_the_same(runs, case):
    (e0, i0), (e1, i1) = runs['off'][case], runs['on'][case]
    for a, b in zip(e0, e1):
        assert np.array_equal(a.field, b.field)
    for key in ('it_mg', 'it_ssl', 'exit_message'):
        assert i0[key] == i1[key]
    assert i1['exit_message'] == 'CONVERGED'


@pytest.mark.parametrize('case', CASES)
def test_spans_nest_in_one_solve(runs, case):
    """One solve id per call; each child inside its parent; the layers'
    spans where the case runs them."""
    assert len(runs['ids']) == len(CASES) == len(set(runs['ids']))
    rec = runs['record']
    spans = runs['per_case'][case]
    root = spans[0]
    assert root['name'] == 'solve' and root['parent'] == -1
    for s in spans[1:]:
        parent = rec[s['parent']]
        assert parent['solve'] == root['solve']
        assert parent['start_ns'] <= s['start_ns'] <= s['end_ns'] \
            <= parent['end_ns']
    parents = collections.defaultdict(set)
    for s in spans[1:]:
        parents[s['name']].add(rec[s['parent']]['name'])
    assert parents['solve.setup'] == parents['solve.result'] == {'solve'}
    for name in ('setup.norm', 'setup.volume_model', 'setup.upload'):
        assert parents[name] == {'solve.setup'}
    assert 'solve.setup' in parents['setup.levels']
    assert parents['sync'] and parents['levels.state']
    smooth = {'point': 'smooth.point', 'bicgstab': 'smooth.point',
              'batched': 'smooth.point', 'sclr': 'smooth.line'}[case]
    assert parents[smooth]
    if case == 'bicgstab':
        assert parents['krylov.iter'] == {'solve'}
        assert parents['mg.cycle'] == {'krylov.iter'}
    else:
        assert parents['mg.cycle'] == {'solve'}
        assert 'krylov.iter' not in parents
    assert ('setup.zero_field' in parents) == (case != 'batched')
    cycles = sum(s['name'] == 'mg.cycle' for s in spans)
    assert cycles == runs['on'][case][1]['it_mg']


@pytest.mark.parametrize('case', CASES)
def test_host_syncs(runs, case):
    """A single multigrid solve fetches its source's norm, once before
    its cycles, once a cycle and three field components (a batched one
    takes its sources' norms on the host); a Krylov solve once a norm
    (the source's too) and an inner product, and the three
    components."""
    syncs = sum(s['name'] == 'sync' for s in runs['per_case'][case])
    if case == 'bicgstab':
        calls = runs['fetches'][case]
        assert syncs == calls['norm'] + calls['_dot'] + 3
    elif case == 'batched':
        assert syncs == runs['on'][case][1]['it_mg'] + 4
    else:
        assert syncs == runs['on'][case][1]['it_mg'] + 5


def _field_bytes(sf):
    """The bytes of a field's dense arrays (a recorded source builds
    none for it)."""
    return sum(int(np.prod(sh)) for sh in sf.shape) * sf.dtype.itemsize


def _record_bytes(sf):
    """The bytes of a recorded source's edge indices and values."""
    return sum(i.nbytes + v.nbytes for i, v, _ in sf.record)


def _hierarchy_bytes(grid, vmodel, sc_dir, clevel, finest):
    """The bytes of a hierarchy's host-made arrays: every level's
    transfer weights, the coarse levels' widths, and of the finest level
    η, ζ and the widths (``finest`` 'all'), the widths alone ('widths':
    η and ζ were made on the device) or nothing ('none': shared with the
    solve's first hierarchy)."""
    levels = solver.build_levels(grid, vmodel, sc_dir, clevel, 'cpu',
                                 {'bytes': 0})
    made = {}
    for i, lev in enumerate(levels):
        for j, a in enumerate(lev.arrays):
            if i > 0 and j >= 4 or i == 0 and (
                    finest == 'all' or finest == 'widths' and j >= 4):
                made[id(a)] = a
        for w in (lev.rweights or ()) + (lev.pweights or ()):
            for t in (w if isinstance(w, tuple) else (w,)):
                if t is not None:
                    made[id(t)] = t
    return trace.nbytes(made.values())


def _model_bytes(grid, model):
    """The bytes a single solve copies to derive η and ζ on its device:
    the model's own property arrays (μr and εr too, where given) and the
    widths."""
    props = (model._property_x, model._property_y, model._property_z,
             model.mu_r, model.epsilon_r)
    return (sum(np.asarray(p).nbytes for p in props if p is not None)
            + sum(np.asarray(h, dtype=np.float64).nbytes for h in grid.h))


def _visits(case, info, grid):
    """(var, the semicoarsening directions the cycles visit)."""
    var = solver.MGParameters(
        verb=0, cycle='F', sslsolver=OPTS[case].get('sslsolver', False),
        linerelaxation=OPTS[case].get('linerelaxation', False),
        semicoarsening=OPTS[case].get('semicoarsening', False),
        shape_cells=tuple(grid.shape_cells))
    digits = [int(d) for d in var._raw_sc_cycle]
    return var, {digits[i % len(digits)] for i in range(info['it_mg'])}


@pytest.mark.parametrize('case', CASES)
def test_copy_bytes(runs, case):
    """Uploads: a single solve's source record (the indices and values
    of the edges it touches: the source is placed on the device from
    them) and the model's properties and widths (no start field: it is
    made on the device), then one hierarchy per semicoarsening direction
    the cycles visit, its finest level's η and ζ made on the device and
    shared by the later ones; a batched solve's source records and its
    host-made η and ζ.  The fetch: the returned fields.  A single solve
    counts one device-made η/ζ and the hierarchies that shared the first
    one's finest level; every solve counts its sources placed from
    their records."""
    grid, model, sources = runs['grid'], runs['model'], runs['sources']
    info = runs['on'][case][1]
    var, visited = _visits(case, info, grid)
    vmodel = pt.VolumeModel(grid, model, sources[0])
    fields = _field_bytes(sources[0])
    assert len(visited) == (3 if case == 'sclr' else 1)
    if case == 'batched':
        h2d = sum(_record_bytes(sf) for sf in sources) + _hierarchy_bytes(
            grid, vmodel, var.sc_dir, int(var.clevel[var.sc_dir]), 'all')
        want = {'copy.h2d_bytes': h2d, 'copy.d2h_bytes': 2 * fields,
                'source.compact': 2}
    else:
        first = int(var.sc_dir)
        h2d = _record_bytes(sources[0]) + _model_bytes(grid, model) + sum(
            _hierarchy_bytes(grid, vmodel, sc, int(var.clevel[sc]),
                             'widths' if sc == first else 'none')
            for sc in visited)
        want = {'copy.h2d_bytes': h2d, 'copy.d2h_bytes': fields,
                'setup.device_params': 1, 'source.compact': 1}
        if len(visited) > 1:
            want['levels.fine_shared'] = len(visited) - 1
    assert runs['counts'][case] == want
    assert not trace.counts()


@pytest.mark.parametrize('case', CASES)
def test_device_setup(runs, case):
    """A single solve derives η and ζ once on its device and shares the
    first hierarchy's finest level: 2 later hierarchies in the sc+lr
    case, none in the point cases; a batched solve does neither."""
    counts = runs['counts'][case]
    single = case != 'batched'
    assert counts.get('setup.device_params', 0) == int(single)
    assert counts.get('levels.fine_shared', 0) == \
        (2 if case == 'sclr' else 0)
    hiers = sum(s['name'] == 'setup.levels'
                for s in runs['per_case'][case])
    assert hiers == 1 + counts.get('levels.fine_shared', 0)


def _nest(events):
    """(name, the name of the innermost event around it) of each of the
    profiler's events, by their intervals on their thread."""
    out, open_ = [], {}
    for t0, t1, name, tid in sorted(
            (e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
             e.start_thread_id()) for e in events):
        stack = open_.setdefault(tid, [])
        while stack and not t1 <= stack[-1][1]:
            stack.pop()
        out.append((name, stack[-1][2] if stack else None))
        stack.append((t0, t1, name))
    return out


def test_profiler_holds_the_spans(runs):
    """Every span is an ``emg3d.<name>`` event of the profiler, under
    the event of its parent span."""
    rec = runs['record']
    want = collections.Counter(
        (trace.PREFIX + s['name'],
         trace.PREFIX + rec[s['parent']]['name'] if s['parent'] >= 0
         else None) for s in rec)
    got = collections.Counter(runs['events'])
    assert got == want


def test_totals_and_self_time(runs):
    """``totals`` over a record: calls, summed and self durations; the
    self times of all spans add up to the root spans' durations."""
    rec = runs['record']
    trace.reset()
    trace._SPANS.extend([s['name'], s['start_ns'], s['end_ns'], s['parent'],
                         s['solve']] for s in rec)
    try:
        tot = trace.totals()
    finally:
        trace.reset()
    assert sum(t['calls'] for t in tot.values()) == len(rec)
    roots = sum(s['end_ns'] - s['start_ns'] for s in rec
                if s['parent'] == -1)
    assert tot['solve']['ns'] == roots
    assert sum(t['self_ns'] for t in tot.values()) == roots
    for t in tot.values():
        assert 0 <= t['self_ns'] <= t['ns']


def test_spans_call_nothing_on_a_device(monkeypatch):
    """Spans, loops and counters neither synchronize nor allocate."""
    def refuse(*a, **k):
        raise AssertionError('called while tracing')
    trace.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for name in ('synchronize', 'current_stream', 'Event'):
            monkeypatch.setattr(torch.cuda, name, refuse)
        for name in ('empty', 'zeros', 'tensor'):
            monkeypatch.setattr(torch, name, refuse)
        with trace.span('solve', new_solve=True):
            for _ in trace.each('mg.cycle', range(2)):
                with trace.span('sync'):
                    trace.count('copy.d2h_bytes', 16)
        monkeypatch.undo()
    try:
        assert [s['name'] for s in trace.spans()] == [
            'solve', 'mg.cycle', 'sync', 'mg.cycle', 'sync']
        assert trace.counts() == {'copy.d2h_bytes': 32}
        assert trace.totals()['sync']['calls'] == 2
    finally:
        trace.reset()
    assert trace.spans() == [] and trace.counts() == {}


def test_worker_threads_record_nothing():
    """The profiler's state is per thread: a worker thread started by a
    profiled thread records no span."""
    trace.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        worker = threading.Thread(target=lambda: trace.span('sync'))
        worker.start()
        worker.join(timeout=60)
        with trace.span('solve', new_solve=True):
            pass
    assert not worker.is_alive()
    try:
        assert [s['name'] for s in trace.spans()] == ['solve']
    finally:
        trace.reset()


def test_spans_from_many_threads_keep_their_nesting(monkeypatch):
    """Spans and counters on many threads at once, each as if its own
    profiler recorded: each span keeps its own thread's parent and solve
    id, and no counter update is lost."""
    def work():
        with trace.span('solve', new_solve=True):
            for _ in range(50):
                with trace.span('sync'):
                    trace.count('copy.d2h_bytes', 1)
    monkeypatch.setattr(trace, '_on', lambda: True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.reset()
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        rec = trace.spans()
        assert trace.counts() == {'copy.d2h_bytes': 16 * 50}
        assert len(rec) == 16 * 51
        roots = [s for s in rec if s['name'] == 'solve']
        assert len({s['solve'] for s in roots}) == 16
        for s in rec:
            if s['name'] == 'sync':
                parent = rec[s['parent']]
                assert parent['name'] == 'solve'
                assert parent['solve'] == s['solve']
                assert parent['start_ns'] <= s['start_ns'] <= s['end_ns'] \
                    <= parent['end_ns']
    finally:
        sys.setswitchinterval(old)
        trace.reset()
