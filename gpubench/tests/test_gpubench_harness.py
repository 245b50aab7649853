"""The harness: every name resolves to a file, names and units keep to
the contract, the result line's keys, the modules a run loads, and a
rehearsal of each cell on the CPU, also with the timed path broken; the
same for a batched cell that exists only in these tests."""
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gpubench import harness

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / 'gpubench'
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
CELLS = [w['name'] for w in BENCH['workloads']]
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
SAMPLES = HERE / 'tests' / 'samples'


@pytest.mark.parametrize('cell', CELLS)
def test_cell_files_exist(cell):
    workload = json.loads((HERE / 'workloads' / f'{cell}.json').read_text())
    entry = next(w for w in BENCH['workloads'] if w['name'] == cell)
    assert workload['name'] == cell
    assert workload['config'] == entry['config']
    assert workload['chips'] == entry['chips'] == 1
    assert workload['why'] == entry['why']
    assert (HERE / 'configs' / f"{workload['config']}.json").is_file()
    assert (HERE / 'jobs' / f"{workload['kind']}.py").is_file()
    kind = importlib.import_module(f"gpubench.jobs.{workload['kind']}")
    for fn in ('prepare', 'run', 'check'):
        assert callable(getattr(kind, fn))


def test_configs_resolve():
    for c in BENCH['configs']:
        path = ROOT / c['file']
        assert path.is_file() and c['file'].startswith('gpubench/')
        config = json.loads(path.read_text())
        assert config['name'] == c['name']
        assert config['source'] == c['source']
        assert config['reduced'] == c['reduced']
        assert any(w['config'] == c['name'] for w in BENCH['workloads'])


@pytest.mark.parametrize('metric', BENCH['end_to_end'] + BENCH['per_layer'],
                         ids=lambda m: m['name'])
def test_metric_reader_exists(metric):
    reader = importlib.import_module(f"gpubench.metrics.{metric['name']}")
    assert callable(reader.read)
    assert UNIT.match(metric['unit'])
    assert metric['better'] in ('lower', 'higher')


def test_names_units_and_limits():
    names = ([c['name'] for c in BENCH['configs']] + CELLS
             + [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
             + [w['traffic'] for w in BENCH['workloads']]
             + [k for c in BENCH['configs'] for k in c['reduced']])
    for n in names:
        assert NAME.match(n), n
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        got = [x['name'] for x in BENCH[group]]
        assert len(got) == len(set(got))
    for text in ([w['why'] for w in BENCH['workloads']]
                 + [c['why'] for c in BENCH['configs']]
                 + [c['source'] for c in BENCH['configs']]
                 + [m['layer'] for m in BENCH['per_layer']]):
        assert 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text
    e2e = {m['name'] for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e
    for m in BENCH['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25 and m['source'] in (
            'host_clock', 'device_trace')
    for m in BENCH['per_layer']:
        assert m['moves'] in e2e
        assert set(m['workloads']) <= set(CELLS)
    for cell in CELLS:
        assert len(harness.metrics_of(BENCH, cell, False)) >= 2
        assert harness.metrics_of(BENCH, cell, True)
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize('sample', sorted(SAMPLES.glob('*.json')),
                         ids=lambda p: p.name)
def test_recorded_result_line_keys(sample):
    """The last line a card run printed: the contract's keys, with the
    compared numbers last."""
    out = json.loads(sample.read_text().strip().splitlines()[-1])
    keys = list(out)
    assert keys[-1] == 'checks'
    want = {'correct', 'attempted', 'failed', 'metrics', 'device'}
    assert set(keys[:-1]) in (want, want | {'breakdown'})
    assert out['correct'] is True and out['failed'] == 0
    dev = out['device']
    assert dev['platform'] == 'gpu' and dev['count'] == 1
    assert dev['memory_peak_bytes'] > 0
    for name, m in out['metrics'].items():
        assert set(m) == {'value', 'unit'} and m['value'] > 0, name
    if 'breakdown' in out:
        assert dev['busy_s'] > 0 and dev['window_s'] > 0
        assert len(out['breakdown']['device_ops']) <= 10
        assert len(out['breakdown']['idle_gaps']) <= 10
    for c in out['checks'].values():
        assert c['value'] <= c['limit']


def test_banned_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, 'emg3d_tpu_torch_fake', sys)
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, 'jaxlib.fake', sys)
    assert harness.banned_modules() == ['jaxlib']


def _rehearse(cell, trace=False, seed=3_000_000_001):
    return harness.run(cell, seed, 0.0, trace=trace, rehearse=True)


# A batched cell that exists only here: ``Simulation.compute()`` of 2
# sources x 2 frequencies at 8³, sc+lr BiCGSTAB, through a job kind of
# the tests' own (``batched_kind.py``), which the harness finds by name
# as it finds the kinds of gpubench/jobs/.  Every test of a rehearsed
# cell below takes it beside the cells of BENCHMARK.json.

BATCHED = 'batched8.compute'
BATCHED_WORKLOAD = {
    'name': BATCHED, 'config': 'batched8', 'kind': 'batched_test',
    'chips': 1,
    'why': "2 sources x 2 frequencies at 8^3 in one Simulation.compute(): "
           "one batched sc+lr BiCGSTAB solve",
    'traffic': {'source_offset': {'low': -40.0, 'high': 40.0, 'size': 3}},
    'solver': {'sslsolver': True, 'semicoarsening': True,
               'linerelaxation': True},
    'check': {'jobs': 1, 'residual_gap': 1e-9}}
BATCHED_CONFIG = {
    'name': 'batched8',
    'grid': {ax: {'core': [-400.0, 8, 100.0]} for ax in 'xyz'},
    'model': {'background': [1.0, 2.0, 3.0]},
    'sources': [[-60.0, 10.0, 5.0, 0.0, 0.0], [70.0, -20.0, -5.0, 90.0, 0.0]],
    'receivers': [[-250.0, 0.0, 0.0, 0.0, 0.0], [250.0, 50.0, 0.0, 0.0, 0.0]],
    'frequencies': [0.5, 2.0],
    'solver': {'tol': 1e-6, 'cycle': 'F'}}


@pytest.fixture(params=CELLS + [BATCHED])
def cell(request, monkeypatch):
    """A cell to rehearse; for the batched one, ``load_cell`` gives it
    and its kind is the module ``gpubench.jobs.batched_test``."""
    if request.param == BATCHED:
        from gpubench.tests import batched_kind
        entry = dict(BATCHED_WORKLOAD, traffic='batched8')
        del entry['kind'], entry['solver'], entry['check']
        bench = dict(BENCH, workloads=BENCH['workloads'] + [entry])
        real = harness.load_cell

        def load_cell(name):
            if name == BATCHED:
                return bench, BATCHED_WORKLOAD, BATCHED_CONFIG
            return real(name)
        monkeypatch.setattr(harness, 'load_cell', load_cell)
        monkeypatch.setitem(sys.modules, 'gpubench.jobs.batched_test',
                            batched_kind)
    return request.param


def test_rehearsal_is_correct(cell, monkeypatch):
    calls = _broken_solver(monkeypatch)
    out = _rehearse(cell)
    _reached(cell, calls)
    assert out['correct'] is True and out['failed'] == 0
    assert 'metrics' not in out and 'device' not in out
    assert harness.banned_modules() == []


def test_rehearsal_traced_records_spans_and_calls():
    out = _rehearse('fullspace256.sclr', trace=True)
    assert out['correct'] is True
    spans = out['rehearsal']['spans']
    for kind in ('job', 'solve', 'levels'):
        assert spans[kind] > 0
    assert out['rehearsal']['calls'] > 0


def test_run_in_a_fresh_process_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); from gpubench import "
            "harness; harness.run('fullspace256.point', 5, 0.0, "
            "rehearse=True); print(harness.banned_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'


# The timed path broken underneath: each fault a cell can have makes
# ``correct`` false.  A job kind reaches the solver only through
# ``solver.solve`` or ``solver.solve_batched`` (gpubench/jobs/__init__.py),
# so the faults are planted in both entries, in every Field they return:
# every lane of a batch.  A batch answers for all its pairs at once, so
# no fault leaves half of its lanes out; one card has no exchange to
# leave out.

def _zero(f):
    return type(f)(*(np.zeros_like(np.asarray(c)) for c in (f.fx, f.fy, f.fz)),
                   frequency=f._frequency)


def _altered(f):
    fx = np.array(f.fx)
    i = np.unravel_index(np.argmax(np.abs(fx)), fx.shape)
    fx[tuple(min(n - 2, max(1, j + 1)) for n, j in zip(fx.shape, i))] \
        += 1e-3 * np.abs(fx).max()
    return type(f)(fx, f.fy, f.fz, frequency=f._frequency)


def _complex64(f):
    return type(f)(
        *(np.asarray(c).astype(np.complex64) for c in (f.fx, f.fy, f.fz)),
        frequency=f._frequency)


# What a broken solve hands back in place of each Field it solved:
# - ``state_returned_unchanged``: its starting field (zero), as converged;
# - ``answer_altered``: one edge altered by a part in a thousand of the
#   field's largest value;
# - ``field_returned_in_complex64``: the field rounded to complex64 (half
#   the bytes to copy), its reported residual that of the complex128
#   field, so the residual's gap fails it.
FAULTS = {'state_returned_unchanged': _zero, 'answer_altered': _altered,
          'field_returned_in_complex64': _complex64}


def _broken_solver(monkeypatch, alter=None, report=None):
    """``solver.solve`` and ``solver.solve_batched``, replaced through
    their module attributes as the program calls them, each returned
    Field passed through ``alter`` and the ``info`` through ``report``;
    what is not altered is left as the solve gave it.  Returns the calls
    each entry took."""
    from emg3d_tpu_torch import solver
    calls = {'solve': 0, 'solve_batched': 0}

    def broken(entry, real):
        def call(*a, **k):
            calls[entry] += 1
            out = real(*a, **k)
            field, info = out if isinstance(out, tuple) else (out, None)
            if alter is not None:
                field = ([alter(f) for f in field] if isinstance(field, list)
                         else alter(field))
            if info is None:
                return field
            return field, (report(info) if report is not None else info)
        return call

    for entry in calls:
        monkeypatch.setattr(solver, entry, broken(entry,
                                                  getattr(solver, entry)))
    return calls


def _reached(cell, calls):
    """The cell's jobs reached a solver entry; the batched cell's only
    ``solve_batched``."""
    assert sum(calls.values()) > 0, "the cell's jobs reached no solver entry"
    if cell == BATCHED:
        assert calls['solve'] == 0 and calls['solve_batched'] > 0


@pytest.mark.parametrize('fault', FAULTS)
def test_fault_makes_correct_false(cell, fault, monkeypatch):
    calls = _broken_solver(monkeypatch, FAULTS[fault])
    out = _rehearse(cell)
    _reached(cell, calls)
    if fault == 'field_returned_in_complex64':
        assert out['checks']['residual_gap']['value'] > \
            out['checks']['residual_gap']['limit']
    assert out['correct'] is False


def test_lower_precision_control_is_not_correct(cell, monkeypatch):
    """The control, the program's complex64 path without its two-float
    accumulation, run through the harness: ``correct`` false."""
    from gpubench import control
    calls = _broken_solver(monkeypatch)
    with control.single_precision():
        out = _rehearse(cell)
    _reached(cell, calls)
    assert out['correct'] is False


def _stalled(info):
    """A solve's report with its exit message that of no convergence
    (for a batch: the message all its lanes share)."""
    return dict(info, exit_message='MAX. ITERATION REACHED, NOT CONVERGED')


def test_not_converged_counts_as_failed(cell, monkeypatch):
    calls = _broken_solver(monkeypatch, report=_stalled)
    out = _rehearse(cell)
    _reached(cell, calls)
    assert out['failed'] == out['attempted'] >= 1
    assert out['correct'] is False


@pytest.mark.cuda
@pytest.mark.parametrize('trace', [0, 1])
def test_card_run_prints_the_result_line(trace, tmp_path):
    """On the card: one short run of a cell ends in a result line with
    the contract's keys and correct true."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, 'gpubench/run.py', '--workload', 'fullspace256.point',
         '--seed', '2147483999', '--seconds', '2', '--trace', str(trace)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = tmp_path / 'line.json'
    line.write_text(out.stdout)
    test_recorded_result_line_keys(line)


def test_no_result_without_a_card():
    """Here, with no card, a run exits 1 and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, 'gpubench/run.py', '--workload', 'fullspace256.point',
         '--seed', '1', '--seconds', '1', '--trace', '0'],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 1 and out.stdout == ''
    assert 'no CUDA device' in out.stderr


def test_no_result_from_the_benchmark_files_alone(tmp_path):
    """A directory with only BENCHMARK.json and gpubench/ holds no
    program: a run exits with an error and prints no result."""
    import shutil
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(HERE, tmp_path / 'gpubench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = subprocess.run(
        [sys.executable, 'gpubench/run.py', '--workload', 'fullspace256.point',
         '--seed', '1', '--rehearse'],
        capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ''
