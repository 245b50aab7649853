"""The readers of the program's own spans and counters
(``emg3d_tpu_torch.trace``): each equals its sum over a profiled CPU
window of two solves, and is None where nothing was recorded, where no
job ran, and on a program that has no such module."""
import importlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import emg3d_tpu_torch as pt
from emg3d_tpu_torch import trace

READERS = ('setup_host_ms', 'result_host_ms', 'sync_wait_ms', 'host_syncs',
           'pageable_gib')


def _read(name, jobs):
    reader = importlib.import_module(f'gpubench.metrics.{name}')
    return reader.read(SimpleNamespace(jobs=jobs))


@pytest.fixture(scope='module')
def window():
    """Two point solves at 8³ under the profiler: the totals, counters
    and ``it_mg`` of each; the record is emptied after."""
    grid = pt.TensorMesh([np.full(8, 100.)] * 3, origin=(-400.,) * 3)
    model = pt.Model(grid, property_x=1.0)
    trace.reset()
    its = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for x in (0., 100.):
            sfield = pt.get_source_field(grid, (x, 0., 0., 0., 0.), 1.0)
            _, info = pt.solve(grid, model, sfield, verb=0, device='cpu',
                               return_info=True)
            its.append(info['it_mg'])
    readings = {name: _read(name, 2) for name in READERS}
    out = dict(totals=trace.totals(), counts=trace.counts(), its=its,
               readings=readings)
    trace.reset()
    return out


def test_readers_hold_to_the_record(window):
    tot, got = window['totals'], window['readings']
    assert got['setup_host_ms'] == tot['solve.setup']['ns'] / 2 / 1e6
    assert got['result_host_ms'] == tot['solve.result']['ns'] / 2 / 1e6
    assert got['sync_wait_ms'] == tot['sync']['ns'] / 2 / 1e6
    # A single solve's fetches: one a cycle, its source norm and four
    # more (as tests/test_torch_trace.py counts them).
    assert got['host_syncs'] == sum(it + 5 for it in window['its']) / 2
    counts = window['counts']
    assert got['pageable_gib'] == (counts['copy.h2d_bytes']
                                   + counts['copy.d2h_bytes']) / 2 / 2**30
    for value in got.values():
        assert value > 0


@pytest.mark.parametrize('name', READERS)
def test_reader_none_without_a_record(name):
    trace.reset()
    assert _read(name, 2) is None


@pytest.mark.parametrize('name', READERS)
def test_reader_none_without_jobs(name, window):
    trace.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span('solve.setup'), trace.span('solve.result'), \
                trace.span('sync'):
            trace.count('copy.h2d_bytes', 16)
    try:
        assert _read(name, 0) is None
        assert _read(name, 1) is not None
    finally:
        trace.reset()


@pytest.mark.parametrize('name', READERS)
def test_reader_none_on_a_program_without_spans(name, monkeypatch):
    """The program as it was before it recorded spans: no module
    ``emg3d_tpu_torch.trace``."""
    monkeypatch.delattr(pt, 'trace')
    monkeypatch.setitem(sys.modules, 'emg3d_tpu_torch.trace', None)
    assert _read(name, 2) is None
