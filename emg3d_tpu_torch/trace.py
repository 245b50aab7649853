"""Spans and counters of a solve, recorded while ``torch.profiler`` records.

Tracing is on exactly while a ``torch.profiler`` session records (for
instance ``solve(..., profile=dir)``, or an operator's own
``with torch.profiler.profile(): ...``); there is no other switch.  Off,
:func:`span` returns one shared null context and :func:`count` returns
at once, so a span site costs one test of the profiler's state.

On, each span is a profiler event named ``emg3d.<name>`` in the same
trace and on the same clock as the device's kernels and copies, and is
kept in memory with its start and end (``time.perf_counter_ns``), the
index of its parent span and the id of the solve it belongs to: every
span of one ``solve`` or ``solve_batched`` call shares one id.  Counters
are ``{name: int}``.  Nothing here synchronizes the device or allocates
device memory: a span that ends at a blocking fetch includes its wait.
The record keeps what every profiled window added until :func:`reset`.
The profiler's state is per thread: a solve records on the thread whose
session records, not in a worker thread it starts (``Simulation``'s).

The spans of a solve (:mod:`.solver`, :mod:`.parallel.halo`):

- ``solve``: one ``solve`` or ``solve_batched`` call; opens a solve id.
- ``solve.setup``: from the entry to the first cycle, with its children
  ``setup.upload`` (the source placed on the device from its nonzero
  edges or copied there whole, and a warm start's field copied), ``setup.norm`` (the source's norm: on the device with one
  fetch; on the host in a sharded solve), ``setup.volume_model`` (η and
  ζ: derived on the device from the model's properties, which are
  copied there; on the host in a sharded or batched solve),
  ``setup.zero_field`` (the zero start field: ``torch.zeros`` on the
  device; on the host in a sharded solve) and ``setup.levels`` (a level
  hierarchy: widths and transfer weights copied to the device, the
  coarse levels computed; a semicoarsening schedule builds one per
  direction, the later ones inside the cycles, sharing the first one's
  finest level).
- ``mg.cycle``: one top-level multigrid cycle; ``krylov.iter``: one
  step of a Krylov loop (of GCROT(m,k), an outer cycle).
- ``levels.state``: a smoother state built (lazily, in the first
  cycles); ``smooth.point``, ``smooth.line``: one point or line
  smoothing call.
- ``sync``: one blocking device→host fetch (a norm, an inner product,
  a fetch of per-lane or packed scalars, a returned field component).
- ``solve.result``: the solution fetched and handed back.

The spans of a survey (:mod:`.simulations`), around and beside its
solves:

- ``survey.compute``: one ``Simulation.compute()``;
- ``survey.grid``: a grid or a model built for a share key of the
  gridding (the model's ``interpolate2grid`` included);
- ``survey.sfield``: a source field built for one (source, frequency)
  pair;
- ``survey.responses``: the receivers' responses of one pair's field
  computed and stored in ``data.synthetic``.

Counters: ``copy.h2d_bytes``, the bytes of the fields, model
properties and level arrays the solve copies from host arrays to its
device; ``copy.d2h_bytes``, the bytes of the whole fields it fetches
back (scalar fetches are ``sync`` spans, not bytes);
``source.compact``, the sources (lanes) placed on the device from the
edges they touch, and ``source.dense``, those uploaded whole;
``setup.device_params``, the solves whose η and ζ were derived on their
device; ``levels.fine_shared``, the hierarchies that took the solve's
finest level from its first hierarchy without a copy;
``krylov.lane_iters``, the lanes a batched Krylov step computes, summed
over its steps, and ``krylov.settled_lane_iters``, those of them that
had already converged or broken down, whose results the step discards;
``survey.pairs``, the (source, frequency) pairs a survey computed,
``survey.batches``, its ``solve_batched`` calls, and
``survey.unbatched``, the pairs it sent to single solves.
"""
import contextlib
import itertools
import threading
import time

import torch

__all__ = ['PREFIX', 'enabled', 'span', 'each', 'count', 'nbytes',
           'spans', 'totals', 'counts', 'reset']

PREFIX = 'emg3d.'

_NULL = contextlib.nullcontext()
_on = torch.autograd._profiler_enabled
_clock = time.perf_counter_ns
# A function-scope profiler event: in the trace on the host's row, with
# no image on the device's rows (``record_function``, a user annotation,
# gets one there, which a reader of device activity takes for work).
_Event = torch._C._profiler._RecordFunctionFast

_SPANS = []         # [name, start_ns, end_ns, parent index, solve id]
_COUNTS = {}
_LOCK = threading.Lock()
_local = threading.local()
_solve_ids = itertools.count()


def enabled():
    """Whether spans and counters record: a profiler session records."""
    return _on()


def _stack():
    stack = getattr(_local, 'stack', None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ('name', 'new_solve', 'index', 'event')

    def __init__(self, name, new_solve):
        self.name = name
        self.new_solve = new_solve

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else -1
        if self.new_solve:
            solve = next(_solve_ids)
        else:
            solve = _SPANS[parent][4] if parent >= 0 else None
        self.event = _Event(PREFIX + self.name)
        self.event.__enter__()
        with _LOCK:
            self.index = len(_SPANS)
            _SPANS.append([self.name, _clock(), None, parent, solve])
        stack.append(self.index)
        return self

    def __exit__(self, *exc):
        _SPANS[self.index][2] = _clock()
        self.event.__exit__(*exc)
        stack = _stack()
        # Spans left open inside this one (a loop left by an exception)
        # close with it.
        while stack and stack.pop() != self.index:
            pass
        return False


def span(name, new_solve=False):
    """A context that records span ``name`` while the profiler records
    (``new_solve`` opens a new solve id), else a shared null context."""
    if not _on():
        return _NULL
    return _Span(name, new_solve)


def each(name, iterable=None):
    """``iterable`` (endless where None), each step inside a span
    ``name`` while the profiler records; the last step's span closes
    when the loop ends, by ``break`` and ``return`` too."""
    if iterable is None:
        iterable = itertools.count()
    if not _on():
        return iterable
    return _each(name, iterable)


def _each(name, iterable):
    for item in iterable:
        with _Span(name, False):
            yield item


def count(name, n):
    """Add ``n`` to counter ``name`` while the profiler records."""
    if _on():
        with _LOCK:
            _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def nbytes(tensors):
    """The bytes of the tensors' elements."""
    return sum(t.numel() * t.element_size() for t in tensors)


def spans():
    """The recorded spans in the order they opened: dicts of ``name``,
    ``start_ns``, ``end_ns`` (None while open), ``parent`` (an index
    into this list, or -1) and ``solve`` (the solve id, or None)."""
    return [dict(name=n, start_ns=a, end_ns=b, parent=p, solve=s)
            for n, a, b, p, s in list(_SPANS)]


def totals():
    """Per span name: ``calls``, ``ns`` (their summed durations) and
    ``self_ns`` (the durations less the parts their child spans
    cover), over the closed spans."""
    rec = list(_SPANS)
    child_ns = [0] * len(rec)
    for name, a, b, p, _ in rec:
        if b is not None and p >= 0:
            child_ns[p] += b - a
    out = {}
    for i, (name, a, b, _, _) in enumerate(rec):
        if b is None:
            continue
        t = out.setdefault(name, {'calls': 0, 'ns': 0, 'self_ns': 0})
        t['calls'] += 1
        t['ns'] += b - a
        t['self_ns'] += b - a - child_ns[i]
    return out


def counts():
    """The counters: ``{name: int}``."""
    return dict(_COUNTS)


def reset():
    """Forget every recorded span and counter (call it while no span is
    open)."""
    with _LOCK:
        _SPANS.clear()
        _COUNTS.clear()
