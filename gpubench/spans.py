"""Spans and counters of a traced run, recorded from the benchmark's own
files, and the reduction of the profiler's trace.

A traced run wraps the program's entry points through their module
attributes (the program calls them so: ``solver.solve_batched``,
``solver.build_levels``, ``line_gs.line_state``, ...), so nothing in the
program changes.  Each wrapped call is a ``torch.profiler``
annotation ``gpubench.<kind>`` in the trace; the set-up and solve calls
also start and end in a synchronize and add their host seconds to their
kind.
The smoothing calls are not synchronized: their annotation (numbered)
marks which launches they made, and :func:`reduce_trace` adds the
device time of every kernel, copy and fill the profiler correlates with
those launches, whatever kernels the program uses.  The shapes of each
smoothing call are recorded at its entry point.  The device's idle gaps
are named by the innermost span open in them, of the annotations and
the program's own ``emg3d.`` spans (:func:`name_gaps`).
"""
import bisect
import contextlib
import time
from collections import Counter, defaultdict, namedtuple

__all__ = ['NullRecorder', 'Recorder', 'Event', 'reduce_trace',
           'reduce_events', 'name_gaps']

PREFIX = 'gpubench.'
# The program's own spans (``emg3d_tpu_torch.trace``): function-scope
# host events, read only to name the device's idle gaps.
PROGRAM_PREFIX = 'emg3d.'
# CUDA runtime and driver calls (cudaLaunchKernel, cuLaunchKernel,
# cudaMemcpyAsync, ...): the launches, copies and fills whose correlation
# ids the device events carry.
LAUNCH_PREFIX = 'cu'

# One event of a trace: on the device's rows or the host's, its start
# and end in ns, its correlation id and its thread.
Event = namedtuple('Event', 'name device start end corr thread')
# Any other host event (an operator, a runtime call that launches
# nothing): counted, not read.
_HOST = Event('', False, 0, 0, 0, 0)


class NullRecorder:
    """What an untraced run records: nothing."""

    @contextlib.contextmanager
    def span(self, kind):
        yield


class Recorder:
    """Host seconds per span kind, ``it_mg`` of every solve, and the
    shapes of every smoothing call, while installed."""

    def __init__(self, sync):
        import torch
        self._torch = torch
        self._sync = sync
        self.host = defaultdict(float)
        self.it_mg = []
        self.calls = []
        self._active = set()
        self._saved = []

    @contextlib.contextmanager
    def span(self, kind, sync=True, name=None):
        """The block as an annotation ``name`` (default gpubench.<kind>);
        with ``sync``, between two synchronizes, its host seconds added
        to ``kind``."""
        if kind in self._active:
            yield
            return
        self._active.add(kind)
        try:
            if sync:
                self._sync()
            t0 = time.perf_counter()
            with self._torch.profiler.record_function(name or PREFIX + kind):
                yield
                if sync:
                    self._sync()
            if sync:
                self.host[kind] += time.perf_counter() - t0
        finally:
            self._active.discard(kind)

    def _wrap(self, module, attr, kind, sync=True, on_call=None,
              on_result=None):
        real = getattr(module, attr)
        rec = self

        def wrapped(*a, **k):
            if kind in rec._active:
                return real(*a, **k)
            name = None
            if on_call is not None:
                name = f"{PREFIX}{kind}#{len(rec.calls)}"
                rec.calls.append(on_call(*a, **k))
            with rec.span(kind, sync, name):
                out = real(*a, **k)
            if on_result is not None:
                on_result(out)
            return out

        self._saved.append((module, attr, real))
        setattr(module, attr, wrapped)

    def _solve_info(self, out):
        info = out[-1] if isinstance(out, tuple) else out
        if isinstance(info, dict) and 'it_mg' in info:
            self.it_mg.append(int(info['it_mg']))

    def install(self):
        from emg3d_tpu_torch import solver
        from emg3d_tpu_torch.ops import line_gs, point_gs
        for attr in ('solve', 'solve_batched'):
            self._wrap(solver, attr, 'solve', on_result=self._solve_info)
        self._wrap(solver, 'build_levels', 'levels')
        self._wrap(line_gs, 'line_state', 'levels')
        self._wrap(point_gs, 'point_state', 'levels')
        self._wrap(line_gs, 'line_relaxation', 'line', sync=False,
                   on_call=_line_call)
        self._wrap(point_gs, 'gauss_seidel_point', 'point', sync=False,
                   on_call=_point_call)
        return self

    def uninstall(self):
        while self._saved:
            module, attr, real = self._saved.pop()
            setattr(module, attr, real)


def _nu(a, k):
    return int(k['nu'] if 'nu' in k else a[3])


def _line_call(*a, **k):
    """A line-relaxation call: its level in the frame whose x-lines are
    the lines (the state's shape), its sweeps, lanes, frequency groups
    (the η sums' leading axis of a lane state), element size, and
    whether it builds its factor stacks (a state that caches none)."""
    e, state = a[0], a[2]
    lanes = e[0].shape[0] if e[0].dim() == 4 else 1
    groups = state.st[0].shape[0] if lanes > 1 else 1
    return {'kind': 'line', 'shape': tuple(int(n) for n in state.shape),
            'nu': _nu(a, k), 'lanes': lanes, 'groups': groups,
            'size': e[0].element_size(), 'builds': state.factors is None}


def _point_call(*a, **k):
    """A point-relaxation call (one lane): its level shape from the
    edge arrays, sweeps and element size."""
    ex, ey, ez = a[0]
    shape = (ex.shape[-3], ey.shape[-2], ez.shape[-1])
    return {'kind': 'point', 'shape': tuple(int(n) for n in shape),
            'nu': _nu(a, k), 'lanes': 1, 'groups': 1,
            'size': ex.element_size(), 'builds': False}


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _clock(event):
    """Accessors of an event's start and length in ns (``start_ns`` /
    ``duration_ns`` where this torch has them, else the µs ones)."""
    if hasattr(event, 'start_ns'):
        return (lambda e: e.start_ns()), (lambda e: e.duration_ns())
    return (lambda e: int(e.start_us() * 1000)), \
        (lambda e: int(e.duration_us() * 1000))


def reduce_trace(prof, ncalls):
    """:func:`reduce_events` of a ``torch.profiler`` run (in memory, no
    file)."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    if not events:
        return None
    start, length = _clock(events[0])
    read = (PREFIX, PROGRAM_PREFIX, LAUNCH_PREFIX)
    plain = []
    for e in events:
        name = e.name()
        device = e.device_type() == DeviceType.CUDA
        if not device and not name.startswith(read):
            plain.append(_HOST)
            continue
        t0 = start(e)
        plain.append(Event(name, device, t0, t0 + length(e),
                           e.correlation_id(), e.start_thread_id()))
    return reduce_events(plain, ncalls)


def reduce_events(events, ncalls):
    """Readings of a trace's events (:class:`Event`, times in ns):

    - ``window_s``: from the start of the first ``gpubench.job``
      annotation to the end of the last;
    - ``busy_s``: the union of the kernel, copy and fill intervals in it;
    - ``call_device_s``: per smoothing call (annotation number), the
      device seconds of every operation correlated with a launch made
      inside its annotation, on its thread;
    - ``device_ops``: the 10 device operations that took most time;
    - ``idle_gaps``: the 10 longest idle stretches of the device in the
      window, each named by :func:`name_gaps` from the ``gpubench.``
      annotations and the program's ``emg3d.`` spans;
    - ``events``: counts of the events by kind (diagnostics).

    The program's spans only name gaps: they are no device work, do not
    bound the window and belong to no smoothing call.
    """
    ann, program, launches, dev = [], [], [], []
    kinds = Counter()
    for e in events:
        if e.name.startswith(PROGRAM_PREFIX):
            if not e.device:
                kinds['program'] += 1
                program.append((e.start, e.end, e.name))
            continue
        if e.device:
            # Kernels, copies and fills; the device-side images of the
            # annotations are no work.
            if not e.name.startswith(PREFIX):
                kinds['device'] += 1
                dev.append(e)
            continue
        if e.name.startswith(PREFIX):
            kinds['annotation'] += 1
            ann.append(e)
        elif e.name.startswith(LAUNCH_PREFIX):
            kinds['runtime'] += 1
            launches.append((e.start, e.corr, e.thread))
        else:
            kinds['host'] += 1
    jobs = [(e.start, e.end) for e in ann if e.name == PREFIX + 'job']
    if not jobs or not dev:
        return None
    w0, w1 = min(a for a, _ in jobs), max(b for _, b in jobs)
    busy_iv = _union((max(e.start, w0), min(e.end, w1)) for e in dev
                     if e.end > w0 and e.start < w1)
    busy = sum(b - a for a, b in busy_iv)
    by_corr = defaultdict(int)
    per_name = defaultdict(int)
    for e in dev:
        by_corr[e.corr] += e.end - e.start
        if e.end > w0 and e.start < w1:
            per_name[e.name] += e.end - e.start
    launches.sort()
    starts = [t for t, _, _ in launches]
    call_ns = [0] * ncalls
    matched = set()
    for e in ann:
        if '#' not in e.name:
            continue
        i = int(e.name.rsplit('#', 1)[1])
        lo = bisect.bisect_left(starts, e.start)
        hi = bisect.bisect_right(starts, e.end)
        for _, corr, t in launches[lo:hi]:
            if t == e.thread and corr in by_corr:
                call_ns[i] += by_corr[corr]
                matched.add(corr)
    # Idle stretches of the window, the ten longest named.
    gaps, t = [], w0
    for a, b in busy_iv:
        if a > t:
            gaps.append((a - t, t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((w1 - t, t, w1))
    gaps.sort(reverse=True)
    spans = [(e.start, e.end, e.name) for e in ann] + program
    ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    return {'window_s': (w1 - w0) / 1e9, 'busy_s': busy / 1e9,
            'call_device_s': [n / 1e9 for n in call_ns],
            'device_ops': [[name[:160], ns / 1e9] for name, ns in ops],
            'idle_gaps': name_gaps([(a, b) for _, a, b in gaps[:10]],
                                   spans),
            'events': dict(kinds),
            'device_events': len(dev),
            'correlated': len(matched)}


def name_gaps(gaps, spans):
    """``[name, seconds]`` of each gap ``(start, end)``, in ns: the
    innermost of the ``spans`` ``(start, end, name)`` open at the gap's
    midpoint, which is the last of them to open (the shorter at a tie).
    A ``gpubench.`` annotation gives its kind (``job``, ``solve``,
    ``line``, ...), a span of the program its whole name
    (``emg3d.mg.cycle``); with no span open the gap lies between the
    jobs (``outside the jobs``)."""
    out = []
    for a, b in gaps:
        mid = (a + b) // 2
        inner = [(s, -e, name) for s, e, name in spans if s <= mid <= e]
        if not inner:
            where = 'outside the jobs'
        else:
            where = max(inner)[2]
            if where.startswith(PREFIX):
                where = where.split('#')[0][len(PREFIX):]
        out.append([where, (b - a) / 1e9])
    return out
