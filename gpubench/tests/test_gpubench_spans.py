"""The reduction of a trace, on synthetic events: the window, the busy
time, each smoothing call's device time, and the idle gaps named by the
innermost span open in them, of the harness's annotations and the
program's own ``emg3d.`` spans."""
import pytest

from gpubench.spans import Event, name_gaps, reduce_events


def _host(name, start, end, corr=0, thread=1):
    return Event(name, False, start, end, corr, thread)


def _device(name, start, end, corr=0):
    return Event(name, True, start, end, corr, 0)


# Two jobs, 0-1000 and 1100-2000 ns.  In the first, the device idles
# inside the solve's upload (200-350), inside a smoothing call that
# launches one kernel (700-720), and in no span but the job's own
# (900-990); the jobs are 100 ns apart.
EVENTS = [
    _host('gpubench.job', 0, 1000),
    _host('gpubench.solve', 100, 900),
    _host('emg3d.solve', 110, 890),
    _host('emg3d.solve.setup', 115, 600),
    _host('emg3d.setup.upload', 120, 360),
    _host('emg3d.mg.cycle', 610, 880),
    _host('emg3d.smooth.line', 700, 800),
    _host('gpubench.line#0', 705, 795),
    _host('cudaLaunchKernel', 710, 712, corr=7),
    _host('gpubench.job', 1100, 2000),
    _device('copy', 0, 200),
    _device('Memcpy HtoD', 350, 600),
    _device('point', 600, 700),
    _device('kernel', 720, 900, corr=7),
    _device('fill', 990, 1000),
    _device('kernel2', 1100, 2000),
    # The program's spans outside the jobs, and a device-side image of
    # one, as a trace might hold them: no work, no window.
    _host('emg3d.sync', -500, -100),
    _host('emg3d.solve', 2100, 2300),
    _device('emg3d.solve.result', 1000, 1100),
]


@pytest.fixture(scope='module')
def reduced():
    return reduce_events(EVENTS, 1)


def test_program_spans_add_no_work_and_move_no_window(reduced):
    assert reduced['window_s'] == 2000 / 1e9
    assert reduced['busy_s'] == (200 + 250 + 100 + 180 + 10 + 900) / 1e9
    assert reduced['call_device_s'] == [180 / 1e9]
    assert reduced['device_events'] == 6
    assert reduced['events']['program'] == 7
    assert all(not op.startswith('emg3d.') for op, _ in
               reduced['device_ops'])


def test_gaps_named_by_the_innermost_span(reduced):
    assert reduced['idle_gaps'] == [['emg3d.setup.upload', 150 / 1e9],
                                    ['outside the jobs', 100 / 1e9],
                                    ['job', 90 / 1e9], ['line', 20 / 1e9]]


def test_name_gaps():
    spans = [(0, 1000, 'gpubench.job'), (100, 900, 'gpubench.solve'),
             (110, 890, 'emg3d.solve'), (120, 360, 'emg3d.setup.upload'),
             (700, 800, 'emg3d.smooth.line'), (705, 795, 'gpubench.line#3')]
    assert name_gaps([(150, 250), (950, 990), (1010, 1090), (720, 760),
                      (400, 500)], spans) == [
        ['emg3d.setup.upload', 100 / 1e9], ['job', 40 / 1e9],
        ['outside the jobs', 80 / 1e9], ['line', 40 / 1e9],
        ['emg3d.solve', 100 / 1e9]]


def test_name_gaps_shorter_span_at_a_tie():
    spans = [(0, 1000, 'gpubench.job'), (0, 500, 'emg3d.solve')]
    assert name_gaps([(100, 200)], spans) == [['emg3d.solve', 100 / 1e9]]


def test_no_reading_without_jobs_or_device_work():
    assert reduce_events([e for e in EVENTS if e.name != 'gpubench.job'],
                         1) is None
    assert reduce_events([e for e in EVENTS if not e.device
                          or e.name.startswith('emg3d.')], 1) is None
