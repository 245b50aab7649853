"""Roofline share of the smoothing calls of one kind: the sum of their
bounds (:mod:`gpubench.work`, from each call's recorded shapes) over the
sum of the device time of every operation launched inside them, in %."""
from .. import work


def share(run, kind):
    if run.trace is None:
        return None
    bound = device = 0.0
    for call, t in zip(run.recorder.calls, run.trace['call_device_s']):
        if call['kind'] != kind:
            continue
        if kind == 'line':
            bound += work.line_call_bound(call['shape'], call['nu'],
                                          call['size'], call['lanes'],
                                          call['groups'], call['builds'])
        else:
            bound += work.point_call_bound(call['shape'], call['nu'],
                                           call['size'])
        device += t
    if device <= 0:
        return None
    return 100.0 * bound / device
