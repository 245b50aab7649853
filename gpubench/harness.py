"""One run of one cell: set-up, a measured window of whole jobs, the
check of what the window produced, and the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``
and ``workloads/<cell>.json``, its configuration in
``configs/<config>.json``, its job kind in ``jobs/<kind>.py`` and every
metric's reader in ``metrics/<metric>.py``.  Adding a configuration, a
cell, a job kind or a metric adds files and edits none.  A job kind that
keeps the contract in ``jobs/__init__.py`` (the solver reached only
through ``solver.solve`` or ``solver.solve_batched``; ``residual`` and
``residual_gap`` over every pair it keeps) is held by the fault and
control tests of ``tests/`` as it is added, whichever of the two entries
its jobs reach.
"""
import importlib
import json
import math
import os
import resource
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from . import spans
from .traffic import Traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ('jax', 'jaxlib', 'flax', 'emg3d_tpu')


class RunError(Exception):
    """A run that cannot give a result; the message goes to stderr."""


def process_age():
    """Seconds since this process started (from /proc)."""
    ticks = os.sysconf('SC_CLK_TCK')
    with open('/proc/self/stat') as f:
        start = int(f.read().rsplit(')', 1)[1].split()[19])
    with open('/proc/uptime') as f:
        up = float(f.read().split()[0])
    return up - start / ticks


def load_cell(name):
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    if not any(w['name'] == name for w in bench['workloads']):
        raise RunError(f"no cell {name!r} in BENCHMARK.json")
    workload = json.loads((HERE / 'workloads' / f'{name}.json').read_text())
    config = json.loads(
        (HERE / 'configs' / f"{workload['config']}.json").read_text())
    return bench, workload, config


def metrics_of(bench, cell, traced):
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    group = bench['per_layer'] if traced else bench['end_to_end']
    return [m for m in group if cell in m.get('workloads', [cell])]


def banned_modules():
    return sorted({m.split('.')[0] for m in sys.modules}
                  & set(BANNED))


def _pin_caches():
    """Build and kernel caches of anything the run loads stay in fixed
    folders of the checkout."""
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton')):
        os.environ[var] = str(ROOT / 'build' / 'gpubench' / sub)


def _device(chips, rehearse):
    import torch
    if rehearse:
        return torch, 'cpu', {'platform': 'cpu', 'kind': 'cpu', 'count': 0}
    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} cards; "
                       f"{torch.cuda.device_count()} visible")
    return torch, 'cuda', {'platform': 'gpu',
                           'kind': torch.cuda.get_device_name(0),
                           'count': chips}


def _keep(kept, result, j, limit, rng):
    """Reservoir sample of ``limit`` jobs' outputs, drawn from the seed."""
    if len(kept) < limit:
        kept.append(result['keep'])
    else:
        i = int(rng.integers(0, j + 1))
        if i < limit:
            kept[i] = result['keep']


def run(cell, seed, seconds, trace=False, rehearse=False, log=sys.stderr):
    """One run; returns the result dict (the line the harness prints).

    ``rehearse`` runs the same steps on the CPU at 8³ cells per axis with
    the port's plain smoothers, one timed job: a result with the checks
    and no metric and no device."""
    _pin_caches()
    bench, workload, config = load_cell(cell)
    torch, device, dev_info = _device(int(workload['chips']), rehearse)
    cuda = device == 'cuda'
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    kind = importlib.import_module(f"gpubench.jobs.{workload['kind']}")
    traffic = Traffic(workload['traffic'], seed)

    prep = kind.prepare(config, workload, device, rehearse)
    null = spans.NullRecorder()
    kind.run(prep, traffic.warmup(), null)          # warm-up, every shape
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_age()

    rec = spans.Recorder(sync).install() if trace else null
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    max_jobs = 1 if rehearse else int(workload.get('trace', {}).get(
        'max_jobs', 0)) if trace else 0
    rng = np.random.default_rng([int(seed), 3])
    limit = int(workload['check']['jobs'])
    kept, pairs, failed, jobs, walls, host = [], 0, 0, 0, [], []
    use0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    try:
        while True:
            with rec.span('job'):
                result = kind.run(prep, traffic.job(jobs), rec)
                sync()
            walls.append(time.perf_counter() - t0 - sum(walls))
            if 'host_s' in result:
                host.append(result['host_s'])
            pairs += result['pairs']
            failed += sum(not c for c in result['converged'])
            _keep(kept, result, jobs, limit, rng)
            jobs += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds or (max_jobs and jobs >= max_jobs
                                      and (jobs >= 2 or rehearse)):
                break
        window_s = time.perf_counter() - t0
        use1 = resource.getrusage(resource.RUSAGE_SELF)
        print(f"gpubench: window cpu {use1.ru_utime - use0.ru_utime:.2f} s "
              f"user, {use1.ru_stime - use0.ru_stime:.2f} s system, "
              f"{use1.ru_nivcsw - use0.ru_nivcsw} involuntary switches, "
              f"load {os.getloadavg()[0]:.2f}, threads "
              f"{torch.get_num_threads()}", file=log)
    finally:
        if trace:
            prof.__exit__(None, None, None)
            rec.uninstall()
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if host:
        # The host's speed through the window: the same host-only work
        # in every job of every run.
        print(f"gpubench: host witness {np.median(host):.4f} s a job "
              f"({min(host):.4f}-{max(host):.4f})", file=log)
    t1 = time.perf_counter()
    readings = spans.reduce_trace(prof, len(rec.calls)) if trace else None
    if trace:
        print(f"gpubench: trace {readings and readings['events']}, device "
              f"events {readings and readings['device_events']}, "
              f"correlated {readings and readings['correlated']}, reduced "
              f"in {time.perf_counter() - t1:.1f} s", file=log)
    del prof, result
    if cuda:
        torch.cuda.empty_cache()

    t1 = time.perf_counter()
    numbers = kind.check(prep, kept, device)
    print(f"gpubench: {jobs} jobs in {window_s:.3f} s (each "
          f"{', '.join(f'{w:.3f}' for w in walls)} s), {len(kept)} checked "
          f"in {time.perf_counter() - t1:.1f} s", file=log)
    limits = _limits(config, workload, numbers)
    checks = {k: {'value': v, 'limit': limits[k]} for k, v in numbers.items()}
    correct = failed == 0 and all(
        math.isfinite(c['value']) and c['value'] <= c['limit']
        for c in checks.values())
    found = banned_modules()
    if found:
        raise RunError(f"modules loaded that the run may not load: {found}")
    out = {'correct': bool(correct), 'attempted': pairs, 'failed': failed}
    state = SimpleNamespace(
        cell=cell, jobs=jobs, pairs=pairs, window_s=window_s,
        setup_s=setup_s, window_peak_bytes=window_peak, recorder=rec,
        trace=readings)
    if rehearse:
        out['rehearsal'] = {'jobs': jobs, 'spans': dict(getattr(
            rec, 'host', {})), 'calls': len(getattr(rec, 'calls', ()))}
        out['checks'] = checks
        return out
    metrics = {}
    for m in metrics_of(bench, cell, trace):
        reader = importlib.import_module(f"gpubench.metrics.{m['name']}")
        value = reader.read(state)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    dev_info['memory_peak_bytes'] = int(max(setup_peak, window_peak))
    out.update(metrics=metrics, device=dev_info)
    if trace and readings is not None:
        dev_info['busy_s'] = readings['busy_s']
        dev_info['window_s'] = readings['window_s']
        out['breakdown'] = {'device_ops': readings['device_ops'],
                            'idle_gaps': readings['idle_gaps']}
    out['checks'] = checks
    return out


def _limits(config, workload, numbers):
    """Each compared number's limit: the residual's is the tolerance the
    configuration states; the others' are set in the workload file."""
    out = {}
    for name in numbers:
        if name == 'residual':
            out[name] = float(config['solver']['tol'])
        else:
            out[name] = float(workload['check'][name])
    return out


def print_checks(out, stream=sys.stderr):
    """Each compared number beside its limit, as the last lines of
    standard error."""
    for name, c in out.get('checks', {}).items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=stream)
