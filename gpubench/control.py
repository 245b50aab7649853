#!/usr/bin/env python3
"""Readings that set the limits of ``correct``: the program's on many
seeds and its lower-precision controls', at a cell's own size.

    python3 gpubench/control.py --workload <cell> --seeds S1 S2 ...
                                [--jobs N] [--controls K] [--out FILE]
                                [--emulated]

For each seed, runs ``N`` jobs of the cell (default: the number a run
checks) and reads every number the cell compares on what they produced
(the program's readings), then on two controls in single precision:

- ``single``: the same jobs through the program's own complex64 path
  (the x64 switch off) with its two-float accumulation and its
  bfloat16 storage switched off: complex64 arithmetic and storage
  throughout, the fields returned in
  complex64, on the first ``--controls`` seeds (default: all);
- ``cast``: the program's outputs rounded to complex64, the nearest
  answer single precision can hold, judged against what the solve
  reported for the unrounded field.

``--emulated`` also reads the complex64 path as it ships (x64 off,
with its emulation), which is built to reach the tolerance.  One
set-up serves every seed.  Prints one JSON line per seed and a summary:
per number the largest program reading (the lower reading), each
control's smallest reading (the upper reading) and the limit a run
holds it to.
"""
import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def single_precision(emulated=False):
    """The program's complex64 path (the x64 switch off); without
    ``emulated``, with its two-float accumulation switched off
    (``solver._ds_wanted``, the one switch it has) and every stream
    stored in float32 (``solver.BF16_STORAGE``) for the duration."""
    from emg3d_tpu_torch import dtypes, solver
    saved = solver._ds_wanted, solver.BF16_STORAGE
    if not emulated:
        solver._ds_wanted = lambda e, var: False
        solver.BF16_STORAGE = False
    try:
        with dtypes.x64(False):
            yield
    finally:
        solver._ds_wanted, solver.BF16_STORAGE = saved


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--jobs', type=int)
    ap.add_argument('--controls', type=int)
    ap.add_argument('--out')
    ap.add_argument('--emulated', action='store_true')
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from gpubench import harness, spans
    from gpubench.traffic import Traffic
    bench, workload, config = harness.load_cell(args.workload)
    torch, device, dev = harness._device(int(workload['chips']), False)
    kind = importlib.import_module(f"gpubench.jobs.{workload['kind']}")
    prep = kind.prepare(config, workload, device)
    null = spans.NullRecorder()
    jobs = args.jobs or int(workload['check']['jobs'])
    lines = []
    controls = len(args.seeds) if args.controls is None else args.controls
    for i, seed in enumerate(args.seeds):
        traffic = Traffic(workload['traffic'], seed)
        t0 = time.perf_counter()
        results = [kind.run(prep, traffic.job(j), null) for j in range(jobs)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kept = [r['keep'] for r in results]
        line = {'seed': seed, 'jobs': jobs, 'wall_s': wall,
                'converged': all(all(r['converged']) for r in results),
                'program': kind.check(prep, kept, device),
                'cast': kind.check(prep, kept, device, control=True)}
        for name, emulated in (('single', False), ('emulated', True)):
            if i >= controls or (emulated and not args.emulated):
                continue
            with single_precision(emulated):
                low = [kind.run(prep, traffic.job(j), null)
                       for j in range(jobs)]
            line[name] = kind.check(prep, [r['keep'] for r in low], device)
            line[name + '_converged'] = all(all(r['converged'])
                                            for r in low)
        print(json.dumps(line), flush=True)
        lines.append(line)
    limits = harness._limits(config, workload, lines[0]['program'])
    summary = {'workload': args.workload, 'device': dev, 'seeds': len(lines),
               'numbers': {k: {'lower': max(x['program'][k] for x in lines),
                               'limit': limits[k],
                               **{c: min(x[c][k] for x in lines if c in x)
                                  for c in ('single', 'cast', 'emulated')
                                  if c in lines[0]}}
                           for k in limits}}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps({'seeds': lines,
                                              'summary': summary}, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
