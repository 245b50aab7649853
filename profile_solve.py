#!/usr/bin/env python3
"""Device profile of one warm solve of emg3d_tpu_torch on a CUDA card.

    python3 profile_solve.py [--mode factored|fused|plain] [--sclr]
                             [--ssl bicgstab|cgs] [--plan PLAN]
                             [--kernel factored|fused]
                             [--compare-plans] [--out DIR]

Solves the 64³ configuration of ``bench.py`` (64³ cells of 100 m,
1 Ω·m, 1 Hz x-source at the centre, F-cycles to tol 1e-6) twice to
warm up, once more on the host clock alone, and once under
``torch.profiler`` with CPU and CUDA activities.  ``--mode`` pins the
point-smoother kernel, or runs the plain torch smoothers; by default
the solver picks.  ``--sclr`` solves with semicoarsening and line
relaxation (the production configuration), ``--ssl`` wraps the
multigrid in BiCGSTAB or CGS.  ``--plan`` forces one launch plan of
the point kernels on every level (``point_gs.FORCE_PLAN``), ``--kernel``
one point kernel on every level that admits it
(``point_gs.FORCE_KERNEL``); ``--compare-plans`` then also times warm
solves with ``point_kernel``'s choice and with K1 forced, in turns,
three each (host walls move between processes; compare within one).
Prints:

- the warm wall time (host clock, ending in a synchronize), without
  and with the profiler;
- device busy time, the union of the trace's kernel, memcpy and memset
  intervals, and the idle share 1 − busy / profiled wall;
- device time and count per kernel name (top 12) and per copy kind,
  and the device time of the point kernels (K1 and K2, every plan;
  their sum) and of the line-residual kernel (K3);
- the smoother kernels' launches (and the point kernels' colour steps)
  of the profiled solve, and the host seconds of the unprofiled warm
  solve
  spent building line states (rotated parameters and block-Thomas
  factor stacks);
- the card's name and power limit.

The Chrome trace goes to ``DIR/trace.json`` (default
``build/profile``).
"""
import argparse
import json
import re
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
# The point kernels' instances in the trace (demangled or not): the last
# template argument is the kernel, 0 for K1, 1-2 for K2.
POINT_KERNEL = re.compile(r'point_gs_(?:sweep<\d+, ?(\d)>|step<(\d)>|'
                          r'sweepILi\dELi(\d)E|stepILi(\d)E)')


def busy_union(intervals):
    """Total length of the union of (start, end) intervals."""
    busy, end = 0.0, float('-inf')
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--mode', choices=('factored', 'fused', 'plain'))
    ap.add_argument('--sclr', action='store_true')
    ap.add_argument('--ssl', choices=('bicgstab', 'cgs'), default=False)
    ap.add_argument('--plan', choices=('step', 'cluster', 'grid', 'shared'))
    ap.add_argument('--kernel', choices=('factored', 'fused'))
    ap.add_argument('--compare-plans', action='store_true')
    ap.add_argument('--out', default=str(ROOT / 'build' / 'profile'))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_solve: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import LineStateClock, bench_problem, nvidia_smi
    from emg3d_tpu_torch import solve
    from emg3d_tpu_torch.ops import line_gs, point_gs

    point_gs.FORCE_PLAN = args.plan
    point_gs.FORCE_KERNEL = args.kernel
    grid, model, sfield = bench_problem()
    kw = dict(cycle='F', tol=1e-6, verb=0, return_info=True,
              device='cuda', _mode=args.mode, sslsolver=args.ssl,
              semicoarsening=args.sclr, linerelaxation=args.sclr)

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, info = solve(grid, model, sfield, **kw)
        torch.cuda.synchronize()
        if info['exit_message'] != 'CONVERGED':
            raise AssertionError(info['exit_message'])
        return time.perf_counter() - t0, info

    for _ in range(2):
        timed()
    with LineStateClock() as clock:
        wall, info = timed()
    if args.compare_plans:
        walls = {'K1 forced': [], 'point_kernel': []}
        for _ in range(3):
            for name, kernel in (('K1 forced', 'factored'),
                                 ('point_kernel', None)):
                point_gs.FORCE_KERNEL = kernel
                walls[name].append(timed()[0])
        point_gs.FORCE_KERNEL = args.kernel
        print("warm walls, K1 forced / point_kernel's choice, in turns: "
              + " / ".join(", ".join(f"{w:.4f}" for w in walls[k])
                           for k in walls) + " s")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    point_gs.reset_launches()
    line_gs.reset_launches()
    with torch.profiler.profile(activities=acts) as prof:
        wall_prof, _ = timed()
    launches = {**point_gs.LAUNCHES, **line_gs.LAUNCHES,
                'factored steps': point_gs.STEPS['factored'],
                'fused steps': point_gs.STEPS['fused']}

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace = out / 'trace.json'
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())['traceEvents']
              if e.get('ph') == 'X' and e.get('cat') in DEVICE_CATS]
    busy = busy_union([(e['ts'], e['ts'] + e['dur']) for e in events]) / 1e6
    per = defaultdict(lambda: [0.0, 0])
    for e in events:
        key = e['name'] if e['cat'] == 'kernel' else f"[{e['cat']}] " \
            f"{e['name']}"
        per[key][0] += e['dur'] / 1e3
        per[key][1] += 1

    print(f"mode {args.mode or 'default'}, sclr {args.sclr}, sslsolver "
          f"{args.ssl}: it_mg {info['it_mg']}, it_ssl {info['it_ssl']}, "
          f"warm wall {wall:.4f} s; profiled wall {wall_prof:.4f} s")
    print(f"device busy {busy:.4f} s over {len(events)} device events; "
          f"idle share {1 - busy / wall_prof:.4f}")
    print(f"smoother launches {launches}; line-state builds "
          f"{clock.seconds:.4f} s ({clock.builds} builds) of the "
          f"unprofiled warm wall")
    ranked = sorted(per.items(), key=lambda kv: -kv[1][0])
    copies = [kv for kv in ranked if kv[0].startswith('[')]
    kernels = [kv for kv in ranked if not kv[0].startswith('[')]
    for name, (ms, n) in kernels[:12] + copies:
        print(f"  {ms:9.3f} ms {n:6d}x  {name[:90]}")
    # Kernel names as the trace gives them, demangled or not.
    point = {'K1 point_gs_factored': [], 'K2 point_gs_fused': []}
    for name, v in kernels:
        m = POINT_KERNEL.search(name)
        if m:
            code = int(next(g for g in m.groups() if g is not None))
            point['K1 point_gs_factored' if code == 0
                  else 'K2 point_gs_fused'].append(v)
    point['K3 line_residual'] = [v for k, v in kernels
                                 if 'line_residual' in k]
    for label, hit in point.items():
        print(f"{label}: {sum(ms for ms, _ in hit):.3f} ms device time "
              f"over {sum(n for _, n in hit)} launches")
    both = point['K1 point_gs_factored'] + point['K2 point_gs_fused']
    print(f"point kernels K1 + K2: {sum(ms for ms, _ in both):.3f} ms "
          f"device time over {sum(n for _, n in both)} launches")
    print(f"trace: {trace}")
    print(nvidia_smi())
    return 0


if __name__ == '__main__':
    sys.exit(main())
