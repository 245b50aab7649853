#!/usr/bin/env python3
"""Device profile of one warm solve of emg3d_tpu_torch on a CUDA card.

    python3 profile_solve.py [--plain] [--sclr]
                             [--ssl bicgstab|cgs] [--plan PLAN]
                             [--kernel factored|fused]
                             [--compare-plans] [--batched] [--complex64]
                             [--bf16] [--out DIR]

Solves the 64³ configuration of ``bench.py`` (64³ cells of 100 m,
1 Ω·m, 1 Hz x-source at the centre, F-cycles to tol 1e-6) twice to
warm up, once more on the host clock alone, and once under
``torch.profiler`` with CPU and CUDA activities.  ``--plain`` runs every
op's plain torch version (``ops._build.PLAIN``).  ``--sclr`` solves
with semicoarsening and line relaxation (the production configuration),
``--ssl`` wraps the multigrid in BiCGSTAB or CGS.  ``--plan`` forces
one launch plan of the point kernels on every level
(``point_gs.FORCE_PLAN``), ``--kernel`` one point kernel on every level
that admits it
(``point_gs.FORCE_KERNEL``); ``--compare-plans`` then also times warm
solves with ``point_kernel``'s choice and with K1 forced, in turns,
three each (host walls move between processes; compare within one).
``--batched`` profiles instead the batched solve of ``chip_smoke.py``'s
phase 10: its 4 sources × 2 frequencies on the same 64³ fullspace
(``chip_smoke.simulation_problem``) as one ``solve_batched`` of 8 lanes,
with semicoarsening, line relaxation and BiCGSTAB (the Simulation's
default; ``--ssl cgs`` takes CGS).  ``--complex64`` casts the sources
to complex64: the solve then runs in complex64/float32 with the two-float
cycles and Krylov refinement (K6 ``residual_ds`` listed beside K1-K5),
with float32 storage; ``--bf16`` does the same with the bfloat16 storage
a complex64 solve takes on the card by default
(``solver.BF16_STORAGE``: s/params streams in correction-form cycles,
line-factor stacks above ``solver.FSTACK_BYTES``; the batched solve
stores none).  The launches of the kernels' ``_bf16`` instances are
printed beside all launches.
Prints:

- the warm wall time (host clock, ending in a synchronize), without
  and with the profiler;
- device busy time, the union of the trace's kernel, memcpy and memset
  intervals, and the idle share 1 − busy / profiled wall;
- device time and count per kernel name (top 12) and per copy kind,
  and the device time and launches of each of the package's kernels
  (K1-K5; the point kernels under every plan) and of K1 + K2;
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
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--plain', action='store_true')
    ap.add_argument('--sclr', action='store_true')
    ap.add_argument('--ssl', choices=('bicgstab', 'cgs'), default=False)
    ap.add_argument('--plan', choices=('step', 'cluster', 'grid', 'shared'))
    ap.add_argument('--kernel', choices=('factored', 'fused'))
    ap.add_argument('--compare-plans', action='store_true')
    ap.add_argument('--batched', action='store_true')
    ap.add_argument('--complex64', action='store_true')
    ap.add_argument('--bf16', action='store_true')
    ap.add_argument('--out', default=str(ROOT / 'build' / 'profile'))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_solve: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (DSRES, KERNELS, _c64_source, bench_problem,
                            kernel_key, line_state_clock, nvidia_smi,
                            simulation_problem, trace_times)
    from emg3d_tpu_torch import get_source_field, solve, solve_batched, solver
    from emg3d_tpu_torch.ops import _build, dsres, line_gs, point_gs

    args.complex64 = args.complex64 or args.bf16
    solver.BF16_STORAGE = None if args.bf16 else False
    point_gs.FORCE_PLAN = args.plan
    point_gs.FORCE_KERNEL = args.kernel
    _build.PLAIN = args.plain
    kw = dict(cycle='F', tol=1e-6, verb=0, device='cuda', sslsolver=args.ssl,
              semicoarsening=args.sclr, linerelaxation=args.sclr)
    if args.batched:
        grid, model, survey = simulation_problem()
        sfields = [get_source_field(grid, src.coordinates, f)
                   for src in survey.sources.values()
                   for f in survey.frequencies]
        kw.update(semicoarsening=True, linerelaxation=True,
                  sslsolver=args.ssl or 'bicgstab')
        if args.complex64:
            sfields = [_c64_source(f) for f in sfields]

        def run():
            return solve_batched(grid, model, sfields, **kw)[1]
    else:
        grid, model, sfield = bench_problem()
        if args.complex64:
            sfield = _c64_source(sfield)

        def run():
            return solve(grid, model, sfield, return_info=True, **kw)[1]

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = run()
        torch.cuda.synchronize()
        if info['exit_message'] != 'CONVERGED':
            raise AssertionError(info['exit_message'])
        return time.perf_counter() - t0, info

    for _ in range(2):
        timed()
    with line_state_clock() as clock:
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
    dsres.reset_launches()
    with torch.profiler.profile(activities=acts) as prof:
        wall_prof, _ = timed()
    launches = {**point_gs.LAUNCHES, **line_gs.LAUNCHES, **dsres.LAUNCHES,
                'factored steps': point_gs.STEPS['factored'],
                'fused steps': point_gs.STEPS['fused']}
    bf16_launches = {**point_gs.BF16_LAUNCHES, **line_gs.BF16_LAUNCHES}

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace = out / 'trace.json'
    busy, nev, per = trace_times(prof, trace)

    what = (f"batched {len(sfields)} lanes, sslsolver {kw['sslsolver']}"
            if args.batched else f"sclr {args.sclr}, sslsolver {args.ssl}")
    what += ', complex64' if args.complex64 else ''
    what += ', bf16 storage' if args.bf16 else ''
    print(f"mode {args.mode or 'default'}, {what}: it_mg {info['it_mg']}, "
          f"it_ssl {info['it_ssl']}, warm wall {wall:.4f} s; profiled wall "
          f"{wall_prof:.4f} s")
    print(f"device busy {busy:.4f} s over {nev} device events; "
          f"idle share {1 - busy / wall_prof:.4f}")
    print(f"smoother launches {launches} (bf16 instances "
          f"{bf16_launches}); line-state builds "
          f"{clock.seconds:.4f} s ({clock.calls} builds) of the "
          f"unprofiled warm wall")
    ranked = sorted(per.items(), key=lambda kv: -kv[1][0])
    copies = [kv for kv in ranked if kv[0].startswith('[')]
    kernels = [kv for kv in ranked if not kv[0].startswith('[')]
    for name, (ms, n) in kernels[:12] + copies:
        print(f"  {ms:9.3f} ms {n:6d}x  {name[:90]}")
    # Kernel names as the trace gives them, demangled or not.
    labels = dict(zip(KERNELS, ('K1', 'K2', 'K3', 'K4', 'K5')))
    hits = {k: [] for k in KERNELS}
    for name, v in kernels:
        k = kernel_key(name)
        if k is not None:
            hits[k].append(v)
    for k, hit in hits.items():
        print(f"{labels[k]} {KERNELS[k]['name']}: "
              f"{sum(ms for ms, _ in hit):.3f} ms device time over "
              f"{sum(n for _, n in hit)} launches")
    k6 = [v for name, v in kernels if DSRES['name'] in name]
    print(f"K6 {DSRES['name']}: {sum(ms for ms, _ in k6):.3f} ms device "
          f"time over {sum(n for _, n in k6)} launches")
    both = hits['factored'] + hits['fused']
    print(f"point kernels K1 + K2: {sum(ms for ms, _ in both):.3f} ms "
          f"device time over {sum(n for _, n in both)} launches")
    print(f"trace: {trace}")
    print(nvidia_smi())
    return 0


if __name__ == '__main__':
    sys.exit(main())
