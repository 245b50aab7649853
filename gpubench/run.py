#!/usr/bin/env python3
"""Run one cell of the benchmark of emg3d_tpu_torch once, on the card.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>
    python3 gpubench/run.py --workload <cell> --seed <n> --rehearse

From the root of a checkout.  Sets up the cell (its inputs from the
seed, one warm-up job of its own shapes), runs whole jobs for
``--seconds``, checks what they produced against the plain reference,
and prints one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics from a profiled window), ``device``, with ``--trace
1`` ``breakdown``, and last ``checks``: each compared number and its
limit, also the last lines of standard error.  Exits 1 without a result
on a machine with no CUDA card or too few, or if the process has loaded
JAX or the JAX package.  ``--rehearse`` runs one job at 8³ on the CPU
through the port's plain smoothers and prints its checks, no metric.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, default=10.0)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--rehearse', action='store_true')
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from gpubench import harness
    try:
        out = harness.run(args.workload, args.seed, args.seconds,
                          trace=bool(args.trace), rehearse=args.rehearse)
    except harness.RunError as err:
        print(f"gpubench: {err}", file=sys.stderr)
        return 1
    harness.print_checks(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
