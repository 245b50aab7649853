#!/usr/bin/env python3
"""The probes tile_roll, tile_copy, smem_sum, station_solve and
smem_limit timed in turns with their library calls, for this checkout's
kernels and, beside them, another checkout's.

    python3 probe_turns.py [--against DIR]

Runs ``chip_smoke.probe_turns`` (phase 14's timing: kernel, library,
library, kernel, at the probes' shapes and where bytes decide) on this
checkout's ``emg3d_tpu_torch/ops/probes.py`` and, with ``--against``, on
DIR's: another checkout unpacked there (``git archive REV | tar -x -C
build/REV``), whose probe kernels build from DIR's sources into
DIR/build.  A large shape that DIR's wrapper or kernel refuses (a
ValueError, or the RuntimeError of a refused launch) is recorded as
refused, with its message.  DIR's ``smem_limit`` may be the one from
before it computed probe_vmem's function (``smem_limit(nbytes)``, a fill
and sum of N bytes): it is then timed alone, as a different function.
Both in one process on one card, DIR's first.  Each reading carries the
launch floor read in its call.  Prints the card's name and power limit,
then one JSON line ``{"against": ..., "this": ...}``.  Needs one card
and no network.
"""
import argparse
import importlib
import json
import sys
import types
from pathlib import Path

import chip_smoke


def load_probes(root):
    """``ops/probes.py`` of the checkout at ``root``, as a module apart
    from this checkout's (its ``_build`` builds into root/build)."""
    name = '_against_ops'
    pkg = types.ModuleType(name)
    pkg.__path__ = [str(Path(root).resolve() / 'emg3d_tpu_torch' / 'ops')]
    sys.modules[name] = pkg
    return importlib.import_module(name + '.probes')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--against', help='another checkout to time beside')
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_turns.py: no CUDA card", file=sys.stderr)
        return 1
    from emg3d_tpu_torch.ops import probes
    out = {}
    if args.against:
        other = load_probes(args.against)
        large = []
        dev = torch.device('cuda')
        calls = {
            'tile_roll': lambda: other.tile_roll(torch.zeros(
                chip_smoke.ROLL_LARGE, device=dev), 1, 1),
            'tile_copy': lambda: other.tile_copy(torch.zeros(
                chip_smoke.COPY_LARGE[0], device=dev),
                *chip_smoke.COPY_LARGE[1][0]),
            'smem_sum': lambda: other.smem_sum(torch.zeros(
                chip_smoke.SUM_LARGE[0], device=dev),
                *chip_smoke.SUM_LARGE[1:]),
            'station_solve': lambda: other.station_solve(torch.zeros(
                (40,) + chip_smoke.STATION_LARGE, device=dev))}
        for key, call in calls.items():
            try:
                call()
                large.append(key)
            except (ValueError, RuntimeError) as err:
                out.setdefault('refused', {})[key + '_large'] = str(err)
                # A refused cudaFuncSetAttribute stays the library's last
                # error (its own static cudart): clear it with a call
                # that reads it (smem_limit's C entry, in either
                # signature) before DIR's next launch.
                if hasattr(other, 'smem_limit_plain'):
                    other.smem_limit(torch.zeros(chip_smoke.smem_rows(0),
                                                 device=dev), 48 * 1024)
                else:
                    other.smem_limit(1024)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        out['against'] = chip_smoke.probe_turns(torch, other, large)
    out['this'] = chip_smoke.probe_turns(torch, probes)
    for who in ('against', 'this'):
        chip_smoke.log_turns(out.get(who, {}), who + ' ')
    print(chip_smoke.nvidia_smi())
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
