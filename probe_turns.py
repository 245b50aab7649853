#!/usr/bin/env python3
"""tile_roll and tile_copy timed in turns with their library calls, for
this checkout's kernels and, beside them, another checkout's.

    python3 probe_turns.py [--against DIR]

Runs ``chip_smoke.probe_turns`` (phase 14's timing: kernel, library,
library, kernel, at the probes' shapes and where bytes decide) on this
checkout's ``emg3d_tpu_torch/ops/probes.py`` and, with ``--against``, on
DIR's: another checkout unpacked there (``git archive REV | tar -x -C
build/REV``), whose probe kernels build from DIR's sources into
DIR/build.  A large shape that DIR's wrapper refuses is recorded as
refused.  Both in one process on one card, DIR's first.  Prints the
card's name and power limit, then one JSON line ``{"against": ...,
"this": ...}``.  Needs one card and no network.
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
        for key, arg in (('tile_roll', lambda dev: (torch.zeros(
                chip_smoke.ROLL_LARGE, device=dev), 1, 1)),
                         ('tile_copy', lambda dev: (torch.zeros(
                             chip_smoke.COPY_LARGE[0], device=dev),
                             *chip_smoke.COPY_LARGE[1][0]))):
            try:
                getattr(other, key)(*arg(torch.device('cuda')))
                large.append(key)
            except ValueError as err:
                out.setdefault('refused', {})[key + '_large'] = str(err)
        torch.cuda.synchronize()
        out['against'] = chip_smoke.probe_turns(torch, other, large)
    out['this'] = chip_smoke.probe_turns(torch, probes)
    for who in ('against', 'this'):
        for key, r in out.get(who, {}).items():
            for sfx, d in r.items():
                chip_smoke.log(
                    f"{who} {key}{sfx} {d['shape']}: kernel {d['ms']:.4f} "
                    f"ms, library {d['library_ms']:.4f} "
                    f"({d['ms'] / d['library_ms']:.2f}×), bound "
                    f"{d['bound_ms']:.6f}, {d['share']:.1%} of it")
    print(chip_smoke.nvidia_smi())
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
