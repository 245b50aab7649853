"""Build the package's CUDA sources with nvcc and load them with ctypes.

The kernels in ``emg3d_tpu_torch/csrc/*.cu`` have a plain C interface,
so they build in seconds with ``nvcc`` alone (no PyTorch headers): one
``nvcc -c`` per source, all started together, then one link into a
shared library.  There are two libraries (``LIBRARIES``): the solve
kernels, and the probes, which no solve path runs and which therefore
build and load apart.  A library lands in ``build/emg3d_tpu_torch/``
beside the package, in a folder keyed by a hash of its sources, the
headers and the flags, so an edited source rebuilds and an unchanged
one is reused.  Nothing is compiled at import: the first kernel launch
builds.

One rule decides whether an op launches its kernel or runs its plain
PyTorch version: :func:`kernels`.  Every op that has both asks it.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ['library', 'build', 'entry', 'kernels', 'PLAIN', 'ARGTYPES',
           'PROBE_ARGTYPES', 'LIBRARIES', 'C64', 'BF16']

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_ROOT = Path(__file__).resolve().parents[2] / 'build' / 'emg3d_tpu_torch'
FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LIBS = {}   # the loaded libraries by name, once built

# True runs every op's plain PyTorch version, on the card too
# (comparisons on the card: chip_smoke.py, profile_solve.py --plain).
PLAIN = False


def kernels(x):
    """Whether an op on ``x`` (a tensor, or a device) launches its
    kernel: ``x`` is on a CUDA device and :data:`PLAIN` is off.  Where
    it is not, the op runs its plain PyTorch version."""
    import torch
    return not PLAIN and torch.device(getattr(x, 'device', x)).type == 'cuda'


_P = ctypes.c_void_p
_I = ctypes.c_int
# The C entry points of the solve library and their argument types; each
# returns a cudaError_t as int.  K1-K5 take complex128 tensors, their
# ``_c64`` twins (C64) the same in complex64, and their ``_bf16`` twins
# (BF16) complex64 with a bfloat16-stored stream: K1-K3 read s, the η
# sums and the ζ weights in bfloat16, K4 reads a bfloat16 factor stack
# and K5 writes one.  K6 is complex64 only; its last six ints are
# the launch plan (ops/dsres.py's ``tile_plan``).
_SOLVE = {
    'emg3d_point_gs_step': [_I] + [_P] * 16 + [_I] * 11 + [_P],
    'emg3d_point_gs_sweep': [_I] * 2 + [_P] * 16 + [_I] * 3 + [_P] * 3
                            + [_I] * 4 + [_P],
    'emg3d_point_gs_grid_capacity': [_I, _P],
    'emg3d_line_residual': [_P] * 19 + [_I] * 15 + [_P],
    'emg3d_line_thomas': [_P] * 9 + [_I] * 16 + [_P],
    'emg3d_line_factor': [_P] * 10 + [_I] * 6 + [_P],
}
C64 = '_c64'
BF16 = '_bf16'
ARGTYPES = {**_SOLVE, **{k + C64: v for k, v in _SOLVE.items()},
            **{k + BF16: v for k, v in _SOLVE.items()},
            'emg3d_residual_ds_c64': [_P] * 21 + [_I] * 11 + [_P]}
# The same for the probe library (csrc/probes.cu).
PROBE_ARGTYPES = {
    'emg3d_probe_tile_copy': [_P] + [_I] * 18 + [_P],
    'emg3d_probe_smem_limit': [_P] + [_I] * 3 + [_P] * 2,
    'emg3d_probe_smem_optin': [_P],
    'emg3d_probe_smem_sum': [_P] * 2 + [_I] * 10 + [_P],
    'emg3d_probe_tile_roll': [_P] * 2 + [_I] * 4 + [_P],
    'emg3d_probe_dyn_slice': [_P] * 3 + [_I] * 5 + [_P],
    'emg3d_probe_station_solve': [_P] * 2 + [_I] * 3 + [_P],
}
# name: (file name, sources in csrc/, entry points).
LIBRARIES = {
    'solve': ('libemg3d_tpu_torch.so', ('line_gs.cu', 'point_gs.cu',
                                        'dsres.cu'), ARGTYPES),
    'probes': ('libemg3d_tpu_torch_probes.so', ('probes.cu',),
               PROBE_ARGTYPES),
}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, 'bin', 'nvcc'))
    found = shutil.which('nvcc')
    if found:
        cands.append(found)
    for c in cands:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (CUDA_HOME or PATH): the CUDA "
                       "kernels of emg3d_tpu_torch cannot be built.")


def _sources(name='solve'):
    srcs = [CSRC / f for f in LIBRARIES[name][1]]
    missing = [p for p in srcs if not p.is_file()]
    if missing:
        raise RuntimeError(f"CUDA sources missing: {missing}")
    return srcs


def build(name='solve'):
    """Compile library ``name``'s sources (if not yet built); return
    (path, log).

    ``log`` is nvcc's output, with ptxas' register and spill report
    per kernel.
    """
    libname = LIBRARIES[name][0]
    srcs = _sources(name)
    h = hashlib.sha256(' '.join(FLAGS).encode())
    for p in srcs + sorted(CSRC.glob('*.cuh')):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / libname
    log = out_dir / 'nvcc.log'
    if lib.is_file():
        return lib, log.read_text() if log.is_file() else ''
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # Build in a temporary folder and rename the library into place:
    # concurrent processes never load a half-written one.
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, p.stem + '.o') for p in srcs]
        cmds = [[nvcc, *FLAGS, '-c', '-o', o, str(p)]
                for p, o in zip(srcs, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        so = os.path.join(tmp, libname)
        link = [nvcc, '-shared', '-o', so, *objs]
        text = ''.join(f"$ {' '.join(c)}\n{o}" for c, o in zip(cmds, outs))
        failed = [c for c, p in zip(cmds, procs) if p.returncode != 0]
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            text += f"$ {' '.join(link)}\n{proc.stdout}{proc.stderr}"
            if proc.returncode != 0:
                failed = [link]
        if failed:
            raise RuntimeError(f"nvcc failed:\n{text}")
        log.write_text(text)
        os.replace(so, lib)
    return lib, text


def library(name='solve'):
    """The loaded library ``name`` (built at first use), with argtypes
    set."""
    if name not in _LIBS:
        path, _ = build(name)
        lib = ctypes.CDLL(str(path))
        for entry, types in LIBRARIES[name][2].items():
            fn = getattr(lib, entry)
            fn.argtypes = types
            fn.restype = _I
        _LIBS[name] = lib
    return _LIBS[name]


def entry(name, dtype, storage=None):
    """The solve library's C entry point ``name`` for tensors of the
    complex ``dtype``: the complex128 instance, or its ``_c64`` twin for
    complex64, or, with ``storage`` ``torch.bfloat16`` (complex64 only),
    its ``_bf16`` twin.  Any other combination raises: a bfloat16 request
    never runs another instance."""
    import torch
    if storage is not None:
        if dtype != torch.complex64 or storage != torch.bfloat16:
            raise ValueError(f"{name}: bfloat16 storage takes complex64 "
                             f"tensors; got {dtype}, storage {storage}")
        return getattr(library(), name + BF16)
    if dtype == torch.complex128:
        return getattr(library(), name)
    if dtype == torch.complex64:
        return getattr(library(), name + C64)
    raise ValueError(f"{name}: the CUDA kernels take complex128 or "
                     f"complex64; got {dtype}")
