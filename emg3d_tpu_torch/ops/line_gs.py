"""Line relaxation on Hopper: wrapper, line state and plain version.

Replaces the Pallas line smoother of ``emg3d_tpu/ops/pallas_lr.py``
with two hand-written CUDA kernels (``csrc/line_gs.cu``), launched once
each per colour step, as the Pallas pair is:

- ``line_residual`` (K3) replaces ``_kernel_res``: the residual
  ``s − A e`` of the whole level (the math of
  :func:`.stencil.residual_parts`, its plain version), one thread per
  edge, into a residual buffer of the wrapper.
- ``line_thomas`` (K4) replaces ``_kernel_thomas``: one thread per line
  of the colour runs the block-Thomas substitution along the line
  against the factor stack and adds δ into the line's edges in place
  (the math of :func:`.smoothers.line_thomas_x`, its plain version).

y- and z-lines run the x-line kernels in a cyclically rotated frame:
the fields are transposed on the way in and out, and the rotated model
parameters, the residual kernel's η edge sums and ζ face weights and
the factor stack are field-independent and live in a :class:`LineState`
per (level, axis).  :func:`line_relaxation` runs the kernels for CUDA
tensors and :func:`line_relaxation_plain`, the plain version of the
whole smoothing call (``smoothers.line_color_steps``), for CPU tensors;
for a CUDA tensor it launches or raises, it never falls back.
"""
import ctypes
import math
from collections import namedtuple

import torch

from . import smoothers, stencil
from .smoothers import NLINE

__all__ = ['LineState', 'line_state', 'line_factors', 'line_relaxation',
           'line_relaxation_plain', 'residual', 'thomas', 'launch_geometry',
           'residual_geometry', 'factor_bytes', 'cache_budget', 'LAUNCHES',
           'reset_launches', 'LINE_SHARE']

# Share of the card's memory that the cached factor stacks of one solve
# may take together (all levels, axes and semicoarsening hierarchies).
# A stack that would cross it is rebuilt at every smoothing call
# instead of cached.
LINE_SHARE = 0.5

# Launches of each kernel since the last reset_launches().
LAUNCHES = {'line_residual': 0, 'line_thomas': 0}

MAX_THREADS = 256
THOMAS_THREADS = 128

LineState = namedtuple('LineState', [
    'axis',       # 0, 1, 2: the lines' direction in the level's frame
    'shape',      # cell shape in the rotated frame (lines along x)
    'arrays',     # rotated (eta_x, eta_y, eta_z, zeta, hx, hy, hz)
    'st',         # η edge sums (stx, sty, stz) of the rotated frame
    'w',          # ζ face weights (wx, wy, wz)
    'ih',         # inverse widths (ihx, ihy, ihz)
    'factors',    # (nx, NLINE, 2, 2, ny2, nz2) complex, or None (rebuilt)
])


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _line_dims(rshape):
    """(ny2, nz2): lines per transverse parity (interior lines halved)."""
    return rshape[1] // 2, rshape[2] // 2


def factor_bytes(shape, axis):
    """Bytes of the complex128 factor stack of ``axis``-lines of a level."""
    rs = smoothers.rotate_shape(shape, axis)
    ny2, nz2 = _line_dims(rs)
    return rs[0] * NLINE * 4 * ny2 * nz2 * 16


def cache_budget(device):
    """Bytes of factor stacks one solve may keep cached on ``device``."""
    device = torch.device(device)
    if device.type != 'cuda':
        return math.inf
    total = torch.cuda.get_device_properties(device).total_memory
    return LINE_SHARE * total


def line_factors(arrays, shape, axis):
    """Factor stack of ``axis``-lines of a level (rotated frame)."""
    return smoothers.line_factor_stack(
        smoothers.rotate_arrays(arrays, axis),
        smoothers.rotate_shape(shape, axis))


def line_state(arrays, shape, axis, factors=True):
    """Field-independent state of ``axis``-line relaxation on a level.

    The counterpart of the JAX package's per-(level, axis) cache
    (``_level_fstacks``: ``rotate_arrays``, ``line_params`` and
    ``line_factors``), unpadded.  Without ``factors`` the stack is not
    kept: each smoothing call rebuilds it (the memory rule of the
    solver).
    """
    ar = smoothers.rotate_arrays(arrays, axis)
    rs = smoothers.rotate_shape(shape, axis)
    eta_x, eta_y, eta_z, zeta, hx, hy, hz = ar
    st = tuple(t.contiguous() for t in
               stencil.eta_edge_sums(eta_x, eta_y, eta_z))
    w = tuple(t.contiguous() for t in stencil.zeta_face_weights(zeta))
    ih = tuple((1.0 / h).contiguous() for h in (hx, hy, hz))
    fac = smoothers.line_factor_stack(ar, rs) if factors else None
    return LineState(int(axis), rs, ar, st, w, ih, fac)


def residual_geometry(shape):
    """(blocks, threads) of the residual kernel: one thread per edge."""
    nx, ny, nz = shape
    total = (nx * (ny + 1) * (nz + 1) + (nx + 1) * ny * (nz + 1)
             + (nx + 1) * (ny + 1) * nz)
    return -(-total // MAX_THREADS), MAX_THREADS


def launch_geometry(shape, color):
    """Active lines of one colour and the Thomas launch that covers them.

    ``shape`` is the rotated-frame cell shape (lines along x).  Interior
    lines are (j, k) with j in 1..ny-1, k in 1..nz-1; colour
    ``cy + 2·cz`` takes those with (j-1) % 2 == cy and (k-1) % 2 == cz.
    Returns ``(cy, cz, counts, blocks, threads)``: ``counts`` = active
    lines per transverse axis, and a 1-D launch of ``blocks`` ×
    ``threads`` (``blocks == 0`` when the colour has no line, e.g.
    colours 1 and 3 on a level with one interior y-line).
    """
    _, ny, nz = shape
    cy, cz = color % 2, color // 2
    counts = ((ny - cy) // 2, (nz - cz) // 2)
    total = counts[0] * counts[1]
    if total == 0:
        return cy, cz, counts, 0, 0
    threads = min(THOMAS_THREADS, -(-total // 32) * 32)
    return cy, cz, counts, -(-total // threads), threads


def _level_shape(state):
    rs, a = state.shape, state.axis
    return tuple(rs[(i - a) % 3] for i in range(3))


def _check(e, s, state):
    nx, ny, nz = _level_shape(state)
    edges = ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
             (nx + 1, ny + 1, nz))
    dev = e[0].device
    for name, trio in (('e', e), ('s', s)):
        if len(trio) != 3:
            raise ValueError(f"{name}: {len(trio)} tensors, expected 3")
        for t, sh in zip(trio, edges):
            if tuple(t.shape) != sh:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                                 f"{sh} for level {(nx, ny, nz)}")
            if t.device != dev:
                raise ValueError(f"{name}: on {t.device}, e on {dev}")
    fac = state.factors
    if fac is not None:
        rs = state.shape
        want = (rs[0], NLINE, 2, 2, *_line_dims(rs))
        if tuple(fac.shape) != want:
            raise ValueError(f"factors: shape {tuple(fac.shape)}, expected "
                             f"{want}")
    if dev.type == 'cpu':
        return
    groups = {'e': e, 's': s, 'st': state.st, 'w': state.w, 'ih': state.ih,
              'factors': () if fac is None else (fac,)}
    for name, trio in groups.items():
        want = torch.float64 if name in ('w', 'ih') else torch.complex128
        for t in trio:
            if t.device != dev or t.dtype != want or not t.is_contiguous():
                raise ValueError(
                    f"{name}: the CUDA kernels take contiguous {want} on "
                    f"{dev}; got {t.dtype} on {t.device}, contiguous="
                    f"{t.is_contiguous()}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(dev):
    with torch.cuda.device(dev):
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _cuda(t):
    if t.device.type != 'cuda':
        raise ValueError(f"no line-relaxation kernel for {t.device}")


def residual(e, s, state, out):
    """``out`` ← s − A e of the rotated-frame level (K3); returns ``out``.

    ``e``, ``s``, ``out`` are rotated-frame CUDA edge tensors; the plain
    version is :func:`.stencil.residual_parts`.
    """
    _cuda(e[0])
    from ._build import library
    blocks, threads = residual_geometry(state.shape)
    err = library().emg3d_line_residual(
        *(_ptr(t) for t in (*out, *e, *s, *state.st, *state.w, *state.ih)),
        *state.shape, blocks, threads, _stream(e[0].device))
    if err != 0:
        raise RuntimeError(f"line_residual kernel launch failed: cudaError "
                           f"{err} (shape {state.shape})")
    LAUNCHES['line_residual'] += 1
    return out


def thomas(e, r, fac, state, color, zs=None):
    """Block-Thomas update of one colour's lines, in place (K4).

    ``e``/``r`` are rotated-frame edge tensors, ``fac`` the factor stack
    and ``zs`` an optional ``(nx, 5, ny2·nz2)`` complex scratch for the
    forward sweep, all on the card.  The plain version is
    :func:`.smoothers.line_thomas_x`.  Returns ``e``.
    """
    _cuda(e[0])
    nx = state.shape[0]
    ny2, nz2 = _line_dims(state.shape)
    cy, cz, counts, blocks, threads = launch_geometry(state.shape, color)
    if blocks == 0:
        return tuple(e)
    if zs is None:
        zs = torch.empty((nx, 5, ny2 * nz2), dtype=e[0].dtype,
                         device=e[0].device)
    from ._build import library
    err = library().emg3d_line_thomas(
        *(_ptr(t) for t in (*e, *r, fac, zs)), *state.shape, cy, cz,
        *counts, blocks, threads, _stream(e[0].device))
    if err != 0:
        raise RuntimeError(f"line_thomas kernel launch failed: cudaError "
                           f"{err} (colour {color}, shape {state.shape})")
    LAUNCHES['line_thomas'] += 1
    return tuple(e)


def _rotated(f, axis):
    return tuple(t.contiguous()
                 for t in smoothers.rotate_fields(tuple(f), axis))


def _write_back(e, out, axis):
    """Copy the rotated-frame result ``out`` into ``e`` (in place)."""
    for dst, src in zip(e, smoothers.unrotate_fields(out, axis)):
        if src is not dst:
            dst.copy_(src)
    return tuple(e)


def _factors(state):
    if state.factors is not None:
        return state.factors
    return smoothers.line_factor_stack(state.arrays, state.shape)


def line_relaxation_plain(e, s, state, nu, _seq=None):
    """Plain PyTorch version of the colour steps, on any device.

    :func:`.smoothers.line_color_steps` in the state's rotated frame,
    with its cached factor stack; writes the result into ``e`` in
    place, as the kernels do.
    """
    seq = smoothers.line_color_sequence(nu) if _seq is None else list(_seq)
    a = state.axis
    out = smoothers.line_color_steps(_rotated(e, a), _rotated(s, a),
                                     state.arrays, _factors(state), seq)
    return _write_back(e, out, a)


def line_relaxation(e, s, state, nu, _seq=None):
    """nu sweeps of 4-colour line Gauss-Seidel along ``state.axis``.

    e, s : (ex, ey, ez) and (sx, sy, sz) edge tensors of the level,
        in its own frame; ``e`` is updated in place.
    state : :func:`line_state` of the level and axis.
    _seq : explicit colour sequence (tests).

    CPU tensors run :func:`line_relaxation_plain`; for CUDA tensors each
    colour step is :func:`residual` (K3) then :func:`thomas` (K4).
    Returns ``e``.
    """
    _check(e, s, state)
    seq = smoothers.line_color_sequence(nu) if _seq is None else list(_seq)
    if e[0].device.type == 'cpu':
        return line_relaxation_plain(e, s, state, nu, _seq=seq)
    _cuda(e[0])
    a = state.axis
    er = tuple(e) if a == 0 else _rotated(e, a)
    sr = _rotated(s, a)
    fac = _factors(state)
    r = tuple(torch.empty_like(t) for t in er)
    ny2, nz2 = _line_dims(state.shape)
    zs = torch.empty((state.shape[0], 5, ny2 * nz2), dtype=er[0].dtype,
                     device=er[0].device)
    for color in seq:
        residual(er, sr, state, r)
        thomas(er, r, fac, state, color, zs)
    return _write_back(e, er, a)
