"""Point Gauss-Seidel smoother on Hopper: wrapper, state and plain version.

Replaces the Pallas point smoother of ``emg3d_tpu/ops/pallas_gs.py``
with two hand-written CUDA kernels (``csrc/point_gs.cu``, one template
instantiated twice):

- ``factored`` (K1) replaces ``_kernel_resident``: substitution only,
  against LDLᵀ factors built once per level and solve
  (:func:`point_state`, the counterpart of ``pack_factors``).
- ``fused`` (K2) replaces ``_kernel``: assembles, factors and solves
  each node block in registers.  The solver takes it for a level whose
  factor stack would exceed :data:`FACTOR_SHARE` of the card's memory,
  as the JAX package takes ``_kernel`` where ``_resident_plan`` fails.

One launch per colour step, one thread per active node; the kernel
updates the field in place.  :func:`gauss_seidel_point` runs the
kernels for CUDA tensors and the plain PyTorch version
(:func:`gauss_seidel_point_plain`, the math of
:func:`.smoothers.gauss_seidel_point`) for CPU tensors.  For a CUDA
tensor it launches or raises: it never falls back.
"""
import ctypes
from collections import namedtuple

import torch

from . import smoothers, stencil

__all__ = ['PointState', 'point_state', 'gauss_seidel_point',
           'gauss_seidel_point_plain', 'launch_geometry', 'LAUNCHES',
           'reset_launches', 'factors_fit']

# Strict-lower factor entries of the 6×6 node-block LDLᵀ (fixed sparsity
# incl. the (3,2) and (5,4) fill-in), in the plane order of the factor
# stack: planes 0..13 = L[k] for k in LKEYS, planes 14..19 = dinv[0..5].
# Same order as _LKEYS of the JAX package and l_plane() of the kernel.
LKEYS = ((2, 0), (2, 1), (3, 0), (3, 1), (3, 2), (4, 0), (4, 1),
         (4, 2), (4, 3), (5, 0), (5, 1), (5, 2), (5, 3), (5, 4))
NFACTORS = len(LKEYS) + 6

# Share of the card's memory one level's factor stack may take before
# the solver uses the fused kernel on that level.
FACTOR_SHARE = 0.25

# Launches of each kernel since the last reset_launches().
LAUNCHES = {'factored': 0, 'fused': 0}

MAX_THREADS = 256

PointState = namedtuple('PointState', [
    'shape',      # cell shape (nx, ny, nz)
    'arrays',     # (eta_x, eta_y, eta_z, zeta, hx, hy, hz)
    'st',         # η edge sums (stx, sty, stz), complex
    'w',          # ζ face weights (wx, wy, wz), real
    'ih',         # inverse widths (ihx, ihy, ihz), real
    'factors',    # (20, nx-1, ny-1, nz-1) complex, or None
])


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def factor_bytes(shape):
    """Bytes of a level's complex128 factor stack."""
    nx, ny, nz = shape
    return NFACTORS * (nx - 1) * (ny - 1) * (nz - 1) * 16


def factors_fit(shape, device):
    """Whether a level's factor stack fits FACTOR_SHARE of the card."""
    device = torch.device(device)
    if device.type != 'cuda':
        return True
    total = torch.cuda.get_device_properties(device).total_memory
    return factor_bytes(shape) <= FACTOR_SHARE * total


def point_state(arrays, shape, factored=True):
    """Field-independent level state of the point smoother.

    Built once per level and solve, on the tensors' device, by torch
    ops: the counterpart of ``pack_params``/``pack_factors`` of the JAX
    package, without their (8,128) padding.  With ``factored`` it holds
    the node-block LDLᵀ factors of the factored kernel.
    """
    eta_x, eta_y, eta_z, zeta, hx, hy, hz = arrays
    st = tuple(t.contiguous() for t in
               stencil.eta_edge_sums(eta_x, eta_y, eta_z))
    w = tuple(t.contiguous() for t in stencil.zeta_face_weights(zeta))
    ih = tuple((1.0 / h).contiguous() for h in (hx, hy, hz))
    factors = None
    if factored:
        nb = tuple(n - 1 for n in shape)
        L, dinv = smoothers.node_factors(arrays)
        planes = [L[k] for k in LKEYS] + list(dinv)
        factors = torch.stack([torch.broadcast_to(p, nb) for p in planes])
    return PointState(tuple(shape), tuple(arrays), st, w, ih, factors)


def launch_geometry(shape, color):
    """Active nodes of one colour and the launch that covers them.

    Returns ``(first, counts, blocks, threads)``: the first active
    global node index and the number of active nodes per axis, and a
    1-D launch of ``blocks`` × ``threads`` (``blocks == 0`` when the
    colour has no node, e.g. all colours but 7 on a (2,2,2) level).
    Interior nodes are 1..n-1 per axis; node ix is active when
    ix % 2 == the colour's parity on that axis.
    """
    parity = (color % 2, (color // 2) % 2, color // 4)
    first = tuple(2 - p for p in parity)
    counts = tuple(max(0, (n - 1 - f) // 2 + 1) for n, f in
                   zip(shape, first))
    total = counts[0] * counts[1] * counts[2]
    if total == 0:
        return first, counts, 0, 0
    threads = min(MAX_THREADS, -(-total // 32) * 32)
    return first, counts, -(-total // threads), threads


def _plain_fact(state):
    f = state.factors
    return ({k: f[i] for i, k in enumerate(LKEYS)},
            [f[len(LKEYS) + i] for i in range(6)])


def gauss_seidel_point_plain(e, s, state, nu, _seq=None, _mode=None):
    """Plain PyTorch version of the colour steps, on any device.

    Runs :func:`.smoothers.color_steps` and writes the result into ``e``
    in place, as the kernels do.  The fused mode re-factors the blocks
    every colour step, as its kernel does; the factored mode uses the
    state's factors.
    """
    mode = _resolve_mode(state, _mode)
    seq = smoothers.color_sequence(nu) if _seq is None else list(_seq)
    fact = _plain_fact(state) if mode == 'factored' else None
    cur = smoothers.color_steps(tuple(e), s, state.arrays, seq, fact=fact)
    for dst, src in zip(e, cur):
        dst.copy_(src)
    return tuple(e)


def _resolve_mode(state, _mode):
    mode = _mode or ('factored' if state.factors is not None else 'fused')
    if mode not in ('factored', 'fused'):
        raise ValueError(f"unknown point-smoother mode {mode!r}")
    if mode == 'factored' and state.factors is None:
        raise ValueError("factored point smoother needs a state built "
                         "with factored=True")
    return mode


def _state_shapes(shape):
    """Expected tensor shapes of a level, per :class:`PointState` group."""
    nx, ny, nz = shape
    cells = (nx, ny, nz)
    return {
        'e': ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
              (nx + 1, ny + 1, nz)),
        'arrays': (cells,) * 4 + ((nx,), (ny,), (nz,)),
        'st': ((nx, ny - 1, nz - 1), (nx - 1, ny, nz - 1),
               (nx - 1, ny - 1, nz)),
        'w': ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)),
        'ih': ((nx,), (ny,), (nz,)),
        'factors': ((NFACTORS, nx - 1, ny - 1, nz - 1),),
    }


def _check(e, s, state):
    shapes = _state_shapes(state.shape)
    shapes['s'] = shapes['e']
    groups = {'e': e, 's': s, 'arrays': state.arrays, 'st': state.st,
              'w': state.w, 'ih': state.ih}
    if state.factors is not None:
        groups['factors'] = (state.factors,)
    dev = e[0].device
    for name, trio in groups.items():
        if len(trio) != len(shapes[name]):
            raise ValueError(f"{name}: {len(trio)} tensors, expected "
                             f"{len(shapes[name])}")
        for t, sh in zip(trio, shapes[name]):
            if tuple(t.shape) != sh:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                                 f"expected {sh} for level {state.shape}")
            if t.device != dev:
                raise ValueError(f"{name}: on {t.device}, e on {dev}")
    if dev.type == 'cpu':
        return
    want = {'e': torch.complex128, 's': torch.complex128,
            'st': torch.complex128, 'w': torch.float64,
            'ih': torch.float64, 'factors': torch.complex128}
    for name in want.keys() & groups.keys():
        for t in groups[name]:
            if t.dtype != want[name] or not t.is_contiguous():
                raise ValueError(
                    f"{name}: the CUDA kernel takes contiguous "
                    f"{want[name]} on {dev}; got {t.dtype}, "
                    f"contiguous={t.is_contiguous()}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def gauss_seidel_point(e, s, state, nu, _mode=None, _seq=None):
    """nu sweeps of 8-colour point Gauss-Seidel; updates ``e`` in place.

    e, s : (ex, ey, ez) and (sx, sy, sz) edge tensors of the level.
    state : :func:`point_state` of the level.
    _mode : 'factored' or 'fused' pins a kernel (tests and the chip
        smoke run); by default the state decides (factors present ->
        factored).
    _seq : explicit colour sequence (tests).

    CPU tensors run :func:`gauss_seidel_point_plain`; CUDA tensors run
    the kernels, one launch per colour step.  Returns ``e``.
    """
    _check(e, s, state)
    mode = _resolve_mode(state, _mode)
    seq = smoothers.color_sequence(nu) if _seq is None else list(_seq)
    if e[0].device.type == 'cpu':
        return gauss_seidel_point_plain(e, s, state, nu, _seq=seq,
                                        _mode=mode)
    if e[0].device.type != 'cuda':
        raise ValueError(f"no point-smoother kernel for {e[0].device}")

    from ._build import library
    fn = library().emg3d_point_gs_step
    factored = mode == 'factored'
    fac = state.factors if factored else None
    ptrs = [_ptr(t) for t in (*e, *s, *state.st, *state.w, *state.ih)]
    ptrs.append(_ptr(fac) if fac is not None else ctypes.c_void_p(0))
    with torch.cuda.device(e[0].device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for color in seq:
        first, counts, blocks, threads = launch_geometry(state.shape,
                                                         color)
        if blocks == 0:
            continue
        err = fn(int(factored), *ptrs, *state.shape, *first, *counts,
                 blocks, threads, stream)
        if err != 0:
            raise RuntimeError(f"point_gs {mode} kernel launch failed: "
                               f"cudaError {err} (colour {color}, shape "
                               f"{state.shape})")
        LAUNCHES[mode] += 1
    return tuple(e)
