"""The Mosaic probes' counterparts on the card, with their plain versions.

The JAX package's scripts/hw_probe_ztile.py and hw_bisect_zp256.py are
Pallas kernels that probed which on-chip copies, layouts and scratch
sizes Mosaic lowers.  ``csrc/probes.cu`` does the same work with the
card's own means (the TMA and mbarriers for ``make_async_copy``, in
``tile_copy`` and ``smem_sum``, bulk async copies on mbarriers through
dynamic shared memory up to the card's opt-in in ``smem_limit``, a
rolled gather for ``pltpu.roll``, cp.async for dynamic slices, 16-byte
streaming loads of four points a thread for the station solve); no
solve path runs them.  The launch plans (``tile_plan``, ``smem_plan``,
``sum_plan``, ``station_plan``) are plain Python, so the CPU tests walk
them.  Each wrapper launches its kernel (or raises) where
:func:`._build.kernels` says so, else takes its plain version (but
``smem_limit``, which asks the card a question), and counts its
launches in ``LAUNCHES``.
``chip_smoke.py``'s probe phase holds each kernel against its plain
version at the shapes of the Pallas probes.
"""
import ctypes
from typing import NamedTuple

import torch

from . import _build

__all__ = ['tile_copy', 'tile_copy_plain', 'tile_box', 'tile_span',
           'tile_plan', 'TilePlan', 'smem_limit', 'smem_limit_plain',
           'smem_plan', 'SmemPlan', 'smem_optin', 'smem_sum',
           'smem_sum_plain', 'sum_plan', 'SumPlan', 'tile_roll', 'dyn_slice',
           'dyn_slice_plain', 'station_solve', 'station_solve_plain',
           'station_plan', 'StationPlan', 'LAUNCHES', 'reset_launches']

LAUNCHES = {'tile_copy': 0, 'smem_limit': 0, 'smem_sum': 0,
            'tile_roll': 0, 'dyn_slice': 0, 'station_solve': 0}
# tile_copy's plan: the bytes of one box in shared memory at most (TMA
# boxes are ≤ 256 a dim), the stages of a block's ring, and the blocks
# per SM: the fastest of the card's table at probe12's box and at the
# whole probe3 array (16 KB × 2; 8-32 KB and 2-8 blocks per SM within
# 4 %: chip_smoke.py phase 14, ``copy_plans``).
TILE_BYTES = 16 * 1024
TILE_STAGES = 3
TILE_BLOCKS_PER_SM = 2
# smem_limit's staged rows of x (each 512 floats, 2048 B) and its
# threads (csrc/probes.cu kStageRows, kStageThreads: one float4 of row
# 0 each); the bulk copies each way by default: the faster of 1 and 8 in
# the card's table (chip_smoke.py phase 14, ``probe_plans``).
SMEM_ROWS = 8
SMEM_WIDTH = 512
SMEM_STAGED = SMEM_ROWS * SMEM_WIDTH * 4
SMEM_PIECES = 1
# smem_limit's C entry's answer when its kernel holds static shared
# memory (csrc/probes.cu kStaticSmem).
SMEM_STATIC_ERR = 2000
# smem_sum's plan: the bytes of one box at most, the stages of a block's
# ring, and its threads (csrc/probes.cu kSumThreads: one float4 of a
# box's outputs each).  TMA takes at most 256 stations in one box.
SUM_BYTES = 16 * 1024
SUM_STAGES = 3
SUM_THREADS = 128
SUM_CHUNK = 256
# station_solve's threads a block (csrc/probes.cu kStationThreads).
STATION_THREADS = 128


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    return _build.library('probes')


def _stream(t):
    with torch.cuda.device(t.device):
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check(t, ndim, name):
    if t.dtype != torch.float32 or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: a contiguous {ndim}-D float32 tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _raise(err, name, what):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err} "
                           f"({what})")
    LAUNCHES[name] += 1


def _even(n, most):
    """The part of n in the fewest parts of at most ``most``, as even as
    whole parts allow (the last one may be shorter)."""
    return -(-n // -(-n // most))


def tile_box(lengths, box_bytes=TILE_BYTES):
    """The TMA box (b0..b3) of a sub-box of ``lengths`` (its z length
    rounded out to 16 bytes, :func:`tile_span`): z in equal boxes, each
    a multiple of 4 (16-byte rows) and at most 256, that divide the span
    (no box reaches past the map's z end; a span of 4p floats, p a prime
    above 64, takes boxes of 4), then y rows, then x planes, each split
    evenly within ``box_bytes``."""
    span = -(-lengths[3] // 4) * 4
    q = span // 4
    b3 = span // next(p for p in range(-(-span // 256), q + 1)
                      if q % p == 0)
    b2 = _even(lengths[2], max(1, min(256, box_bytes // (4 * b3))))
    b1 = _even(lengths[1], max(1, min(256, box_bytes // (4 * b3 * b2))))
    b0 = _even(lengths[0],
               max(1, min(256, box_bytes // (4 * b3 * b2 * b1))))
    return b0, b1, b2, b3


def tile_span(offset, length, size):
    """The z elements a tile_copy kernel moves for a sub-box's z range:
    [offset, offset + length) rounded out to multiples of 4 (16 bytes;
    the card refused boxes at other z offsets), within ``size``."""
    return min(size, -(-(offset + length) // 4) * 4) - offset // 4 * 4


class TilePlan(NamedTuple):
    """tile_copy's launch: the TMA ``box``, the boxes along each dim
    (``counts``, z fastest in a box's index), the ``stages`` of a
    block's ring, the persistent ``blocks`` (block b moves boxes b, b +
    blocks, ...) and the dynamic shared-memory bytes."""
    box: tuple
    counts: tuple
    stages: int
    blocks: int
    smem: int


def tile_plan(size, offsets, lengths, sms=132, box_bytes=TILE_BYTES,
              per_sm=TILE_BLOCKS_PER_SM):
    """The plan of a sub-box (``offsets``, ``lengths``) of an array whose
    last dim is ``size``, on a card of ``sms`` SMs: boxes of
    :func:`tile_box` within ``box_bytes``, min(boxes, per_sm · sms)
    blocks, a ring of min(TILE_STAGES, the most boxes a block takes)
    stages, each stage 128-byte aligned (csrc/probes.cu)."""
    span = tile_span(offsets[3], lengths[3], size)
    box = tile_box((*lengths[:3], span), box_bytes)
    counts = tuple(-(-n // b) for n, b in zip((*lengths[:3], span), box))
    boxes = counts[0] * counts[1] * counts[2] * counts[3]
    blocks = min(boxes, per_sm * sms)
    stages = min(TILE_STAGES, -(-boxes // blocks))
    stage = -(-(box[0] * box[1] * box[2] * box[3]) // 32) * 32 * 4
    return TilePlan(box, counts, stages, blocks, stages * stage + 128)


def tile_copy(x, offsets, lengths, _plan=None):
    """x[o0:o0+l0, …, o3:o3+l3] += 1 in place (``hw_probe_ztile``'s copy
    +1 through on-chip memory); returns x.  ``x`` a contiguous 4-D
    float32 tensor whose last dim is a multiple of 4.  ``_plan`` (a
    :func:`tile_plan` of the sub-box) forces another launch plan."""
    _check(x, 4, 'tile_copy')
    for o, n, d in zip(offsets, lengths, x.shape):
        if o < 0 or n < 1 or o + n > d:
            raise ValueError(f"tile_copy: box {offsets} + {lengths} "
                             f"outside {tuple(x.shape)}")
    if not _build.kernels(x):
        return tile_copy_plain(x, offsets, lengths)
    if x.shape[3] % 4:
        raise ValueError("tile_copy: the last dim must be a multiple of 4 "
                         "(16-byte strides)")
    plan = _plan or tile_plan(x.shape[3], offsets, lengths, torch.cuda.
                              get_device_properties(x.device)
                              .multi_processor_count)
    err = _lib().emg3d_probe_tile_copy(
        _ptr(x), *x.shape, *offsets, *lengths, *plan.box, plan.stages,
        plan.blocks, _stream(x))
    _raise(err, 'tile_copy', f"box {offsets} + {lengths}, {plan}")
    return x


def tile_copy_plain(x, offsets, lengths):
    x[tuple(slice(o, o + n) for o, n in zip(offsets, lengths))] += 1.0
    return x


class SmemPlan(NamedTuple):
    """smem_limit's launch: the bulk copies each way (1: all 16 KB; 8:
    a row each, each on its own mbarrier), the staged rows' byte offset
    in the dynamic buffer and the mbarriers' bytes at its start."""
    pieces: int
    offset: int
    bars: int


def smem_plan(nbytes, pieces=SMEM_PIECES):
    """The plan for ``nbytes`` of dynamic shared memory: the staged rows
    at the buffer's top 16 KB, 128-byte aligned (csrc/probes.cu
    ``smem_stage``), ``pieces`` mbarriers of 8 bytes below them."""
    if pieces not in (1, SMEM_ROWS):
        raise ValueError(f"smem_plan: pieces 1 or {SMEM_ROWS}, got {pieces}")
    offset = (nbytes - SMEM_STAGED) & ~127
    if nbytes < SMEM_STAGED or offset < 8 * pieces:
        raise ValueError(f"smem_plan: {nbytes} B cannot hold the "
                         f"{SMEM_STAGED} B of staged rows above {pieces} "
                         f"mbarrier(s)")
    return SmemPlan(pieces, offset, 8 * pieces)


def smem_limit(x, nbytes, _plan=None):
    """``hw_probe_ztile``'s probe_vmem: x[0] += 1 in place through a
    block of ``nbytes`` of dynamic shared memory (the probe's declared
    VMEM scratch), after cudaFuncSetAttribute to ``nbytes``.  ``x`` a
    contiguous (rows, 512) float32 tensor on the card, rows >= 8,
    16-byte aligned; its first 8 rows are staged in and out by bulk
    async copies (:func:`smem_plan`; ``_plan`` forces another's
    pieces).
    Returns ``(launch_error, attribute_error, x)``, errors as
    cudaError_t (0 where the card took the size; a refused launch
    leaves x as it was).  Card only: the question is the card's; its
    plain version is :func:`smem_limit_plain`."""
    _check(x, 2, 'smem_limit')
    if x.shape[0] < SMEM_ROWS or x.shape[1] != SMEM_WIDTH or \
            x.data_ptr() % 16:
        raise ValueError(f"smem_limit: no kernel for {tuple(x.shape)} "
                         f"(rows >= {SMEM_ROWS}, {SMEM_WIDTH} wide, "
                         f"16-byte aligned)")
    plan = smem_plan(nbytes, _plan.pieces if _plan else SMEM_PIECES)
    if x.device.type != 'cuda':
        raise ValueError("smem_limit probes a CUDA card's shared memory: "
                         "x on the card")
    attr = ctypes.c_int(-1)
    err = _lib().emg3d_probe_smem_limit(
        _ptr(x), x.shape[0], int(nbytes), plan.pieces,
        ctypes.c_void_p(ctypes.addressof(attr)), _stream(x))
    if err == SMEM_STATIC_ERR:
        raise RuntimeError("smem_limit: smem_stage was built with static "
                           "shared memory")
    if err == 0:
        LAUNCHES['smem_limit'] += 1
    return err, attr.value, x


def smem_limit_plain(x):
    x[0] += 1.0
    return x


def smem_optin(device='cuda'):
    """The dynamic shared memory (bytes) a block of the card may opt in
    to (cudaDevAttrMaxSharedMemoryPerBlockOptin)."""
    with torch.cuda.device(torch.device(device)):
        val = ctypes.c_int(0)
        err = _lib().emg3d_probe_smem_optin(
            ctypes.c_void_p(ctypes.addressof(val)))
    if err != 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed: {err}")
    return val.value


class SumPlan(NamedTuple):
    """smem_sum's launch: the TMA ``box`` (z, y, stations), the boxes
    along each (``counts``), the ``stages`` of a block's ring, the
    persistent ``blocks`` (block b sums output tiles b, b + blocks, ...,
    z fastest, each from its station chunks in order) and the dynamic
    shared-memory bytes."""
    box: tuple
    counts: tuple
    stages: int
    blocks: int
    smem: int


def sum_plan(chx, ty, zp, sms=132, box_bytes=SUM_BYTES,
             per_sm=TILE_BLOCKS_PER_SM, most_stages=SUM_STAGES):
    """The plan of a sum of ``chx`` stations of a (ty, zp) plane on a
    card of ``sms`` SMs: stations in the fewest chunks of at most
    SUM_CHUNK, as even as whole chunks allow; then within ``box_bytes``
    (and at most 4 · SUM_THREADS outputs, one float4 a thread) the
    longest z extent, a multiple of 4 up to 256 that splits zp evenly,
    then y rows; min(tiles, per_sm · sms) blocks and a ring of
    min(``most_stages``, the most boxes a block takes) stages, each
    stage 128-byte aligned (csrc/probes.cu)."""
    bc = _even(chx, SUM_CHUNK)
    outs = max(4, min(4 * SUM_THREADS, box_bytes // (4 * bc)))
    bz = 4 * _even(-(-zp // 4), min(64, outs // 4))
    by = _even(ty, max(1, min(256, outs // bz)))
    counts = (-(-zp // bz), -(-ty // by), -(-chx // bc))
    tiles = counts[0] * counts[1]
    blocks = min(tiles, per_sm * sms)
    stages = min(most_stages, -(-tiles // blocks) * counts[2])
    stage = -(-(bz * by * bc) // 32) * 32 * 4
    return SumPlan((bz, by, bc), counts, stages, blocks,
                   stages * stage + 128)


def smem_sum(f, chx, plane, _plan=None):
    """``hw_bisect_zp256``'s fbuf5d: out (ty, Zp) = Σ_{i<chx} f[i,
    plane] of f (nx, NF, ty, Zp), Zp a positive multiple of 4 (16-byte
    rows), the stations added in order (bitwise
    :func:`smem_sum_plain`).  On the card only the plane moves, in TMA
    boxes (:func:`sum_plan`; ``_plan`` forces another)."""
    _check(f, 4, 'smem_sum')
    nx, nf, ty, zp = f.shape
    if not (1 <= chx <= nx and 0 <= plane < nf):
        raise ValueError(f"smem_sum: chx {chx}, plane {plane} for "
                         f"{tuple(f.shape)}")
    if zp % 4 or zp < 4 or ty < 1 or f.data_ptr() % 16:
        raise ValueError(f"smem_sum: no kernel for {tuple(f.shape)} (Zp a "
                         f"positive multiple of 4, ty ≥ 1, f 16-byte "
                         f"aligned)")
    if not _build.kernels(f):
        return smem_sum_plain(f, chx, plane)
    plan = _plan or sum_plan(chx, ty, zp, torch.cuda.get_device_properties(
        f.device).multi_processor_count)
    out = torch.empty((ty, zp), dtype=f.dtype, device=f.device)
    err = _lib().emg3d_probe_smem_sum(_ptr(out), _ptr(f), chx, nf, ty, zp,
                                      plane, *plan.box, plan.stages,
                                      plan.blocks, _stream(f))
    _raise(err, 'smem_sum', f"shape {tuple(f.shape)}, {plan}")
    return out


def smem_sum_plain(f, chx, plane):
    acc = torch.zeros(f.shape[2:], dtype=f.dtype, device=f.device)
    for i in range(chx):                   # the kernel's order: bitwise
        acc = acc + f[i, plane]
    return acc


def tile_roll(x, shift, axis):
    """``torch.roll(x, shift, axis)`` of a (ty, Zp) tile, any contiguous
    2-D float32 one (``hw_bisect_zp256``'s rolllane/rollsub): a rolled
    gather, the shift reduced here; its plain version is
    ``torch.roll``."""
    _check(x, 2, 'tile_roll')
    if axis not in (0, 1):
        raise ValueError(f"tile_roll: axis {axis}")
    if not _build.kernels(x):
        return torch.roll(x, shift, axis)
    rows, cols = x.shape
    if not 0 < rows * cols < 2**31 - 3:
        raise ValueError(f"tile_roll: no kernel for {rows * cols} "
                         f"elements (32-bit indices, at least one)")
    out = torch.empty_like(x)
    err = _lib().emg3d_probe_tile_roll(_ptr(out), _ptr(x), rows, cols,
                                       int(shift) % x.shape[axis], axis,
                                       _stream(x))
    _raise(err, 'tile_roll', f"shape {tuple(x.shape)}, axis {axis}")
    return out


def dyn_slice(x, y0, ty):
    """``hw_bisect_zp256``'s dynslice: out (T, A, B, ty, Z) with out[t] =
    x[:, :, y:y+ty] for each first row y = y0[t] clamped into range,
    ``y0`` an int32 tensor on x's device read by the kernel."""
    _check(x, 4, 'dyn_slice')
    if y0.dtype != torch.int32 or y0.dim() != 1 or y0.device != x.device:
        raise ValueError("dyn_slice: y0 a 1-D int32 tensor on x's device")
    a, b, ny, zp = x.shape
    if not 1 <= ty <= ny:
        raise ValueError(f"dyn_slice: ty {ty} for {ny} rows")
    if not _build.kernels(x):
        return dyn_slice_plain(x, y0, ty)
    if zp % 4:
        raise ValueError("dyn_slice: the last dim must be a multiple of 4")
    out = torch.empty((y0.numel(), a, b, ty, zp), dtype=x.dtype,
                      device=x.device)
    err = _lib().emg3d_probe_dyn_slice(_ptr(out), _ptr(x), _ptr(y0),
                                       y0.numel(), a * b, ny, ty, zp,
                                       _stream(x))
    _raise(err, 'dyn_slice', f"shape {tuple(x.shape)}, ty {ty}")
    return out


def dyn_slice_plain(x, y0, ty):
    ny = x.shape[2]
    return torch.stack([x[:, :, y:y + ty] for y in
                        (min(max(int(v), 0), ny - ty) for v in y0.tolist())])


class StationPlan(NamedTuple):
    """station_solve's launch: ``vec`` points a thread at a time (4:
    16-byte loads and stores), ``blocks`` of ``threads``; thread g of
    the grid takes the groups g, g + blocks · threads, ... of ``vec``
    points."""
    vec: int
    threads: int
    blocks: int


def station_plan(points, sms=132, per_sm=None, vec=None):
    """The plan for ``points`` points on a card of ``sms`` SMs: ``vec``
    points a thread, by default four where 4 divides ``points`` (every
    plane then starts on 16 bytes) and they give every SM a block of
    four-point threads, one otherwise (fewer points a thread, more
    threads: the shortest chain of arithmetic where latency decides).
    By default one group of ``vec`` points a thread: the card starts
    the blocks in order as others end, which read faster at
    STATION_LARGE than grid-stride sweeps (chip_smoke.py phase 14's
    table, ``probe_plans``); with ``per_sm`` the groups split evenly
    over a grid of at most ``per_sm`` blocks an SM (every thread takes
    as many, but for the last sweep's ragged end)."""
    if vec is None:
        vec = 4 if points % 4 == 0 and \
            points >= 4 * STATION_THREADS * sms else 1
    blocks = -(-(points // vec) // STATION_THREADS)
    if per_sm is not None:
        blocks = _even(blocks, per_sm * sms)
    return StationPlan(vec, STATION_THREADS, blocks)


def station_solve(x, _plan=None):
    """``hw_bisect_zp256``'s station: z (10, ty, Zp) from x (40, ty, Zp),
    the 5×5 complex-symmetric LDLᵀ substitution of
    ``blocksolve.ldl_solve_factored`` per point (planes 2i, 2i+1 of x
    the real and imaginary parts of complex entry i: L (0-9, strict
    lower, row-major), dinv (10-14), y (15-19); of z those of the
    solution).  On the card :func:`station_plan`'s launch (``_plan``
    forces another)."""
    _check(x, 3, 'station_solve')
    if x.shape[0] != 40:
        raise ValueError(f"station_solve: 40 planes, got {x.shape[0]}")
    if not _build.kernels(x):
        return station_solve_plain(x)
    points = x[0].numel()
    if not 0 < points < 2**31:
        raise ValueError(f"station_solve: no kernel for {points} points")
    plan = _plan or station_plan(points, torch.cuda.get_device_properties(
        x.device).multi_processor_count, vec=1 if x.data_ptr() % 16 else
        None)
    z = torch.empty((10,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    err = _lib().emg3d_probe_station_solve(_ptr(z), _ptr(x), points,
                                           plan.vec, plan.blocks,
                                           _stream(x))
    _raise(err, 'station_solve', f"shape {tuple(x.shape)}, {plan}")
    return z


def station_solve_plain(x):
    """Plain version: the matrix L·diag(1/dinv)·Lᵀ assembled per point
    and solved by ``torch.linalg.solve`` in complex128; the solution
    rounded to float32."""
    c = torch.complex(x[0::2].double(), x[1::2].double())    # (20, ...)
    pts = c.shape[1:]
    c = c.reshape(20, -1).T                                  # (P, 20)
    L = torch.eye(5, dtype=c.dtype, device=c.device).repeat(len(c), 1, 1)
    k = 0
    for i in range(1, 5):
        for j in range(i):
            L[:, i, j] = c[:, k]
            k += 1
    m = L @ torch.diag_embed(1.0 / c[:, 10:15]) @ L.transpose(1, 2)
    z = torch.linalg.solve(m, c[:, 15:20]).T.reshape((5,) + tuple(pts))
    return torch.stack([z.real, z.imag], 1).reshape(
        (10,) + tuple(pts)).float()
