"""Line relaxation on Hopper: wrappers, line state and plain versions.

Replaces the Pallas line smoother of ``emg3d_tpu/ops/pallas_lr.py``,
and the ``lax.scan`` that builds its factor stack, with three
hand-written CUDA kernels (``csrc/line_gs.cu``):

- ``line_factor`` (K5) replaces ``pallas_lr.line_factors`` whole: its
  station entries and the block-Thomas elimination it runs as a
  ``lax.scan`` (``emg3d_tpu/ops/blocksolve.py:305``).  One thread per
  line (:func:`factor_geometry`) assembles each station's blocks from
  the rotated frame's η sums, ζ weights and inverse widths, and runs
  the elimination along the stations (the math of :func:`.smoothers.line_factor_stack`, its plain
  version, which packs the same entries with torch ops).
- ``line_residual`` (K3) replaces ``_kernel_res``: the residual
  ``s − A e`` at exactly the edges the colour's Thomas step reads
  (:func:`colour_edges`; the math of :func:`.stencil.residual_parts`,
  restricted: :func:`residual_plain`), into a residual buffer of the
  wrapper; blocks stage slabs of e in shared memory
  (:func:`residual_geometry`).
- ``line_thomas`` (K4) replaces ``_kernel_thomas``: one warp per block
  of lines of the colour runs the block-Thomas substitution along the
  lines against the factor stack, loading stations ahead into shared
  memory, and adds δ into the lines' edges in place (the math of
  :func:`.smoothers.line_thomas_x`, its plain version).

Each kernel comes in complex128 and complex64 (the precision the Pallas
kernels compute in); the line state's dtype picks the instance, under
the same launch plans with every byte count at the element size.  A
complex64 line state may store in bfloat16, as the JAX package's Pallas
path does: its s/params streams (``storage``: K3 reads s, the η sums and
the ζ weights as bfloat16, ``pack_params(pdtype=)``,
``pack_fields(sdtype=)``) and its factor stack (``fstorage``: K5
eliminates in float32 and stores bfloat16, K4 reads it,
``line_factors(fdtype=)``).  The kernels' ``_bf16`` instances upcast at
the load; the plain versions round where they do.

K3 and K4 are launched once each per colour step, as the Pallas pair
is; K5 once per factor stack.  The residual buffer is filled with NaN
once per smoothing call: an entry K4 read outside its colour's edges
would show up as NaN in the result.  y- and z-lines run the x-line kernels in
a cyclically rotated frame: the fields are transposed on the way in and
out, and the rotated model parameters, the residual kernel's η edge
sums and ζ face weights and the factor stack are field-independent and
live in a :class:`LineState` per (level, axis).
:func:`line_relaxation` runs the kernels where :func:`._build.kernels`
says so, else :func:`line_relaxation_plain`, the plain version of the
whole smoothing call (``smoothers.line_color_steps``); where it runs
the kernels it launches or raises, it never falls back.

Lanes.  A batched solve relaxes B lanes (its (source, frequency)
pairs) of one level at once: e and s are (B, ...) tensors, and the
line state of the level is a *lane state* (:func:`line_state` with
``lanes``): its η sums and factor stack carry a leading axis of G
frequency groups, one K5 stack per group, and ``lanes`` maps each lane
to its group.  K3 and K4 then take all B lanes in one launch (the lane
is the grid's y index); :func:`lane_state` is one group's one-lane
state, which the plain version runs lane by lane.
"""
import ctypes
import functools
import math
from collections import namedtuple

import torch

from . import _build, smoothers, stencil
from ..dtypes import (REAL_OF, check_storage, complex_size, from_storage,
                      round_to, storage_of, to_storage)
from .smoothers import NLINE

__all__ = ['LineState', 'line_state', 'line_factors', 'factor',
           'line_relaxation', 'line_relaxation_plain', 'residual', 'thomas',
           'launch_geometry', 'factor_geometry', 'residual_geometry',
           'colour_edges', 'colour_edge_masks', 'residual_plain',
           'thomas_plain', 'segment_stack', 'Sweep', 'keep_stack',
           'factor_bytes', 'cache_budget', 'LAUNCHES', 'BF16_LAUNCHES',
           'reset_launches',
           'LINE_SHARE', 'SMEM_MAX', 'FactorGeometry', 'lane_state',
           'lane_count', 'MAX_LANES']

# Share of the card's memory that the cached factor stacks of one solve
# may take together (all levels, axes and semicoarsening hierarchies).
# A stack that would cross it is rebuilt at every smoothing call
# instead of cached.
LINE_SHARE = 0.5

# Launches of each kernel since the last reset_launches(); BF16_LAUNCHES
# counts those of the ``_bf16`` instances among them.
LAUNCHES = {'line_factor': 0, 'line_residual': 0, 'line_thomas': 0}
BF16_LAUNCHES = {'line_factor': 0, 'line_residual': 0, 'line_thomas': 0}

# K5: one line per thread in blocks of FACTOR_WARP threads.  The times
# of blocks of 32 to FACTOR_THREADS threads on the card
# (chip_smoke.factor_plans; PERF.md §6) put one warp first at every
# shape timed, 256 to 65536 lines.
FACTOR_WARP = 32
FACTOR_THREADS = 256
# K3: a block owns RES_ROWS line rows × RES_LINES lines along z × a run
# of stations, 5·rows·lines threads (csrc/line_gs.cu).  The run is the
# longest of RES_XPLANES that still gives the colour RES_BLOCKS blocks,
# else the shortest: a block walks its stations in sequence, so short
# runs hide latency on small levels.  Runs of RES_STAGED stations or
# more stage e in shared memory; shorter ones read it directly, where
# the ring's fill latency costs more than its saved re-reads.  Timed
# on the card at every rotated shape of sclr64 and at 256³
# (chip_smoke.residual_plans; PERF.md §6).
RES_ROWS = 2
RES_LINES = 16
RES_XPLANES = (4, 2, 1)
RES_BLOCKS = 256
RES_STAGED = 4
RES_SLOTS = 4
# K4: one warp per block and a ring of THOMAS_STAGES station slots in
# shared memory (csrc/line_gs.cu: kWarp, kStages).  Lines per block (a
# power of two ≤ THOMAS_WARP) are chosen so that a colour spreads over
# about THOMAS_BLOCKS blocks (two per SM of an H100) or more; z stays
# in shared memory while the block's bytes stay within THOMAS_ZSHARED.
# The values come from timing every plan on the card at 64³, 128³,
# 32×256² and 256³ (chip_smoke.thomas_plans; PERF.md §6).
THOMAS_WARP = 32
THOMAS_STAGES = 6
THOMAS_BLOCKS = 256
THOMAS_ZSHARED = 96 * 1024
SMEM_MAX = 232448          # shared memory one block may use (H100)
MAX_LANES = 65535          # lanes of one K3/K4 launch (the grid's y extent)
_PLANES = NLINE + 5        # ring planes per slot: factors, r or e
_PLANES_GZ = NLINE + 10    # ... and z, when z is in global memory

ResidualGeometry = namedtuple('ResidualGeometry', [
    'cy', 'cz',            # the colour's transverse parity
    'counts',              # its lines per transverse axis
    'rows', 'lines',       # line rows and z-lines per block
    'xplanes',             # stations per block
    'staged',              # e staged in shared memory (else read directly)
    'blocks', 'threads',   # the launch per lane (blocks == 0: no line)
    'smem_bytes',          # dynamic shared memory per block
    'lanes',               # batch lanes (the grid's y extent)
])

ThomasGeometry = namedtuple('ThomasGeometry', [
    'cy', 'cz',            # the colour's transverse parity
    'counts',              # active lines per transverse axis
    'blocks', 'threads',   # the launch per lane (blocks == 0: no line)
    'lines_per_block',     # lines one block (one warp) runs
    'z_shared',            # z in shared memory (else global scratch)
    'planes',              # ring planes per station slot
    'smem_bytes',          # dynamic shared memory per block
    'lanes',               # batch lanes (the grid's y extent)
])

FactorGeometry = namedtuple('FactorGeometry', [
    'lines',               # lines of the stack, all four parities
    'blocks', 'threads',   # the launch (blocks == 0: no line)
])

LineState = namedtuple('LineState', [
    'axis',       # 0, 1, 2: the lines' direction in the level's frame
    'shape',      # cell shape in the rotated frame (lines along x)
    'arrays',     # rotated (eta_x, eta_y, eta_z, zeta, hx, hy, hz)
    'st',         # η edge sums (stx, sty, stz) of the rotated frame
    'w',          # ζ face weights (wx, wy, wz)
    'ih',         # inverse widths (ihx, ihy, ihz)
    'factors',    # (nx, NLINE, 2, 2, ny2, nz2) complex, or None (rebuilt)
    'lanes',      # None, or a lane state's lane → group table (int32, B)
    'storage',    # None, or BF16: st, w (and s at each call) in bfloat16
    'fstorage',   # None, or BF16: the factor stack in bfloat16
], defaults=(None, None))
# A lane state's η (arrays[:3]), st and factors carry a leading group
# axis (G, ...); ζ, w and the widths are shared by every group.  A
# bfloat16 tensor of complex values has a trailing (re, im) axis of 2.


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        BF16_LAUNCHES[k] = 0


def _line_dims(rshape):
    """(ny2, nz2): lines per transverse parity (interior lines halved)."""
    return rshape[1] // 2, rshape[2] // 2


def _entry_size(dtype, storage=None):
    """Bytes of one complex entry of ``dtype`` stored in ``storage``."""
    size = complex_size(dtype)
    if storage is not None:
        check_storage(dtype, storage)
        return size // 2
    return size


def factor_bytes(shape, axis, dtype=torch.complex128, storage=None):
    """Bytes of the factor stack of ``axis``-lines of a level in
    ``dtype``, stored in ``storage``."""
    rs = smoothers.rotate_shape(shape, axis)
    ny2, nz2 = _line_dims(rs)
    return rs[0] * NLINE * 4 * ny2 * nz2 * _entry_size(dtype, storage)


def cache_budget(device):
    """Bytes of factor stacks one solve may keep cached on ``device``."""
    device = torch.device(device)
    if device.type != 'cuda':
        return math.inf
    total = torch.cuda.get_device_properties(device).total_memory
    return LINE_SHARE * total


def keep_stack(meter, nbytes, device):
    """Whether a solve whose cached stacks take ``meter['bytes']`` may
    keep ``nbytes`` more on ``device`` (:func:`cache_budget`); if so,
    they are added to the meter."""
    keep = meter['bytes'] + nbytes <= cache_budget(device)
    if keep:
        meter['bytes'] += nbytes
    return keep


def _stack(ar, rs, st, w, ih, groups=None, fstorage=None, plain=False):
    """Factor stack of the rotated frame: K5 where :func:`._build.kernels`
    says so and not ``plain``, else the plain elimination; stored in
    ``fstorage`` (the plain elimination's float32 stack rounded once, as
    K5 rounds on write).  ``st``/``w`` are the unrounded η sums and ζ
    weights.

    With ``groups`` (a lane state's G) one stack per group, K5 once per
    group into the group's slice of a (G, ...) stack.
    """
    kern = not plain and _build.kernels(ar[0])
    if groups is None:
        if not kern:
            return to_storage(smoothers.line_factor_stack(ar, rs), fstorage)
        return factor(st, w, ih, rs, storage=fstorage)
    out = torch.empty((groups, rs[0], NLINE, 2, 2, *_line_dims(rs)),
                      dtype=st[0].dtype, device=ar[0].device)
    for g in range(groups):
        if kern:
            factor(tuple(t[g] for t in st), w, ih, rs, out=out[g])
        else:
            out[g] = smoothers.line_factor_stack(_group_arrays(ar, g), rs)
    return out


def _group_arrays(ar, g):
    """One group's (eta_x, eta_y, eta_z, zeta, hx, hy, hz) of a lane
    state's arrays."""
    return tuple(a[g] for a in ar[:3]) + tuple(ar[3:])


def _params(ar):
    """η sums, ζ weights and inverse widths of a rotated frame."""
    eta_x, eta_y, eta_z, zeta, hx, hy, hz = ar
    st = tuple(t.contiguous() for t in
               stencil.eta_edge_sums(eta_x, eta_y, eta_z))
    w = tuple(t.contiguous() for t in stencil.zeta_face_weights(zeta))
    ih = tuple((1.0 / h).contiguous() for h in (hx, hy, hz))
    return st, w, ih


def line_factors(arrays, shape, axis):
    """Factor stack of ``axis``-lines of a level (rotated frame).

    K5 where :func:`._build.kernels` says so, else the plain elimination
    (:func:`.smoothers.line_factor_stack`).
    """
    ar = smoothers.rotate_arrays(arrays, axis)
    return _stack(ar, smoothers.rotate_shape(shape, axis), *_params(ar))


def line_state(arrays, shape, axis, factors=True, lanes=None, storage=None,
               fstorage=None, stack=None):
    """Field-independent state of ``axis``-line relaxation on a level.

    The counterpart of the JAX package's per-(level, axis) cache
    (``_level_fstacks``: ``rotate_arrays``, ``line_params`` and
    ``line_factors``), unpadded.  Without ``factors`` the stack is not
    kept: each smoothing call rebuilds it (the memory rule of the
    solver).  The stack is K5's where :func:`._build.kernels` says so,
    else the plain elimination's.  ``stack`` is a stack
    built before (another state's of the same level and axis, in
    ``fstorage``) to keep instead of building one.

    ``storage`` :data:`~emg3d_tpu_torch.dtypes.BF16` stores the η sums
    and ζ weights in bfloat16 (and s at each call), ``fstorage`` the
    factor stack; both only in complex64, and only in one-lane states.

    ``lanes`` (int32, B entries on the arrays' device) makes a lane
    state: η in ``arrays`` then carries a leading axis of G frequency
    groups (ζ and the widths are shared), and ``lanes[b]`` is lane b's
    group.
    """
    ar = smoothers.rotate_arrays(arrays, axis)
    rs = smoothers.rotate_shape(shape, axis)
    st, w, ih = _params(ar)
    check_storage(st[0].dtype, storage)
    check_storage(st[0].dtype, fstorage)
    groups = None
    if lanes is not None and (storage or fstorage):
        raise ValueError("a lane state stores in its solve's precision: "
                         "batched solves take no bfloat16 storage")
    if lanes is not None:
        groups = ar[0].shape[0]
        if (ar[0].ndim != 4 or lanes.dtype != torch.int32 or lanes.ndim != 1
                or lanes.device != ar[0].device or not 0 < len(lanes)
                <= MAX_LANES):
            raise ValueError(f"a lane state takes η of (groups, ...) and "
                             f"1 to {MAX_LANES} int32 lanes on its device; "
                             f"got η {tuple(ar[0].shape)}, lanes "
                             f"{lanes.dtype} {tuple(lanes.shape)} on "
                             f"{lanes.device}")
        lo, hi = int(lanes.min()), int(lanes.max())
        if lo < 0 or hi >= groups:
            raise ValueError(f"lane groups {lo}..{hi}; the state has "
                             f"{groups}")
    if stack is not None:
        fac = stack
    else:
        fac = _stack(ar, rs, st, w, ih, groups, fstorage) \
            if factors else None
    return LineState(int(axis), rs, ar, tuple(to_storage(t, storage)
                                              for t in st),
                     tuple(to_storage(t, storage) for t in w), ih, fac,
                     lanes, storage, fstorage)


def lane_count(state):
    """Lanes a line state relaxes at once (1 for a one-lane state)."""
    return 1 if state.lanes is None else len(state.lanes)


def lane_state(state, g):
    """Group ``g``'s one-lane :class:`LineState` of a lane state (views;
    its factor stack, where the lane state keeps one)."""
    fac = None if state.factors is None else state.factors[g]
    return LineState(state.axis, state.shape, _group_arrays(state.arrays, g),
                     tuple(t[g] for t in state.st), state.w, state.ih, fac,
                     None, state.storage, state.fstorage)


def factor_geometry(shape, threads=FACTOR_WARP):
    """K5's launch on a rotated level ``shape`` (lines along x).

    One line per thread in blocks of one warp: the fastest geometry on
    the card at every shape timed.  ``threads`` (a multiple of 32 up to
    FACTOR_THREADS) forces larger blocks (timings on the card).  Returns
    a :data:`FactorGeometry`.
    """
    nx, ny, nz = shape
    lines = 4 * (ny // 2) * (nz // 2)
    if threads % 32 or not 32 <= threads <= FACTOR_THREADS:
        raise ValueError(f"K5: {threads} threads per block; a multiple of "
                         f"32 up to {FACTOR_THREADS}")
    if lines == 0 or nx == 0:
        return FactorGeometry(lines, 0, 0)
    return FactorGeometry(lines, -(-lines // threads), threads)


def factor(st, w, ih, shape, geometry=None, out=None, storage=None,
           stations=None):
    """The factor stack of a rotated level, built on the card (K5).

    ``st``, ``w`` and ``ih`` are the rotated frame's η edge sums, ζ face
    weights and inverse widths (unrounded: a full-precision
    :class:`LineState`'s), contiguous CUDA tensors, complex128/float64
    or complex64/float32; ``shape`` its cell shape (lines along x).
    Returns a new ``(nx, NLINE, 2, 2, ny2, nz2)`` stack of st's dtype,
    every plane written by the kernel; with ``storage``
    :data:`~emg3d_tpu_torch.dtypes.BF16` (complex64) the elimination runs
    in float32 and the kernel stores bfloat16, ``(..., nz2, 2)``.
    ``geometry`` forces a :func:`factor_geometry` (timings on the
    card).  ``out`` is a contiguous stack of that shape to write instead
    (a group's slice of a lane state's stack).  ``stations`` < nx
    factors the segment of the first ``stations`` stations of every line
    (no PEC end; a ``(stations, ...)`` stack): the interior segment of a
    line split over ranks (:mod:`..parallel.lines`).  The plain version
    is :func:`.smoothers.line_factor_stack` (rounded once to
    ``storage``; its first ``stations`` stations for a segment).
    """
    _cuda(st[0])
    nx, ny, nz = shape
    ns = nx if stations is None else int(stations)
    if not 1 <= ns <= nx:
        raise ValueError(f"factor: {ns} stations of a level of {nx}")
    cdt = st[0].dtype
    complex_size(cdt)
    check_storage(cdt, storage)
    want = {'st': (((nx, ny - 1, nz - 1), (nx - 1, ny, nz - 1),
                    (nx - 1, ny - 1, nz)), cdt),
            'w': (((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)),
                  REAL_OF[cdt]),
            'ih': (((nx,), (ny,), (nz,)), REAL_OF[cdt])}
    for name, trio in (('st', st), ('w', w), ('ih', ih)):
        shapes, dtype = want[name]
        for t, sh in zip(trio, shapes):
            if (tuple(t.shape) != sh or t.dtype != dtype
                    or t.device != st[0].device or not t.is_contiguous()):
                raise ValueError(
                    f"factor: {name} must be contiguous {dtype} of shapes "
                    f"{shapes} on {st[0].device}; got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
    if nx < 2:
        raise ValueError(f"factor: a level of {nx} station(s); K5 takes 2 "
                         f"or more")
    g = factor_geometry(shape) if geometry is None else geometry
    want = (ns, NLINE, 2, 2, *_line_dims(shape))
    odt = cdt
    if storage is not None:
        want, odt = want + (2,), storage
    if out is None:
        out = torch.empty(want, dtype=odt, device=st[0].device)
    elif (tuple(out.shape) != want or out.dtype != odt
          or out.device != st[0].device or not out.is_contiguous()):
        raise ValueError(f"factor: out must be a contiguous {odt} "
                         f"{want} on {st[0].device}")
    if g.blocks == 0:
        return out
    err = _build.entry('emg3d_line_factor', cdt, storage)(
        _ptr(out), *(_ptr(t) for t in (*st, *w, *ih)), nx, ny, nz, ns,
        g.blocks, g.threads, _stream(out.device))
    if err != 0:
        raise RuntimeError(f"line_factor kernel launch failed: cudaError "
                           f"{err} (level {tuple(shape)}, {g})")
    LAUNCHES['line_factor'] += 1
    BF16_LAUNCHES['line_factor'] += storage is not None
    return out


def colour_edges(shape, color):
    """The residual entries the Thomas step of ``color`` reads.

    ``shape`` is the rotated-frame cell shape (lines along x); colour
    ``cy + 2·cz`` has the lines (j, k) = (1 + cy + 2q, 1 + cz + 2r).
    Returns, for rx, ry and rz, a triple of ``range``s (x, y, z indices)
    whose product is the component's set: rx on the lines at every
    station, ry(1..nx-1, j-1|j, k) and rz(1..nx-1, j, k-1|k).  The one
    source of K3's launch geometry, of its work count and of the tests.
    No entry lies on the PEC boundary.
    """
    nx, ny, nz = shape
    cy, cz = color % 2, color // 2
    cny, cnz = (ny - cy) // 2, (nz - cz) // 2
    jl = range(1 + cy, 1 + cy + 2 * cny, 2)
    kl = range(1 + cz, 1 + cz + 2 * cnz, 2)
    return ((range(0, nx), jl, kl),
            (range(1, nx), range(cy, cy + 2 * cny), kl),
            (range(1, nx), jl, range(cz, cz + 2 * cnz)))


def _slices(ranges):
    return tuple(slice(r.start, r.stop, r.step) for r in ranges)


def colour_edge_masks(shape, color, device='cpu'):
    """Boolean masks of :func:`colour_edges` over the (rx, ry, rz)
    shapes."""
    nx, ny, nz = shape
    shapes = ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
              (nx + 1, ny + 1, nz))
    out = []
    for sh, rng in zip(shapes, colour_edges(shape, color)):
        m = torch.zeros(sh, dtype=torch.bool, device=device)
        m[_slices(rng)] = True
        out.append(m)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def residual_geometry(shape, color, rows=RES_ROWS, lines=RES_LINES,
                      xplanes=None, staged=None, lanes=1,
                      dtype=torch.complex128):
    """K3's launch for one colour of a rotated level, over ``lanes``
    batch lanes, for fields of ``dtype`` (the ring's bytes at its element
    size; the rule is the same for both; the ring holds e alone, which a
    bfloat16 state keeps in the solve's precision).

    A block owns ``rows`` line rows × ``lines`` lines along z ×
    ``xplanes`` stations of the colour's lines (:func:`colour_edges`)
    and computes their edges with 5·rows·lines threads (rx, ry and rz of
    each station: rows·lines, 2·rows·lines, 2·rows·lines), from a ring
    of RES_SLOTS x-plane slots of e in shared memory, or (``staged``
    False) reading e directly.  ``xplanes`` and ``staged`` default to
    the rule of RES_XPLANES and RES_BLOCKS, counting the blocks of every
    lane (``blocks`` per lane, the launch's grid (blocks, lanes)).
    ``blocks == 0`` when the colour has no line.  With one lane it is
    the one-lane launch; a lane's results do not depend on the geometry.
    """
    rx, _, _ = colour_edges(shape, color)
    counts = (len(rx[1]), len(rx[2]))
    cy, cz = color % 2, color // 2
    threads = -(-5 * rows * lines // 32) * 32
    if threads > 256:
        raise ValueError(f"K3: {rows} rows × {lines} lines need "
                         f"{5 * rows * lines} threads; a block takes 256")
    slot = ((2 * rows + 1) * (2 * lines + 1) + 2 * rows * (2 * lines + 1)
            + (2 * rows + 1) * 2 * lines)
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"K3: {lanes} lanes; a launch takes 1 to "
                         f"{MAX_LANES}")
    slabs = -(-counts[0] // rows) * -(-counts[1] // lines)
    if xplanes is None:
        xplanes = next((x for x in RES_XPLANES
                        if lanes * slabs * -(-shape[0] // x) >= RES_BLOCKS),
                       RES_XPLANES[-1])
    if staged is None:
        staged = xplanes >= RES_STAGED
    smem = RES_SLOTS * slot * complex_size(dtype) if staged else 0
    if smem > SMEM_MAX:
        raise ValueError(f"K3: {smem} B of shared memory per block")
    blocks = slabs * -(-shape[0] // xplanes)
    if counts[0] * counts[1] == 0:
        blocks = 0
    return ResidualGeometry(cy, cz, counts, rows, lines, xplanes,
                            bool(staged), blocks, threads, smem, lanes)


def launch_geometry(shape, color, lines_per_block=None, z_shared=None,
                    lanes=1, dtype=torch.complex128, fstorage=None):
    """Active lines of one colour and the Thomas launch that covers them.

    ``shape`` is the rotated-frame cell shape (lines along x).  Interior
    lines are (j, k) with j in 1..ny-1, k in 1..nz-1; colour
    ``cy + 2·cz`` takes those with (j-1) % 2 == cy and (k-1) % 2 == cz,
    line (1 + cy + 2q, 1 + cz + 2r) at index q·counts[1] + r.  Returns a
    :data:`ThomasGeometry`: block b (one warp) runs lines
    b·lines_per_block onwards; lines per block is the power of two
    ≤ ``THOMAS_WARP`` that spreads the colour over about
    ``THOMAS_BLOCKS`` blocks (or more, at large levels), and z stays in
    shared memory while the block's bytes stay within
    ``THOMAS_ZSHARED``.  Over ``lanes`` batch lanes the rule spreads the
    lines of every lane (``blocks`` per lane, the launch's grid
    (blocks, lanes)); a lane's results do not depend on the plan.
    ``lines_per_block`` and ``z_shared`` force
    another plan (checks and timings on the card); a plan beyond the
    block's shared memory raises.  ``dtype`` is the fields' (the ring's
    and z's bytes at its element size: complex64 keeps z on chip at
    twice the stations).  ``fstorage`` is the factor stack's storage:
    a bfloat16 stack's planes take half the ring (:func:`_slot_bytes`).
    ``blocks == 0`` when the colour has
    no line (e.g. colours 1 and 3 on a level with one interior y-line).
    """
    nx, ny, nz = shape
    cy, cz = color % 2, color // 2
    counts = ((ny - cy) // 2, (nz - cz) // 2)
    total = counts[0] * counts[1]
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"K4: {lanes} lanes; a launch takes 1 to "
                         f"{MAX_LANES}")
    if total == 0:
        return ThomasGeometry(cy, cz, counts, 0, 0, 0, False, 0, 0, lanes)
    lpb = lines_per_block
    if lpb is None:
        want = -(-lanes * total // THOMAS_BLOCKS)
        lpb = min(THOMAS_WARP, 1 << (want - 1).bit_length())
    elif lpb not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"lines_per_block {lpb}: a power of two ≤ "
                         f"{THOMAS_WARP}")
    size = complex_size(dtype)
    fsize = _entry_size(dtype, fstorage)
    ring = THOMAS_STAGES * _slot_bytes(_PLANES, lpb, size, fsize)
    zbytes = nx * 5 * lpb * size
    if z_shared is None:
        z_shared = ring + zbytes <= THOMAS_ZSHARED
    elif z_shared and ring + zbytes > SMEM_MAX:
        raise ValueError(f"z of {lpb} lines of {nx} stations does not fit "
                         f"a block's shared memory")
    planes = _PLANES if z_shared else _PLANES_GZ
    smem = (THOMAS_STAGES * _slot_bytes(planes, lpb, size, fsize)
            + (zbytes if z_shared else 0))
    return ThomasGeometry(cy, cz, counts, -(-total // lpb), THOMAS_WARP,
                          lpb, z_shared, planes, smem, lanes)


def _slot_bytes(planes, lpb, size, fsize):
    """Bytes of one K4 ring slot: the NLINE factor planes of ``lpb`` lines
    at ``fsize`` bytes an entry, padded to the ``size`` of the other
    planes' entries (residuals, fields, z), which follow them
    (csrc/line_gs.cu: slot_bytes)."""
    fbytes = NLINE * lpb * fsize
    return -(-fbytes // size) * size + (planes - NLINE) * lpb * size


def _level_shape(state):
    rs, a = state.shape, state.axis
    return tuple(rs[(i - a) % 3] for i in range(3))


def _check(e, s, state):
    """Shapes, dtypes and devices of a smoothing call, and for the
    kernels its contiguity and lane table; a lane state takes (B, ...)
    fields, its B lanes.  Returns whether the call runs the kernels
    (:func:`._build.kernels`)."""
    nx, ny, nz = _level_shape(state)
    lead = () if state.lanes is None else (len(state.lanes),)
    edges = ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
             (nx + 1, ny + 1, nz))
    dev = e[0].device
    for name, trio in (('e', e), ('s', s)):
        if len(trio) != 3:
            raise ValueError(f"{name}: {len(trio)} tensors, expected 3")
        for t, sh in zip(trio, edges):
            if tuple(t.shape) != lead + sh:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                                 f"{lead + sh} for level {(nx, ny, nz)}")
            if t.device != dev:
                raise ValueError(f"{name}: on {t.device}, e on {dev}")
    fac = state.factors
    groups = () if state.lanes is None else (state.st[0].shape[0],)
    if fac is not None:
        rs = state.shape
        want = groups + (rs[0], NLINE, 2, 2, *_line_dims(rs))
        if state.fstorage is not None:
            want += (2,)
        if tuple(fac.shape) != want:
            raise ValueError(f"factors: shape {tuple(fac.shape)}, expected "
                             f"{want}")
    cdt = e[0].dtype
    complex_size(cdt)
    check_storage(cdt, state.storage)
    check_storage(cdt, state.fstorage)
    groups = {'e': e, 's': s, 'st': state.st, 'w': state.w, 'ih': state.ih,
              'factors': () if fac is None else (fac,)}
    for name, trio in groups.items():
        want = REAL_OF[cdt] if name in ('w', 'ih') else cdt
        if name in ('st', 'w') and state.storage is not None:
            want = state.storage
        if name == 'factors' and state.fstorage is not None:
            want = state.fstorage
        for t in trio:
            if t.dtype != want:
                raise ValueError(f"{name}: {t.dtype} in a {cdt} call of "
                                 f"storage {state.storage}/"
                                 f"{state.fstorage}; expected {want}")
            if t.device != dev:
                raise ValueError(f"{name}: on {t.device}, e on {dev}")
    if not _build.kernels(e[0]):
        return False
    if state.lanes is not None and (state.lanes.device != dev
                                    or state.lanes.dtype != torch.int32):
        raise ValueError(f"lanes: the CUDA kernels take int32 on {dev}; "
                         f"got {state.lanes.dtype} on {state.lanes.device}")
    for name, trio in groups.items():
        for t in trio:
            if not t.is_contiguous():
                raise ValueError(f"{name}: the CUDA kernels take contiguous "
                                 f"tensors")
    return True


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(dev):
    with torch.cuda.device(dev):
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _cuda(t):
    if t.device.type != 'cuda':
        raise ValueError(f"no line-relaxation kernel for {t.device}")


def residual(e, s, state, color, out, geometry=None):
    """``out`` ← s − A e at the edges of ``color`` (K3); returns ``out``.

    ``e``, ``s``, ``out`` are rotated-frame CUDA edge tensors ((B, ...)
    for a lane state: all B lanes in one launch); entries of ``out``
    outside :func:`colour_edges` are left as they are.  A bfloat16 state
    (``storage``) takes ``s`` stored in bfloat16 and launches K3's
    ``_bf16`` instance.  ``geometry`` forces a :func:`residual_geometry`
    (timings on the card).  The plain version is :func:`residual_plain`.
    """
    _cuda(e[0])
    if storage_of(s[0]) != state.storage or storage_of(state.st[0]) != \
            state.storage or storage_of(state.w[0]) != state.storage:
        raise ValueError(f"K3: s {s[0].dtype}, st {state.st[0].dtype} and "
                         f"w {state.w[0].dtype} in a state of storage "
                         f"{state.storage}")
    lanes = lane_count(state)
    g = residual_geometry(state.shape, color, lanes=lanes,
                          dtype=e[0].dtype) if geometry is None else geometry
    if g.lanes != lanes:
        raise ValueError(f"K3: a geometry of {g.lanes} lanes for a state "
                         f"of {lanes}")
    if g.blocks == 0:
        return out
    err = _build.entry('emg3d_line_residual', e[0].dtype, state.storage)(
        *(_ptr(t) for t in (*out, *e, *s, *state.st, *state.w, *state.ih,
                            state.lanes)),
        *state.shape, g.cy, g.cz, *g.counts, g.rows, g.lines, g.xplanes,
        int(g.staged), g.blocks, g.lanes, g.threads, g.smem_bytes,
        _stream(e[0].device))
    if err != 0:
        raise RuntimeError(f"line_residual kernel launch failed: cudaError "
                           f"{err} (colour {color}, shape {state.shape})")
    LAUNCHES['line_residual'] += 1
    BF16_LAUNCHES['line_residual'] += state.storage is not None
    return out


def residual_plain(e, s, state, color, out):
    """Plain version of :func:`residual`: :func:`.stencil.residual_parts`
    copied into ``out`` at the colour's edges only (``s`` in the solve's
    precision; a bfloat16 state rounds it and reads its stored η sums and
    ζ weights, as K3 does)."""
    sw = _plain_params(state)
    if sw is None:
        r = stencil.residual_parts(*s, *e, *state.arrays)
    else:
        r = stencil.residual_sw(*(round_to(t, state.storage) for t in s),
                                *e, *sw)
    for dst, src, rng in zip(out, r, colour_edges(state.shape, color)):
        sl = _slices(rng)
        dst[sl] = src[sl]
    return out


def thomas(e, r, fac, state, color, zs=None, geometry=None, stations=None):
    """Block-Thomas update of one colour's lines, in place (K4).

    ``e``/``r`` are rotated-frame edge tensors, ``fac`` the factor stack
    and ``zs`` an optional ``(nx, 5, ny2·nz2)`` complex scratch for the
    forward sweep where z does not fit the block's shared memory, all
    on the card; for a lane state ``e``, ``r`` and ``zs`` carry the B
    lanes and ``fac`` the G groups, all lanes in one launch.
    ``geometry`` is a forced :func:`launch_geometry` of the colour
    (default: the one it picks).  A bfloat16 ``fac`` (the state's
    ``fstorage``) launches K4's ``_bf16`` instance.  The plain version
    is :func:`.smoothers.line_thomas_x`.  ``stations`` < nx solves the
    segment of the first ``stations`` stations against a segment stack
    (:func:`factor` with ``stations``).  Returns ``e``.
    """
    _cuda(e[0])
    ns = state.shape[0] if stations is None else int(stations)
    held = fac.shape[0 if state.lanes is None else 1]   # stack stations
    if not 1 <= ns <= min(state.shape[0], held) or (
            state.lanes is not None and ns != held):
        raise ValueError(f"K4: {ns} stations of a level of "
                         f"{state.shape[0]} and a stack of {held}")
    if storage_of(fac) != state.fstorage:
        raise ValueError(f"K4: a {fac.dtype} stack in a state of factor "
                         f"storage {state.fstorage}")
    lanes = lane_count(state)
    g = launch_geometry(state.shape, color, lanes=lanes, dtype=e[0].dtype,
                        fstorage=state.fstorage) \
        if geometry is None else geometry
    if g.lanes != lanes:
        raise ValueError(f"K4: a geometry of {g.lanes} lanes for a state "
                         f"of {lanes}")
    if g.blocks == 0:
        return tuple(e)
    if g.z_shared:
        zp = ctypes.c_void_p(None)    # z stays in shared memory
    else:
        zp = _ptr(_scratch(state.shape, e[0], lanes if state.lanes
                           is not None else None) if zs is None else zs)
    err = _build.entry('emg3d_line_thomas', e[0].dtype, state.fstorage)(
        *(_ptr(t) for t in (*e, *r, fac)), zp, _ptr(state.lanes),
        *state.shape, ns, g.cy, g.cz, *g.counts, g.lines_per_block,
        int(g.z_shared), g.planes, THOMAS_STAGES, g.blocks, g.lanes,
        g.threads, g.smem_bytes, _stream(e[0].device))
    if err != 0:
        raise RuntimeError(f"line_thomas kernel launch failed: cudaError "
                           f"{err} (colour {color}, shape {state.shape})")
    LAUNCHES['line_thomas'] += 1
    BF16_LAUNCHES['line_thomas'] += state.fstorage is not None
    return tuple(e)


def thomas_plain(e, r, fac, color, stations=None):
    """Plain version of :func:`thomas` (one-lane): the colour's lines
    (of the first ``stations`` stations) solved by
    :func:`.smoothers.line_thomas_x` and written into ``e`` in place.
    Returns ``e``."""
    out = smoothers.line_thomas_x(tuple(e), tuple(r), fac, color,
                                  stations=stations)
    for dst, src in zip(e, out):
        dst.copy_(src)
    return tuple(e)


def segment_stack(state, stations):
    """The factor stack of the first ``stations`` stations of a rotated
    level's lines (:func:`factor`'s segment: K5 where
    :func:`._build.kernels` says so, else the plain elimination's first
    stations)."""
    ar = state.arrays
    if not _build.kernels(ar[0]):
        return smoothers.line_factor_stack(ar, state.shape)[:stations] \
            .contiguous()
    return factor(state.st, state.w, state.ih, state.shape,
                  stations=stations)


def _rotated(f, axis):
    return tuple(t.contiguous()
                 for t in smoothers.rotate_fields(tuple(f), axis))


def _write_back(e, out, axis):
    """Copy the rotated-frame result ``out`` into ``e`` (in place)."""
    for dst, src in zip(e, smoothers.unrotate_fields(out, axis)):
        if src is not dst:
            dst.copy_(src)
    return tuple(e)


def _scratch(shape, like, lanes=None):
    """K4's global z scratch ``(nx, 5, ny2·nz2)`` of a rotated level,
    ``(lanes, nx, 5, ny2·nz2)`` for a lane state."""
    ny2, nz2 = _line_dims(shape)
    lead = () if lanes is None else (lanes,)
    return torch.empty(lead + (shape[0], 5, ny2 * nz2), dtype=like.dtype,
                       device=like.device)


def _factors(state, plain=False):
    if state.factors is not None:
        return state.factors
    st, w = state.st, state.w
    if state.storage is not None:
        # K5 eliminates from the unrounded sums and weights.
        st, w, _ = _params(state.arrays)
    return _stack(state.arrays, state.shape, st, w, state.ih,
                  None if state.lanes is None else state.st[0].shape[0],
                  state.fstorage, plain)


def _plain_params(state):
    """A bfloat16 state's (η sums, ζ weights, inverse widths) as its
    kernels load them (float32), or None for a full-precision state."""
    if state.storage is None:
        return None
    return (tuple(from_storage(t, True) for t in state.st),
            tuple(from_storage(t) for t in state.w), state.ih)


class Sweep:
    """One line-relaxation call in its state's rotated frame, whose
    x-lines are the lines: the colour steps of :func:`line_relaxation`,
    and of the slab smoothers of :mod:`..parallel.lines`, which exchange
    planes (or solve lines across ranks) between them.

    Holds the rotated ``e`` (``er``, the working copy; ``view`` shows
    it in the level's frame) and ``s`` (stored in the state's
    ``storage``), and K3's residual buffer ``r``, NaN outside the edges
    K3 has written: an entry K4 read outside its colour's edges shows up
    as NaN in the result.  Where :func:`._build.kernels` says so it
    launches the kernels (``kern``), else it takes the plain versions
    step by step (one-lane states in the solve's precision).  The factor
    stack is the state's, or rebuilt (K5) at the first :meth:`solve` of
    a state that caches none.
    """

    def __init__(self, e, s, state):
        self.kern = _check(e, s, state)
        self.e, self.state = e, state
        if self.kern:
            _cuda(e[0])
        a = state.axis
        self.er = tuple(e) if a == 0 else _rotated(e, a)
        self.sr = tuple(to_storage(t, state.storage) for t in (
            smoothers.rotate_fields(tuple(s), a) if state.storage
            else _rotated(s, a)))
        self.view = smoothers.unrotate_fields(self.er, a)
        self.r = tuple(torch.full_like(t, complex(math.nan, math.nan))
                       for t in self.er)
        self._fac = self._zs = None

    def residual(self, color):
        """``r`` ← s − A e at the edges of ``color`` (K3)."""
        fn = residual if self.kern else residual_plain
        fn(self.er, self.sr, self.state, color, self.r)

    def solve(self, color):
        """The colour's lines against the state's stack (K4), in place."""
        st = self.state
        if self._fac is None:
            self._fac = _factors(st, plain=not self.kern)
        if not self.kern:
            thomas_plain(self.er, self.r, self._fac, color)
            return
        if self._zs is None and not launch_geometry(
                st.shape, 0, lanes=lane_count(st), dtype=self.er[0].dtype,
                fstorage=st.fstorage).z_shared:
            self._zs = _scratch(st.shape, self.er[0], None if st.lanes is None
                                else lane_count(st))
        thomas(self.er, self.r, self._fac, st, color, self._zs)

    def finish(self):
        """Write the result into ``e``; returns ``e``."""
        return _write_back(self.e, self.er, self.state.axis)


def line_relaxation_plain(e, s, state, nu, _seq=None):
    """Plain PyTorch version of the colour steps, on any device.

    :func:`.smoothers.line_color_steps` in the state's rotated frame,
    with its cached factor stack (a stack it does not cache is rebuilt
    by the plain elimination); writes the result into ``e`` in place,
    as the kernels do.  A lane state runs all lanes at once, each with
    its group's η and factor stack: the numbers of its :func:`lane_state`
    lane by lane.  A bfloat16 state rounds s, and runs on its stored η
    sums, ζ weights and factors, upcast: the values its kernels load.
    """
    seq = smoothers.line_color_sequence(nu) if _seq is None else list(_seq)
    a = state.axis
    par, fac = state.arrays, _factors(state, plain=True)
    fac = from_storage(fac, True)
    sw = _plain_params(state)
    if sw is not None:
        s = tuple(round_to(t, state.storage) for t in s)
    if state.lanes is not None:
        # Every lane at once, with its group's η and stack.
        idx = state.lanes.long()
        par = tuple(t.index_select(0, idx) for t in par[:3]) + par[3:]
        fac = fac.index_select(0, idx)
    out = smoothers.line_color_steps(_rotated(e, a), _rotated(s, a), par,
                                     fac, seq, sw)
    return _write_back(e, out, a)


def line_relaxation(e, s, state, nu, _seq=None):
    """nu sweeps of 4-colour line Gauss-Seidel along ``state.axis``.

    e, s : (ex, ey, ez) and (sx, sy, sz) edge tensors of the level,
        in its own frame; ``e`` is updated in place.  (B, ...) tensors
        for a lane state: K3 and K4 take all B lanes in each launch.
    state : :func:`line_state` of the level and axis.
    _seq : explicit colour sequence (tests).

    Where :func:`._build.kernels` says so each colour step is
    :meth:`Sweep.residual` (K3) then :meth:`Sweep.solve` (K4), else
    :func:`line_relaxation_plain` runs.  Returns ``e``.
    """
    seq = smoothers.line_color_sequence(nu) if _seq is None else list(_seq)
    if not _check(e, s, state):
        return line_relaxation_plain(e, s, state, nu, _seq=seq)
    sweep = Sweep(e, s, state)
    for color in seq:
        sweep.residual(color)
        sweep.solve(color)
    return sweep.finish()
