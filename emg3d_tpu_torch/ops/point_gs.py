"""Point Gauss-Seidel smoother on Hopper: wrapper, state and plain version.

Replaces the Pallas point smoother of ``emg3d_tpu/ops/pallas_gs.py``
with two hand-written CUDA kernels (``csrc/point_gs.cu``):

- ``factored`` (K1) replaces ``_kernel_resident``: substitution only,
  against LDLᵀ factors built once per level and solve
  (:func:`point_state`, the counterpart of ``pack_factors``), stored
  colour-major (:func:`pack_factors`).
- ``fused`` (K2) replaces ``_kernel``: assembles, factors and solves
  each node block in registers, from the node's η sums and ζ weights
  packed colour-major once per level (:func:`pack_node_data`), or read
  at the node's indices on levels small enough for the ``shared`` plan
  and where the packed data would not fit the card
  (:func:`packs_nodes`).

Both run the whole colour sequence of a smoothing call in one launch,
under a plan that :func:`sweep_plan` picks per level and kernel:
``cluster``, ``grid`` or ``shared`` (one launch, barriers between
colour steps), or ``step`` (one launch per colour step).  The solver
takes, per level, the kernel :func:`point_kernel` names: the faster one
by the times measured on the card, K1 only where its factor stack fits
:data:`FACTOR_SHARE` of the card's memory.

Both kernels come in complex128 and complex64 (the precision the Pallas
kernels compute in): the state's dtype picks the instance.  The plans
and rules are the same for both, every byte count at the element size.
A complex64 state may store its s/params streams in bfloat16
(``storage``, the JAX package's ``pack_params(pdtype=)`` and
``pack_fields(sdtype=)``): the η sums, ζ weights and the source are then
read as bfloat16 and upcast at the load by the kernels' ``_bf16``
instances, the plain version rounds them where the kernels do, and
everything else (e, the widths, K1's factors, K2's packed node data,
built from the rounded sums and weights) stays float32.

One thread per active node; the kernels update the field in place.
:func:`gauss_seidel_point` runs the kernels where
:func:`._build.kernels` says so, else the plain PyTorch version
(:func:`gauss_seidel_point_plain`, the math of
:func:`.smoothers.gauss_seidel_point`).  Where it runs the kernels it
launches or raises: it never falls back, neither to the plain version
nor to another plan or kernel.
"""
import ctypes
import functools
import math
from collections import namedtuple

import torch

from . import _build, smoothers, stencil
from ..dtypes import (REAL_OF, check_storage, complex_size, from_storage,
                      round_to, to_storage)

__all__ = ['PointState', 'point_state', 'gauss_seidel_point',
           'gauss_seidel_point_plain', 'launch_geometry', 'sweep_plan',
           'point_kernel', 'pack_factors', 'unpack_factors',
           'pack_node_data', 'unpack_node_data', 'node_planes',
           'colour_offsets', 'LAUNCHES', 'STEPS', 'BF16_LAUNCHES',
           'reset_launches',
           'factors_fit', 'packs_nodes', 'card_memory', 'grid_capacity',
           'PLANS', 'KERNELS']

# Strict-lower factor entries of the 6×6 node-block LDLᵀ (fixed sparsity
# incl. the (3,2) and (5,4) fill-in), in the plane order of the factor
# stack: planes 0..13 = L[k] for k in LKEYS, planes 14..19 = dinv[0..5].
# Same order as _LKEYS of the JAX package and l_plane() of the kernel.
LKEYS = ((2, 0), (2, 1), (3, 0), (3, 1), (3, 2), (4, 0), (4, 1),
         (4, 2), (4, 3), (5, 0), (5, 1), (5, 2), (5, 3), (5, 4))
NFACTORS = len(LKEYS) + 6
# K2's packed node data: the six η edge sums, then the twelve ζ face
# weights as six (lower, upper) pairs in one complex plane each
# (:func:`node_planes`; NodeParams of csrc/node_block.cuh).
NODE_PLANES = 12

# Share of the card's memory one level's factor stack (K1) or packed
# node data (K2) may take.  A level whose factors would exceed it runs
# K2; one whose node data would, runs K2 on st and w directly.
FACTOR_SHARE = 0.25

KERNELS = ('factored', 'fused')
# A kernel name here forces that kernel on every level that admits it
# (comparisons on the card: chip_smoke.py, profile_solve.py --kernel);
# None applies point_kernel's rule.
FORCE_KERNEL = None
# point_kernel's rule, from the times of both kernels under their chosen
# plans (chip_smoke.phase_kernels' plan table; PERF.md §6): K2 where a
# colour has at least FUSED_NODES nodes.
FUSED_NODES = 18432

# Launches of each kernel, and the colour steps they ran, since the
# last reset_launches(); BF16_LAUNCHES counts those of the ``_bf16``
# instances among them.
LAUNCHES = {'factored': 0, 'fused': 0}
STEPS = {'factored': 0, 'fused': 0}
BF16_LAUNCHES = {'factored': 0, 'fused': 0}

MAX_THREADS = 256
# The launch plans (csrc/point_gs.cu).  The sweep plans take the whole
# colour sequence of a smoothing call in one launch, at most MAX_SEQ
# colour steps (nu ≤ 8): ``cluster`` is one cluster of at most
# MAX_CLUSTER blocks, ``grid`` a cooperative launch of at most
# GRID_BLOCKS blocks (one per SM of an H100; no more than the card
# holds co-resident, :func:`grid_capacity`), both with blocks of 32-256
# threads sized to spread a colour over them; ``shared`` is one block
# of 256 threads whose shared memory holds the whole level (at most
# SMEM_MAX bytes).
PLANS = ('step', 'cluster', 'grid', 'shared')
MAX_SEQ = 64
MAX_CLUSTER = 8
GRID_BLOCKS = 132
SMEM_MAX = 232448
# The plan rule of :func:`sweep_plan`, from the times of every plan of
# both kernels per smoothing call measured on the card
# (chip_smoke.phase_kernels' plan table; PERF.md §6): ``shared`` where
# the level fits a block (K2's level holds no factors, so it fits
# larger levels), ``cluster`` while a colour has at most CLUSTER_NODES
# nodes, ``grid`` up to STEP_NODES, ``step`` above; the two cut-offs
# came out the same for both kernels.
CLUSTER_NODES = 512
STEP_NODES = 131072
# A plan name here forces that plan on every level (comparisons on the
# card: chip_smoke.py, profile_solve.py --plan); None applies the rule.
FORCE_PLAN = None
_PLAN_CODE = {'cluster': 1, 'grid': 2, 'shared': 3}
# The kernel codes of the C interface: K1, K2 on st/w, K2 on packed data.
_KERNEL_CODE = {'factored': 0, 'fused': 1, 'fused_packed': 2}

SweepPlan = namedtuple('SweepPlan', [
    'plan',         # one of PLANS
    'blocks',       # blocks of the sweep launch (0 for 'step': per colour)
    'threads',      # threads per block
    'smem_bytes',   # dynamic shared memory of the sweep launch
    'launches',     # launches of the call
    'steps',        # colour steps with nodes
])

PointState = namedtuple('PointState', [
    'shape',      # cell shape (nx, ny, nz)
    'arrays',     # (eta_x, eta_y, eta_z, zeta, hx, hy, hz)
    'st',         # η edge sums (stx, sty, stz), complex
    'w',          # ζ face weights (wx, wy, wz), real
    'ih',         # inverse widths (ihx, ihy, ihz), real
    'factors',    # colour-major factors (pack_factors), or None
    'nodes',      # colour-major node data (pack_node_data), or None
    'storage',    # None, or BF16: st, w (and s at each call) in bfloat16
], defaults=(None,))


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        STEPS[k] = 0
        BF16_LAUNCHES[k] = 0


def factor_bytes(shape, dtype=torch.complex128):
    """Bytes of a level's factor stack in ``dtype``."""
    nx, ny, nz = shape
    return NFACTORS * (nx - 1) * (ny - 1) * (nz - 1) * complex_size(dtype)


def node_bytes(shape, dtype=torch.complex128):
    """Bytes of a level's packed node data in ``dtype`` (192 per node in
    complex128)."""
    nx, ny, nz = shape
    return NODE_PLANES * (nx - 1) * (ny - 1) * (nz - 1) * complex_size(dtype)


def card_memory(device):
    """Bytes of the card's memory, or None for a device that is not one."""
    device = torch.device(device)
    if device.type != 'cuda':
        return None
    return torch.cuda.get_device_properties(device).total_memory


def factors_fit(shape, device, dtype=torch.complex128):
    """Whether a level's factor stack in ``dtype`` fits FACTOR_SHARE of
    the card."""
    total = card_memory(device)
    return total is None or factor_bytes(shape, dtype) <= FACTOR_SHARE * total


def packs_nodes(shape, device, dtype=torch.complex128, storage=None):
    """Whether a K2 level state packs node data: only on a card, only
    where the level's plans read it (a level that admits the ``shared``
    plan runs it, and that plan holds st and w in shared memory), and
    only where it fits FACTOR_SHARE of the card."""
    total = card_memory(device)
    return (total is not None
            and _shared_bytes(tuple(shape), 'fused', dtype,
                              storage) > SMEM_MAX
            and node_bytes(shape, dtype) <= FACTOR_SHARE * total)


def _most_nodes(shape):
    return max(math.prod(launch_geometry(shape, c)[1]) for c in range(8))


def point_kernel(shape, device, dtype=torch.complex128):
    """The point kernel of a level: ``'factored'`` (K1) or ``'fused'`` (K2).

    :data:`FORCE_KERNEL` if set, else the faster kernel by the card's
    plan table: K2 where a colour has at least FUSED_NODES nodes.  K1
    only where its factor stack fits FACTOR_SHARE of the card
    (:func:`factors_fit`, in the solve's ``dtype``), whatever the rule or
    FORCE_KERNEL say.  Off the card K1 unless forced, and under
    :data:`._build.PLAIN` K1 whatever FORCE_KERNEL says: the plain
    version on factors computed once, as the JAX package's default.
    """
    if FORCE_KERNEL not in (None,) + KERNELS:
        raise ValueError(f"FORCE_KERNEL {FORCE_KERNEL!r}: one of {KERNELS}")
    if _build.PLAIN:
        return 'factored'
    if not factors_fit(shape, device, dtype):
        return 'fused'
    if FORCE_KERNEL is not None:
        return FORCE_KERNEL
    if not _build.kernels(device):
        return 'factored'
    return 'fused' if _most_nodes(tuple(shape)) >= FUSED_NODES \
        else 'factored'


def point_state(arrays, shape, factored=None, storage=None):
    """Field-independent level state of the point smoother.

    Built once per level and solve, on the tensors' device, by torch
    ops: the counterpart of ``pack_params``/``pack_factors`` of the JAX
    package, without their (8,128) padding.  With ``factored`` it holds
    the node-block LDLᵀ factors of K1; without, K2's packed node data
    where :func:`packs_nodes` says so (else None, and K2 reads st and
    w).  ``factored`` None takes the kernel :func:`point_kernel` names
    for the level.  ``storage`` :data:`~emg3d_tpu_torch.dtypes.BF16`
    (complex64 only) stores st and w in bfloat16; K1's factors come from
    the float32 arrays and K2's node data from the rounded st and w, both
    kept in float32, as the JAX package builds them.
    """
    eta_x, eta_y, eta_z, zeta, hx, hy, hz = arrays
    if factored is None:
        factored = point_kernel(shape, eta_x.device,
                                eta_x.dtype) == 'factored'
    st = tuple(t.contiguous() for t in
               stencil.eta_edge_sums(eta_x, eta_y, eta_z))
    w = tuple(t.contiguous() for t in stencil.zeta_face_weights(zeta))
    ih = tuple((1.0 / h).contiguous() for h in (hx, hy, hz))
    check_storage(st[0].dtype, storage)
    factors = nodes = None
    if factored:
        L, dinv = smoothers.node_factors(arrays)
        factors = pack_factors([L[k] for k in LKEYS] + list(dinv), shape)
    elif packs_nodes(shape, st[0].device, st[0].dtype, storage):
        nodes = pack_node_data(tuple(round_to(t, storage) for t in st),
                               tuple(round_to(t, storage) for t in w), shape)
    st = tuple(to_storage(t, storage) for t in st)
    w = tuple(to_storage(t, storage) for t in w)
    return PointState(tuple(shape), tuple(arrays), st, w, ih, factors,
                      nodes, storage)



@functools.lru_cache(maxsize=None)
def colour_offsets(shape, planes=NFACTORS):
    """Offsets of the colours in a colour-major buffer of ``planes``
    planes per node (K1's factors: NFACTORS, K2's node data:
    NODE_PLANES).

    Returns ``(offs, total)``: colour c's planes of n_c nodes each start
    at ``offs[c]``; ``total`` = planes × interior nodes.
    """
    offs, pos = [], 0
    for c in range(8):
        offs.append(pos)
        pos += planes * math.prod(launch_geometry(shape, c)[1])
    return tuple(offs), pos


def _colour_nodes(color):
    """Slices of the colour's nodes in a node-indexed (nx-1, ny-1, nz-1)
    array (zero-based node i0 = ix - 1)."""
    parity = (color % 2, (color // 2) % 2, color // 4)
    return tuple(slice(1 - p, None, 2) for p in parity)


def _colour_views(flat, shape, planes):
    """(colour, its (planes, cnx, cny, cnz) view of ``flat``, its node
    slices) for every colour with nodes."""
    offs, _ = colour_offsets(tuple(shape), planes)
    for c in range(8):
        counts = launch_geometry(shape, c)[1]
        n = math.prod(counts)
        if n:
            yield (flat[offs[c]:offs[c] + planes * n].view(planes, *counts),
                   _colour_nodes(c))


def pack_factors(planes, shape):
    """Colour-major factor buffer of a level (K1's layout).

    ``planes`` are the NFACTORS node-indexed factor planes (LKEYS order,
    then dinv), each broadcastable to ``(nx-1, ny-1, nz-1)``.  Colour
    c's active nodes are packed in the order of the kernel's thread
    index (z fastest), plane after plane: plane p of the colour's node t
    sits at ``offs[c] + p·n_c + t`` (:func:`colour_offsets`).  Same
    bytes as the node-indexed stack (:func:`factor_bytes`).
    """
    nb = tuple(n - 1 for n in shape)
    planes = [torch.broadcast_to(p, nb) for p in planes]
    dtype = functools.reduce(torch.promote_types, (p.dtype for p in planes))
    out = torch.empty(colour_offsets(tuple(shape))[1], dtype=dtype,
                      device=planes[0].device)
    for view, sl in _colour_views(out, shape, NFACTORS):
        view.copy_(torch.stack([p[sl] for p in planes]))
    return out


def unpack_factors(flat, shape):
    """Inverse of :func:`pack_factors`: the node-indexed stack
    ``(NFACTORS, nx-1, ny-1, nz-1)``."""
    nb = tuple(n - 1 for n in shape)
    total = colour_offsets(tuple(shape))[1]
    if tuple(flat.shape) != (total,):
        raise ValueError(f"factors: shape {tuple(flat.shape)}, expected "
                         f"({total},) for level {tuple(shape)}")
    out = torch.empty((NFACTORS, *nb), dtype=flat.dtype, device=flat.device)
    for view, sl in _colour_views(flat, shape, NFACTORS):
        out[(slice(None),) + sl] = view
    return out


def node_planes(st, w):
    """K2's node-indexed inputs: the six η sums at each interior node's
    block edges, and its twelve ζ face weights as six (lower, upper)
    pairs, as views of ``st`` and ``w`` (csrc/node_block.cuh lists
    them)."""
    stx, sty, stz = st
    wx, wy, wz = w
    sums = (stx[:-1], stx[1:], sty[:, :-1], sty[:, 1:], stz[:, :, :-1],
            stz[:, :, 1:])
    pairs = ((wz[:-1, :-1, 1:-1], wz[:-1, 1:, 1:-1]),
             (wz[1:, :-1, 1:-1], wz[1:, 1:, 1:-1]),
             (wy[:-1, 1:-1, :-1], wy[:-1, 1:-1, 1:]),
             (wy[1:, 1:-1, :-1], wy[1:, 1:-1, 1:]),
             (wx[1:-1, :-1, :-1], wx[1:-1, :-1, 1:]),
             (wx[1:-1, 1:, :-1], wx[1:-1, 1:, 1:]))
    return sums, pairs


def pack_node_data(st, w, shape):
    """Colour-major node data of a level (K2's layout): NODE_PLANES
    complex planes per node, laid out as :func:`pack_factors` lays out
    the factors: the six η sums, then the six ζ weight pairs with the
    lower weight in the real and the upper in the imaginary part
    (:func:`node_planes`).  Copied colour by colour, without
    level-sized temporaries."""
    sums, pairs = node_planes(st, w)
    dtype = torch.promote_types(st[0].dtype, torch.complex64)
    out = torch.empty(colour_offsets(tuple(shape), NODE_PLANES)[1],
                      dtype=dtype, device=st[0].device)
    for view, sl in _colour_views(out, shape, NODE_PLANES):
        for p, t in enumerate(sums):
            view[p].copy_(t[sl])
        for p, (lo, hi) in enumerate(pairs):
            view[6 + p].real.copy_(lo[sl])
            view[6 + p].imag.copy_(hi[sl])
    return out


def unpack_node_data(flat, shape):
    """Inverse of :func:`pack_node_data`: ``(sums, pairs)`` node-indexed,
    as :func:`node_planes` gives them."""
    nb = tuple(n - 1 for n in shape)
    total = colour_offsets(tuple(shape), NODE_PLANES)[1]
    if tuple(flat.shape) != (total,):
        raise ValueError(f"nodes: shape {tuple(flat.shape)}, expected "
                         f"({total},) for level {tuple(shape)}")
    out = torch.empty((NODE_PLANES, *nb), dtype=flat.dtype,
                      device=flat.device)
    for view, sl in _colour_views(flat, shape, NODE_PLANES):
        out[(slice(None),) + sl] = view
    return (tuple(out[:6]),
            tuple((p.real.contiguous(), p.imag.contiguous())
                  for p in out[6:]))


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


def _rule(shape, max_nodes, kernel, dtype, storage):
    if _shared_bytes(shape, kernel, dtype, storage) <= SMEM_MAX:
        return 'shared'
    if max_nodes <= CLUSTER_NODES:
        return 'cluster'
    return 'grid' if max_nodes <= STEP_NODES else 'step'


def _shared_bytes(shape, kernel='factored', dtype=torch.complex128,
                  storage=None):
    """The shared plan's dynamic shared memory: the whole level (e, s,
    η sums and, for K1, factors complex; ζ weights and inverse widths
    real), at the element sizes of ``dtype``; with bfloat16 ``storage``
    s, the η sums and the ζ weights at half those sizes.  The kernel
    stacks the tensors by element size, largest first, so no tensor
    needs padding to its alignment."""
    nx, ny, nz = shape
    edges = (nx * (ny + 1) * (nz + 1) + (nx + 1) * ny * (nz + 1)
             + (nx + 1) * (ny + 1) * nz)
    sums = (nx * (ny - 1) * (nz - 1) + (nx - 1) * ny * (nz - 1)
            + (nx - 1) * (ny - 1) * nz)
    faces = (nx + 1) * ny * nz + nx * (ny + 1) * nz + nx * ny * (nz + 1)
    fac = NFACTORS * (nx - 1) * (ny - 1) * (nz - 1) \
        if kernel == 'factored' else 0
    size = complex_size(dtype)
    if storage is None:
        return size * (2 * edges + sums + fac) + size // 2 * (faces + nx + ny
                                                               + nz)
    return (size * (edges + fac) + size // 2 * (edges + sums + nx + ny + nz)
            + size // 4 * faces)


def _spread(most, max_blocks):
    """(blocks, threads): a colour of ``most`` nodes over at most
    ``max_blocks`` blocks of 32-256 threads, one warp per block until
    every block has one."""
    threads = min(MAX_THREADS, 32 * max(1, -(-most // (32 * max_blocks))))
    return max(1, min(max_blocks, -(-most // threads))), threads


def _kernel_name(kernel):
    if kernel not in KERNELS:
        raise ValueError(f"unknown point-smoother kernel {kernel!r}; one "
                         f"of {KERNELS}")
    return kernel


def sweep_plan(shape, nu=None, seq=None, plan=None, kernel='factored',
               dtype=torch.complex128, storage=None):
    """The launch plan of one smoothing call of ``kernel`` on a level, in
    ``dtype`` (complex128 or complex64: the same rule, the ``shared``
    plan's bytes at the element size) and ``storage`` (bfloat16 s/params
    streams: the ``shared`` plan's bytes at their size).

    ``seq`` is the colour sequence (default ``color_sequence(nu)``, 8·nu
    steps; more than MAX_SEQ raise).  ``plan`` forces one of PLANS (else
    :data:`FORCE_PLAN`, else the kernel's rule: ``shared`` where the
    whole level fits a block's shared memory, ``cluster`` while a colour
    has at most CLUSTER_NODES nodes, ``grid`` up to STEP_NODES, ``step``
    above).  A plan the level does not admit (``shared`` beyond
    SMEM_MAX) raises.  Returns a :data:`SweepPlan`; ``launches`` is 1
    for a sweep plan and the number of colour steps with nodes for
    ``step``, whose launches take their geometry from
    :func:`launch_geometry`.
    """
    seq = smoothers.color_sequence(nu) if seq is None else seq
    return _sweep_plan(tuple(shape), tuple(seq), plan or FORCE_PLAN,
                       _kernel_name(kernel), dtype, storage)


@functools.lru_cache(maxsize=None)
def _sweep_plan(shape, seq, plan, kernel, dtype, storage):
    if not 0 < len(seq) <= MAX_SEQ:
        raise ValueError(f"{len(seq)} colour steps: the sweep takes 1 to "
                         f"{MAX_SEQ} (nu ≤ {MAX_SEQ // 8})")
    nodes = [math.prod(launch_geometry(shape, c)[1]) for c in seq]
    steps = sum(1 for n in nodes if n)
    most = max(nodes)
    plan = plan or _rule(shape, most, kernel, dtype, storage)
    if plan not in PLANS:
        raise ValueError(f"unknown sweep plan {plan!r}; one of {PLANS}")
    blocks, threads, smem = 0, MAX_THREADS, 0
    if plan == 'cluster':
        blocks, threads = _spread(most, MAX_CLUSTER)
    elif plan == 'grid':
        blocks, threads = _spread(most, GRID_BLOCKS)
    elif plan == 'shared':
        blocks, smem = 1, _shared_bytes(shape, kernel, dtype, storage)
        if smem > SMEM_MAX:
            raise ValueError(f"shared plan: level {shape} takes {smem} B, "
                             f"a block holds {SMEM_MAX}")
    if steps == 0:
        launches = 0
    else:
        launches = steps if plan == 'step' else 1
    return SweepPlan(plan, blocks, threads, smem, launches, steps)


def plans_admitted(shape, kernel='factored'):
    """The plans a level admits for ``kernel`` (every plan but
    ``shared`` beyond SMEM_MAX)."""
    return tuple(p for p in PLANS if p != 'shared'
                 or _shared_bytes(shape, kernel) <= SMEM_MAX)


def grid_capacity(kernel='factored', dtype=torch.complex128, storage=None):
    """Blocks of the grid plan the card holds co-resident, for
    ``kernel`` ('factored', 'fused' or 'fused_packed') in ``dtype`` and
    ``storage`` (needs the card)."""
    n = ctypes.c_int(0)
    err = _build.entry('emg3d_point_gs_grid_capacity', dtype, storage)(
        _KERNEL_CODE[kernel], ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"point_gs grid capacity query failed: "
                           f"cudaError {err}")
    return n.value


def _plain_fact(state):
    f = unpack_factors(state.factors, state.shape)
    return ({k: f[i] for i, k in enumerate(LKEYS)},
            [f[len(LKEYS) + i] for i in range(6)])


def gauss_seidel_point_plain(e, s, state, nu, _seq=None, _mode=None):
    """Plain PyTorch version of the colour steps, on any device.

    Runs :func:`.smoothers.color_steps` and writes the result into ``e``
    in place, as the kernels do.  The fused mode re-factors the blocks
    every colour step, as its kernel does; the factored mode uses the
    state's factors.  A bfloat16 state rounds s to bfloat16 and runs on
    its stored η sums and ζ weights, upcast: the values its kernels
    load.
    """
    mode = _resolve_mode(state, _mode)
    seq = smoothers.color_sequence(nu) if _seq is None else list(_seq)
    fact = _plain_fact(state) if mode == 'factored' else None
    sw = None
    if state.storage is not None:
        s = tuple(round_to(t, state.storage) for t in s)
        sw = (tuple(from_storage(t, True) for t in state.st),
              tuple(from_storage(t) for t in state.w), state.ih)
    cur = smoothers.color_steps(tuple(e), s, state.arrays, seq, fact=fact,
                                sw=sw)
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
    nodes = (nx - 1) * (ny - 1) * (nz - 1)
    return {
        'e': ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
              (nx + 1, ny + 1, nz)),
        'arrays': (cells,) * 4 + ((nx,), (ny,), (nz,)),
        'st': ((nx, ny - 1, nz - 1), (nx - 1, ny, nz - 1),
               (nx - 1, ny - 1, nz)),
        'w': ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)),
        'ih': ((nx,), (ny,), (nz,)),
        'factors': ((NFACTORS * nodes,),),
        'nodes': ((NODE_PLANES * nodes,),),
    }


def _check(e, s, state):
    """Shapes, devices and dtypes of a smoothing call; returns whether it
    runs the kernels (:func:`._build.kernels`)."""
    shapes = _state_shapes(state.shape)
    shapes['s'] = shapes['e']
    if state.storage is not None:
        # Complex bfloat16: a trailing (re, im) axis.
        shapes['st'] = tuple(sh + (2,) for sh in shapes['st'])
    groups = {'e': e, 's': s, 'arrays': state.arrays, 'st': state.st,
              'w': state.w, 'ih': state.ih}
    for name in ('factors', 'nodes'):
        if getattr(state, name) is not None:
            groups[name] = (getattr(state, name),)
    dev = e[0].device
    kern = _build.kernels(e[0])
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
    _check_dtypes(groups, dev, kern, state.storage)
    return kern


def _check_dtypes(groups, dev, kern, storage=None):
    """One precision for the whole call: e, s, the η sums, the factors
    and node data (and η in ``arrays``) of one complex dtype, complex128
    or complex64, and the ζ weights and widths (ζ and h in ``arrays``)
    of its real dtype; with bfloat16 ``storage`` the η sums and ζ
    weights in bfloat16 (s is stored at each call); a mixed set raises,
    on every device.  The kernels (``kern``) also take contiguous
    tensors only."""
    cdt = groups['e'][0].dtype
    complex_size(cdt)
    check_storage(cdt, storage)
    for name, trio in groups.items():
        for n, t in enumerate(trio):
            cplx = name in ('e', 's', 'st', 'factors', 'nodes') or (
                name == 'arrays' and n < 3)
            want = cdt if cplx else REAL_OF[cdt]
            if storage is not None and name in ('st', 'w'):
                want = storage
            if t.dtype != want:
                raise ValueError(f"{name}: {t.dtype} in a {cdt} state; "
                                 f"expected {want}")
            if kern and name != 'arrays' and not t.is_contiguous():
                raise ValueError(f"{name}: the CUDA kernels take "
                                 f"contiguous tensors on {dev}")


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def gauss_seidel_point(e, s, state, nu, _mode=None, _seq=None,
                       _plan=None):
    """nu sweeps of 8-colour point Gauss-Seidel; updates ``e`` in place.

    e, s : (ex, ey, ez) and (sx, sy, sz) edge tensors of the level.
    state : :func:`point_state` of the level.
    _mode : 'factored' or 'fused' pins a kernel (tests and the chip
        smoke run); by default the state decides (factors present ->
        factored).
    _seq : explicit colour sequence (tests).
    _plan : forces the launch plan (:func:`sweep_plan`).

    Where :func:`._build.kernels` says so, the kernel runs under the
    level's :func:`sweep_plan`: K1 on the state's factors, K2 on its
    packed node data (on st and w where the state has none, and always
    in the ``shared`` plan, which holds st and w in shared memory); else
    :func:`gauss_seidel_point_plain`.  A bfloat16 state launches the
    kernels' ``_bf16`` instances, on s stored in bfloat16 for the call.
    Returns ``e``.
    """
    kern = _check(e, s, state)
    mode = _resolve_mode(state, _mode)
    seq = smoothers.color_sequence(nu) if _seq is None else list(_seq)
    if not kern:
        return gauss_seidel_point_plain(e, s, state, nu, _seq=seq,
                                        _mode=mode)

    if len(seq) > MAX_SEQ:
        # Longer calls (nu > 8) run as consecutive sweeps.
        for i in range(0, len(seq), MAX_SEQ):
            gauss_seidel_point(e, s, state, nu, _mode=mode,
                               _seq=seq[i:i + MAX_SEQ], _plan=_plan)
        return tuple(e)

    dtype, storage = e[0].dtype, state.storage
    shape = state.shape
    s = tuple(to_storage(t, storage) for t in s)
    ptrs = [_ptr(t) for t in (*e, *s, *state.st, *state.w, *state.ih)]
    with torch.cuda.device(e[0].device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    plan = sweep_plan(shape, seq=seq, plan=_plan, kernel=mode, dtype=dtype,
                      storage=storage)
    if mode == 'factored':
        code, buf, planes = 'factored', state.factors, NFACTORS
    elif state.nodes is not None and plan.plan != 'shared':
        code, buf, planes = 'fused_packed', state.nodes, NODE_PLANES
    else:
        code, buf, planes = 'fused', None, NODE_PLANES
    if plan.plan != 'step':
        if plan.launches == 0:
            return tuple(e)
        geom, offs = _colour_table(shape, planes)
        err = _build.entry('emg3d_point_gs_sweep', dtype, storage)(
            _PLAN_CODE[plan.plan], _KERNEL_CODE[code], *ptrs, _ptr(buf),
            *shape, geom, offs, _seq_array(tuple(seq)), len(seq),
            plan.blocks, plan.threads, plan.smem_bytes, stream)
        if err != 0:
            raise RuntimeError(f"point_gs {mode} sweep kernel ({plan.plan} "
                               f"plan) launch failed: cudaError {err} "
                               f"(shape {shape}, {plan})")
        LAUNCHES[mode] += 1
        BF16_LAUNCHES[mode] += storage is not None
        STEPS[mode] += plan.steps
        return tuple(e)
    offs = colour_offsets(shape, planes)[0]
    step = _build.entry('emg3d_point_gs_step', dtype, storage)
    for color in seq:
        first, counts, blocks, threads = launch_geometry(shape, color)
        if blocks == 0:
            continue
        at = ctypes.c_void_p(None if buf is None else buf.data_ptr()
                             + offs[color] * buf.element_size())
        err = step(_KERNEL_CODE[code], *ptrs, at,
                                      *shape, *first, *counts, blocks,
                                      threads, stream)
        if err != 0:
            raise RuntimeError(f"point_gs {mode} kernel launch failed: "
                               f"cudaError {err} (colour {color}, shape "
                               f"{shape})")
        LAUNCHES[mode] += 1
        BF16_LAUNCHES[mode] += storage is not None
        STEPS[mode] += 1
    return tuple(e)


@functools.lru_cache(maxsize=None)
def _colour_table(shape, planes):
    """ctypes arrays of the sweep kernel: per colour (x0, y0, z0, cnx,
    cny, cnz), and the colours' offsets in a buffer of ``planes`` planes
    per node (read-only to C)."""
    geom = []
    for c in range(8):
        first, counts = launch_geometry(shape, c)[:2]
        geom += [*first, *counts]
    offs = colour_offsets(shape, planes)[0]
    return (ctypes.c_int * 48)(*geom), (ctypes.c_longlong * 8)(*offs)


@functools.lru_cache(maxsize=None)
def _seq_array(seq):
    return (ctypes.c_int * len(seq))(*seq)
