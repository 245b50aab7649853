"""Multigrid solve and MG-preconditioned Krylov (the JAX package's
solver.py, in torch).

Counterpart of ``emg3d_tpu/solver.py``: ``solve`` with any ``cycle``
('F', 'V', 'W'), ``semicoarsening`` and ``linerelaxation`` (fixed or
rotating schedules), standalone or as the preconditioner of
``sslsolver`` 'bicgstab' (True), 'cgs' or 'gcrotmk'; and
``solve_batched``, many (source, frequency) pairs on one grid advanced
together.

- A single solve copies its source and the model's properties to the
  device once and derives the rest there: the source's norm, η and ζ
  (:class:`.models.DeviceVolumeModel`) and the zero start field.  The
  level hierarchy (coarse η/ζ, cell widths, transfer weights) is
  built at solve start, on the device, once per semicoarsening
  direction, every hierarchy on the one finest level.  The smoothers'
  field-independent state (point: η edge sums, ζ face weights,
  node-block LDLᵀ factors; line: rotated parameters and block-Thomas
  factor stacks) is built lazily, once per level (and axis) and
  solve; the finest level's line state is shared
  by all hierarchies, and factor stacks are cached only up to a share
  of the card (:data:`.ops.line_gs.LINE_SHARE`).
- The V/W/F recursion (including the ``cycmax − it`` F-cycle trick) runs
  eagerly, cycle by cycle, as the JAX package does on the CPU; PyTorch
  needs no jit, chunked dispatch or compile probes.
- The host loop pulls one residual norm per cycle and applies the
  reference's termination logic (CONVERGED / DIVERGED / STAGNATED /
  MAX-IT); the Krylov solvers take the JAX package's host-scalar route,
  GCROT(m,k) with its basis on the device.
- A batched solve carries a leading lane axis on its fields (and on η
  where the lanes' frequencies differ): residual, transfers and PEC
  masks run on all lanes at once, line relaxation launches K3 and K4
  once for all lanes (K5 once per frequency group), and point smoothing
  launches K1/K2 once per lane.  Its Krylov solvers keep per-lane
  scalars on the device.
- A complex64 source, or any source with the x64 switch off
  (:func:`.dtypes.set_x64`), runs the whole solve in complex64/float32
  (:func:`.dtypes.precision`, read once when a solve starts): the
  levels' arrays in float32, every
  kernel's complex64 instance, and the JAX package's two-float scheme
  to reach tol 1e-6 from float32 storage: the solution as a (hi, lo)
  pair (:func:`.ops.dsres.ds_accumulate`), its residual in double-single
  arithmetic (:func:`.ops.dsres.residual_ds`, K6 on the card), standalone
  multigrid switching to correction-form cycles near the float32 floor
  and every Krylov solve under iterative refinement
  (:func:`_refine_krylov`).  The result is hi + lo in complex128 when the
  lo stream is live (a Laplace-domain field too), else the dtype the
  device computed in, as the JAX package returns it (:func:`_result`).
- A complex64 solve on the card stores in bfloat16 where the JAX
  package's Pallas path does (:data:`BF16_STORAGE`): the smoothers'
  s/params streams in every correction-form smoothing call (standalone
  multigrid, which then runs in correction form from its first cycle,
  and every preconditioner application) and every line-factor stack
  above :data:`FSTACK_BYTES`.  The outer residual stays float32, so
  the fixed point is that of the float32 solve.
"""
import functools
import itertools
import math
from dataclasses import dataclass

import numpy as np
import torch

from . import fields, models, trace, utils
from .dtypes import BF16, COMPLEX, REAL_OF, precision
from .ops import dsres, line_gs, point_gs, stencil, transfers
from .parallel import halo, lines

__all__ = ['solve', 'solve_batched', 'multigrid', 'krylov', 'MGParameters']

# bfloat16 storage of a complex64 solve: the JAX package's
# EMG3D_TPU_BF16_SMOOTH (``_smooth_spdt``, emg3d_tpu/solver.py:1548-1565)
# and its bfloat16 line-factor stacks (``_level_fstacks``, :640-730).
# None stores in bfloat16 on a card and not on the CPU, where the JAX
# package's XLA fallbacks ignore it; True forces it on any device (CPU
# tests), False keeps every stream in float32 (comparisons on the card).
# complex128 and batched solves never store in bfloat16: the JAX
# package's ``_smooth_spdt`` returns None for float64, and
# ``_level_fstacks``/``_level_pparams`` return None for a batch.
BF16_STORAGE = None
# A line-factor stack whose float32 bytes exceed this is stored in
# bfloat16, cached or rebuilt at every call (the JAX package's
# _FSTACK_CACHE_BYTES, emg3d_tpu/solver.py:651).
FSTACK_BYTES = 256_000_000


def _storage(dtype, device):
    """The reduced storage a single solve may use: BF16 or None."""
    if dtype != torch.complex64:
        return None
    on = device.type == 'cuda' if BF16_STORAGE is None else BF16_STORAGE
    return BF16 if on else None


# ======================================================================
# Parameters
# ======================================================================

@dataclass
class MGParameters:
    """Multigrid solver settings (reference parity: solver.py:1043-1364).
    """

    verb: int
    cycle: str
    sslsolver: str
    linerelaxation: int
    semicoarsening: int
    shape_cells: tuple

    tol: float = 1e-6
    maxit: int = 50
    nu_init: int = 0
    nu_pre: int = -1       # -1 = auto-calibrated (see __post_init__)
    nu_coarse: int = 1
    nu_post: int = -1      # -1 = auto-calibrated
    clevel: int = -1

    return_info: bool = False
    log: int = 1
    log_message: str = ''

    def __post_init__(self):
        self._level_all = []
        self._first_cycle = True
        self.it = 0
        self._ssl_it = 0
        self.l2 = 1.0
        self.l2_refe = 1.0
        self.exit_message = ''
        self.time = utils.Time()
        self.runtime_at_cycle = np.array([0.])
        self.error_at_cycle = np.array([0.])
        self.do_return = True

        self._semicoarsening()
        self._linerelaxation()
        self._solver_and_cycle()
        self.max_level

        # Smoothing strength is calibrated per smoother family.  The
        # parallel multicolor point smoother is a true Gauss-Seidel in
        # a colored order, but that order is measurably weaker per
        # sweep than the reference's lexicographic one (two-grid
        # spectral radius 0.27 vs 0.19 at nu=2 on the stretched
        # triaxial model problem); three color-sweeps beat two
        # lexicographic sweeps (0.12 < 0.19) and restore the
        # reference's F-cycle counts (6 on the golden VTI case).
        # Line relaxation shows no such gap and keeps the reference
        # default of 2.  Explicit user values are honored as-is.
        if self.nu_pre < 0:
            self.nu_pre = 2 if self.linerelaxation else 3
        if self.nu_post < 0:
            self.nu_post = 2 if self.linerelaxation else 3

    def __repr__(self):
        return (
            f"   MG-cycle       : {self.cycle!r:17}"
            f"   sslsolver : {self.sslsolver!r}\n"
            f"   semicoarsening : {self._p_sc_dir:17}"
            f"   tol       : {self.tol}\n"
            f"   linerelaxation : {self._p_lr_dir:17}"
            f"   maxit     : {self._maxit}\n"
            f"   nu_{{i,1,c,2}}   : {self.nu_init}, {self.nu_pre}"
            f", {self.nu_coarse}, {self.nu_post}       "
            f"   verb      : {self.verb}\n"
            f"   Original grid  "
            f": {self.shape_cells[0]:3} x {self.shape_cells[1]:3} "
            f"x {self.shape_cells[2]:3}  "
            f"   => {np.prod(self.shape_cells):,} cells\n"
            f"   Coarsest grid  : {self.pclevel['vnC'][0]:3} "
            f"x {self.pclevel['vnC'][1]:3} x {self.pclevel['vnC'][2]:3}  "
            f"   => {self.pclevel['nC']:,} cells\n"
            f"   Coarsest level : {self.pclevel['clevel'][0]:3} "
            f"; {self.pclevel['clevel'][1]:3} ;{self.pclevel['clevel'][2]:4} "
            f"  {self.pclevel['message']}\n"
        )

    @property
    def max_level(self):
        """Per-axis 2-divisibility depth -> per-sc_dir coarsest level.

        Fills ``clevel`` (a 4-entry table indexed by sc_dir: which
        axes keep coarsening) and ``pclevel`` (coarsest-grid QC info,
        including the 'not optimal' warning when an axis stops early
        on an odd factor or never reaches 3 coarsenings).
        """
        nx, ny, nz = self.shape_cells
        if min(self.shape_cells) < 2:
            raise ValueError(
                "Nr. of cells must be at least two in each direction\n"
                f"Provided shape: ({nx}, {ny}, {nz}).")

        requested = None if self.clevel < 0 else int(self.clevel)

        def depth(n):
            d = 0
            while n % 2 == 0 and n > 2:
                d += 1
                n //= 2
            return d if requested is None else min(d, requested)

        dx, dy, dz = (depth(n) for n in self.shape_cells)
        # sc_dir semantics: 0 = coarsen all axes, 1 = y/z only,
        # 2 = x/z only, 3 = x/y only.
        self.clevel = np.array([max(dx, dy, dz), max(dy, dz),
                                max(dx, dz), max(dx, dy)])

        shape_coarse = tuple(n >> d for n, d
                             in zip(self.shape_cells, (dx, dy, dz)))
        limit = np.inf if requested is None else requested
        stopped_early = any(
            d < limit and n > 7
            for d, n in zip((dx, dy, dz), shape_coarse))
        too_shallow = any(d < min(limit, 3) for d in (dx, dy, dz))
        self.pclevel = {
            'nC': int(np.prod(shape_coarse)),
            'vnC': shape_coarse,
            'clevel': np.array([dx, dy, dz]),
            'message': "  :: Grid not optimal for MG solver ::"
                       if stopped_early or too_shallow else "",
        }

    def cprint(self, info, verbosity, **kwargs):
        if self.verb > verbosity:
            if self.log != 0:
                self.log_message += str(info) + '\n'
            if self.log >= 0:
                print(info, **kwargs)

    def one_liner(self, l2_last, last=False):
        info = f":: emg3d_tpu_torch :: {l2_last/self.l2_refe:.1e}; "
        if self.sslsolver:
            info += f"{self._ssl_it}({self.it}); "
        else:
            info += f"{self.it}; "
        info += f"{self.time.runtime}"
        if last:
            self.cprint(info + f"; {self.exit_message}", -100)
        else:
            self.cprint(info, -100, end='\r')

    @staticmethod
    def _direction_schedule(value, name, rotation, hi):
        """Normalize a direction knob to its per-cycle digit schedule.

        ``True`` selects the standard rotation, a single integer
        ``0..hi`` a fixed direction, and any other integer is read as
        a sequence of decimal digits to rotate through (e.g. 1213).

        Returns ``(digits, cycling)``.
        """
        if value is True:
            return np.asarray(rotation), True
        digits = np.asarray([int(d) for d in str(abs(int(value)))])
        fixed = len(digits) == 1 and 0 <= int(value) <= hi
        if not fixed and digits.max(initial=0) > hi:
            raise ValueError(
                f"`{name}` must be False, True, an integer in 0..{hi}, "
                f"or a multi-digit rotation of those (e.g. 1213); got "
                f"{name}={value}.")
        return digits, not fixed

    def _semicoarsening(self):
        digits, cycling = self._direction_schedule(
            self.semicoarsening, 'semicoarsening', (1, 2, 3), 3)
        self.sc_cycle = itertools.cycle(digits) if cycling else False
        self.sc_dir = next(self.sc_cycle) if self.sc_cycle else digits[0]
        self.semicoarsening = self.sc_dir != 0
        self._p_sc_dir = f"{self.semicoarsening} {digits}"
        self._raw_sc_cycle = digits

    def _linerelaxation(self):
        digits, cycling = self._direction_schedule(
            self.linerelaxation, 'linerelaxation', (4, 5, 6), 7)
        self.lr_cycle = itertools.cycle(digits) if cycling else False
        self.lr_dir = next(self.lr_cycle) if self.lr_cycle else digits[0]
        self.linerelaxation = self.lr_dir != 0
        self._p_lr_dir = f"{self.linerelaxation} {digits}"
        self._raw_lr_cycle = digits

    _SSL_SOLVERS = ('bicgstab', 'cgs', 'gcrotmk')

    def _solver_and_cycle(self):
        if self.sslsolver is True:
            self.sslsolver = 'bicgstab'
        if self.sslsolver not in (False,) + self._SSL_SOLVERS:
            raise ValueError(
                f"`sslsolver` must be True, False, or one of "
                f"{list(self._SSL_SOLVERS)}; got "
                f"sslsolver={self.sslsolver!r}.")
        if self.cycle not in ('F', 'V', 'W', None):
            raise ValueError(
                f"`cycle` must be 'F', 'V', 'W', or None; got "
                f"cycle={self.cycle}.")
        if not self.sslsolver and not self.cycle:
            raise ValueError(
                f"At least one of `cycle` and `sslsolver` is required; "
                f"got cycle={self.cycle}, sslsolver={self.sslsolver}.")

        self.cycmax = 2 if self.cycle in ('F', 'W') else 1
        self._maxcycle = max(len(self._raw_sc_cycle),
                             len(self._raw_lr_cycle))
        self._maxit = f"{self.maxit}"
        self.ssl_maxit = 0
        if self.sslsolver:
            self.ssl_maxit = self.maxit
            if self.cycle is not None:
                self.maxit = self._maxcycle
                self._maxit += f" ({self.maxit})"


# ======================================================================
# Direction helpers (reference parity: solver.py:1466-1572)
# ======================================================================

def _current_sc_dir(sc_dir, shape):
    """Adjusted semicoarsening direction for a given grid shape."""
    xsc = shape[0] % 2 != 0 or shape[0] < 3 or sc_dir == 1
    ysc = shape[1] % 2 != 0 or shape[1] < 3 or sc_dir == 2
    zsc = shape[2] % 2 != 0 or shape[2] < 3 or sc_dir == 3

    if xsc:
        if ysc:
            return 6
        elif zsc:
            return 5
        else:
            return 1
    elif ysc:
        return 4 if zsc else 2
    elif zsc:
        return 3
    return 0


def _coarsen_flags(sc_dir):
    """(coarsen_x, coarsen_y, coarsen_z) from an sc_dir code."""
    return (sc_dir not in [1, 5, 6],
            sc_dir not in [2, 4, 6],
            sc_dir not in [3, 4, 5])


def _current_lr_dir(lr_dir, shape):
    """Suppress line relaxation along 2-cell dimensions."""
    lr_dir = int(lr_dir)
    if shape[0] == 2:
        lr_dir = {1: 0, 5: 3, 6: 2, 7: 4}.get(lr_dir, lr_dir)
    if shape[1] == 2:
        lr_dir = {2: 0, 4: 3, 6: 1, 7: 5}.get(lr_dir, lr_dir)
    if shape[2] == 2:
        lr_dir = {3: 0, 4: 2, 5: 1, 7: 6}.get(lr_dir, lr_dir)
    return lr_dir


def _lr_axes(lr_dir):
    """Line-relaxation axes for an lr_dir code (in x, y, z order)."""
    axes = []
    if lr_dir in [1, 5, 6, 7]:
        axes.append(0)
    if lr_dir in [2, 4, 6, 7]:
        axes.append(1)
    if lr_dir in [3, 4, 5, 7]:
        axes.append(2)
    return tuple(axes)


# ======================================================================
# Level hierarchy
# ======================================================================

class _Level:
    """Per-level data: model parameters, widths, transfer weights."""

    __slots__ = ('shape', 'arrays', 'coarsen', 'rweights', 'pweights',
                 'nodes', 'h_np', 'pstate', 'lstate', 'meter', 'lanes',
                 'bf16', 'slab')

    def __init__(self, shape, arrays, h_np, nodes, meter, lanes=None):
        self.shape = shape          # cell shape
        self.arrays = arrays        # (eta_x, eta_y, eta_z, zeta, hx, hy, hz)
        self.h_np = h_np            # numpy widths (for weight building)
        self.nodes = nodes          # numpy node vectors
        self.coarsen = None
        self.rweights = None
        self.pweights = None
        self.pstate = None          # storage -> point-smoother state (lazy)
        self.lstate = {}            # (axis, storage) -> line state (lazy)
        self.meter = meter          # cached factor bytes, solve-wide
        self.lanes = lanes          # a batched solve's Lanes, or None
        self.bf16 = False           # the solve may store in bfloat16
        # A sharded level's parallel.halo.Slab (shape and arrays are then
        # this rank's slab), or None.
        self.slab = None


class Lanes:
    """The lanes of a batched solve and their frequency groups.

    ``group[b]`` is lane b's group (lanes of one frequency share one; the
    groups are numbered in order of first appearance), ``reps[g]`` the
    first lane of group g, and ``index`` the group table as an int32
    tensor on the solve's device (the line kernels read it).
    """

    def __init__(self, keys, device):
        order = {}
        self.group = np.array([order.setdefault(k, len(order)) for k in keys],
                              dtype=np.int64)
        self.reps = tuple(int(np.argmax(self.group == g))
                          for g in range(len(order)))
        self.index = torch.tensor(self.group, dtype=torch.int32,
                                  device=device)


def level_shapes(shape, sc_dir, clevel):
    """The cell shapes of the hierarchy for a top-level ``sc_dir`` from
    a level of cell shape ``shape``, finest first: the one rule of
    :func:`build_levels` and of the sharded solve's partitions."""
    shapes = [tuple(shape)]
    for _ in range(clevel):
        coarsen = _coarsen_flags(_current_sc_dir(sc_dir, shapes[-1]))
        shapes.append(tuple(n // 2 if c else n
                            for n, c in zip(shapes[-1], coarsen)))
    return shapes


def build_levels(grid, vmodel, sc_dir, clevel, device, meter, lanes=None,
                 dtype=COMPLEX, fine=None):
    """Build the full level hierarchy for one top-level sc_dir.

    η is of the complex ``dtype`` on ``device`` (complex128 or complex64;
    a real Laplace-domain η is promoted, its imaginary part stays exactly
    zero), ζ, the widths and the transfer weights of its real dtype: the
    host's float64 values rounded once, as the JAX package's
    ``build_levels`` casts them (``emg3d_tpu/solver.py:361-366``).  Every
    coarse level is then computed from these arrays in their precision.
    ``meter`` is the solve's ``{'bytes': n}`` of cached line factors.

    ``vmodel``'s η and ζ are host arrays (a :class:`.models.VolumeModel`)
    or tensors (a :class:`.models.DeviceVolumeModel`), which are taken as
    they are where they already lie on ``device`` in ``dtype``.  It may
    be a list of VolumeModels, one per lane of a batched solve
    (reference parity: emg3d_tpu/solver.py:371-390): η is then stacked
    per lane (B, nx, ny, nz) and ζ taken from the first (it does not
    depend on the frequency).  ``lanes`` (a :class:`Lanes`) marks the
    levels of a batched solve.  ``fine``, the finest level's arrays of
    another hierarchy of the same solve, is taken as this one's finest
    level (``vmodel`` is then not read).
    """
    def tens(a, dt):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=dt)
        t = torch.tensor(np.asarray(a), dtype=dt, device=device)
        trace.count('copy.h2d_bytes', trace.nbytes((t,)))
        return t

    cplx, real = dtype, REAL_OF[dtype]

    h_np = [np.asarray(h, dtype=np.float64) for h in grid.h]
    nodes = [np.r_[0., np.cumsum(h)] + o
             for h, o in zip(h_np, grid.origin)]
    shape = tuple(grid.shape_cells)
    arrays = fine if fine is not None else \
        (*_finest_params(vmodel, tens, cplx, real),
         *[tens(h, real) for h in h_np])
    levels = [_Level(shape, arrays, h_np, nodes, meter, lanes)]

    shapes = level_shapes(shape, sc_dir, clevel)
    for cshape in shapes[1:]:
        cur = levels[-1]
        coarsen = tuple(n != nc for n, nc in zip(cur.shape, cshape))
        cur.coarsen = coarsen

        # Coarse grid geometry.
        cnodes = [cur.nodes[ax][::2] if coarsen[ax] else cur.nodes[ax]
                  for ax in range(3)]
        ch_np = [np.diff(cn) for cn in cnodes]

        # Restriction / prolongation weights (host, then device).
        rw, pw = [None]*3, [None]*3
        for ax in range(3):
            if coarsen[ax]:
                centers = (cur.nodes[ax][:-1] + cur.nodes[ax][1:]) / 2
                ccenters = (cnodes[ax][:-1] + cnodes[ax][1:]) / 2
                rw[ax] = tuple(tens(w, real) for w in
                               transfers.restrict_weights_1d(
                                   cur.nodes[ax], centers, cur.h_np[ax],
                                   cnodes[ax], ccenters, ch_np[ax]))
                pw[ax] = tens(transfers.prolong_weights_1d(
                    cur.nodes[ax], cnodes[ax]), real)
        cur.rweights = tuple(rw)
        cur.pweights = tuple(pw)

        # Coarse model parameters by child-cell summation.
        a = cur.arrays
        cex = transfers.restrict_model_parameter(a[0], coarsen)
        cey = cex if a[1] is a[0] else \
            transfers.restrict_model_parameter(a[1], coarsen)
        cez = cex if a[2] is a[0] else \
            transfers.restrict_model_parameter(a[2], coarsen)
        czeta = transfers.restrict_model_parameter(a[3], coarsen)
        carrays = (cex, cey, cez, czeta, *[tens(h, real) for h in ch_np])
        levels.append(_Level(cshape, carrays, ch_np, cnodes, meter, lanes))
    return levels


def _finest_params(vmodel, tens, cplx, real):
    """(η_x, η_y, η_z, ζ) of the finest level from ``vmodel`` (one
    volume model, or a batched solve's list of them), through ``tens``;
    η_y and η_z are η_x where every model shares it."""
    if not isinstance(vmodel, (list, tuple)):
        eta_x = tens(vmodel.eta_x, cplx)
        eta_y = eta_x if vmodel.eta_y is vmodel.eta_x \
            else tens(vmodel.eta_y, cplx)
        eta_z = eta_x if vmodel.eta_z is vmodel.eta_x \
            else tens(vmodel.eta_z, cplx)
        return eta_x, eta_y, eta_z, tens(vmodel.zeta, real)

    def eta(name):
        return tens(np.stack([np.asarray(getattr(vm, name))
                              for vm in vmodel]), cplx)

    eta_x = eta('eta_x')
    eta_y = eta_x if all(vm.eta_y is vm.eta_x for vm in vmodel) \
        else eta('eta_y')
    eta_z = eta_x if all(vm.eta_z is vm.eta_x for vm in vmodel) \
        else eta('eta_z')
    return eta_x, eta_y, eta_z, tens(vmodel[0].zeta, real)


# ======================================================================
# The MG cycle
# ======================================================================

def _level_state(lev, storage=None):
    """The level's point-smoother state for s/params streams stored in
    ``storage``, built once per level, storage and solve (the JAX package
    keys its ``pparams`` by the stream dtype, solver.py:749-752); for the
    levels of a batched solve one per frequency group (a list).  Each
    holds what the kernel :func:`.ops.point_gs.point_kernel` names for
    the level needs."""
    if lev.pstate is None:
        lev.pstate = {}
    if storage not in lev.pstate:
        with trace.span('levels.state'):
            if lev.lanes is None:
                lev.pstate[storage] = point_gs.point_state(
                    lev.arrays, lev.shape, storage=storage)
            else:
                lev.pstate[storage] = [
                    point_gs.point_state(_lane_arrays(lev.arrays, b),
                                         lev.shape)
                    for b in lev.lanes.reps]
    return lev.pstate[storage]


def _lane_arrays(arrays, b):
    """Lane b's 3-D (eta_x, eta_y, eta_z, zeta, hx, hy, hz) of a level
    whose η may be stacked per lane."""
    return tuple(a[b] if i < 3 and a.ndim == 4 else a
                 for i, a in enumerate(arrays))


def _group_arrays(lev):
    """A batched level's arrays with η stacked per frequency group (G,
    nx, ny, nz): the input of its lane line states."""
    reps = torch.tensor(lev.lanes.reps, device=lev.arrays[0].device)
    done = {}

    def grp(a):
        if id(a) not in done:
            done[id(a)] = (a.index_select(0, reps) if a.ndim == 4
                           else a.unsqueeze(0))
        return done[id(a)]
    return tuple(grp(a) for a in lev.arrays[:3]) + tuple(lev.arrays[3:])


def _line_state(lev, axis, storage=None):
    """The level's ``axis``-line state for s/params streams stored in
    ``storage``, built once per level, axis, storage and solve (the JAX
    package's key ``(ax, str(spdt))``, solver.py:682).

    Its factor stack is stored in bfloat16 where the solve may store so
    (``lev.bf16``) and the float32 stack's bytes exceed
    :data:`FSTACK_BYTES` (the JAX package's rule, solver.py:697-719);
    the states of one axis share one stack.  Memory rule: the stack is
    kept only while the solve's cached stacks stay within
    :func:`.ops.line_gs.cache_budget`; otherwise the state holds none and
    every smoothing call rebuilds it (the JAX package's ``()`` sentinel).
    The numbers are the same either way.
    """
    state = lev.lstate.get((axis, storage))
    if state is None:
        with trace.span('levels.state'):
            state = _new_line_state(lev, axis, storage)
        lev.lstate[(axis, storage)] = state
    return state


def _new_line_state(lev, axis, storage):
    """A new state of :func:`_line_state`."""
    dtype = lev.arrays[0].dtype
    other = next((st for (ax, _), st in lev.lstate.items()
                  if ax == axis), None)
    if other is not None:
        # The stack does not depend on the streams' storage.
        return line_gs.line_state(
            lev.arrays, lev.shape, axis, factors=False, storage=storage,
            fstorage=other.fstorage, stack=other.factors)
    fstorage = BF16 if lev.bf16 and line_gs.factor_bytes(
        lev.shape, axis, dtype) > FSTACK_BYTES else None
    nbytes = line_gs.factor_bytes(lev.shape, axis, dtype, fstorage)
    if lev.lanes is not None:
        # One stack per frequency group; K3 and K4 take every lane.
        nbytes *= len(lev.lanes.reps)
    keep = line_gs.keep_stack(lev.meter, nbytes, lev.arrays[0].device)
    if lev.lanes is None:
        return line_gs.line_state(lev.arrays, lev.shape, axis, factors=keep,
                                  storage=storage, fstorage=fstorage)
    return line_gs.line_state(_group_arrays(lev), lev.shape, axis,
                              factors=keep, lanes=lev.lanes.index)


def _smooth(e, s, lev, nu, lr_dir, storage=None):
    """Smoothing dispatch (reference parity: solver.py:461-523).

    Point smoothing where the level's lr_dir is 0, else line relaxation
    along each of its axes in turn.  Updates ``e`` in place and returns
    it.  On a batched level the point smoother runs lane by lane (its
    kernel launched once per lane, with the lane's group state), line
    relaxation all lanes at once.  ``storage`` stores the s/params
    streams (the JAX package's ``spdt``); callers set it only where the
    smoothed system is a correction system.
    """
    if nu <= 0:
        return e
    if lev.slab is not None:
        # A level on slabs smooths in float32: the JAX package's sharded
        # smoothers take no stream dtype (shmap.py's point and line
        # bodies); only the replicated levels store in ``storage``.
        storage = None
    lr = _current_lr_dir(lr_dir, _level_shape(lev))
    if lr == 0:
        state = _level_state(lev, storage)
        if lev.slab is not None:
            with trace.span('smooth.point'):
                return halo.gauss_seidel_point_sharded(e, s, state, nu,
                                                       lev.slab)
        if lev.lanes is None:
            with trace.span('smooth.point'):
                return point_gs.gauss_seidel_point(e, s, state, nu)
        for b, g in enumerate(lev.lanes.group):
            with trace.span('smooth.point'):
                point_gs.gauss_seidel_point(tuple(t[b] for t in e),
                                            tuple(t[b] for t in s),
                                            state[g], nu)
        return e
    for ax in _lr_axes(lr):
        if lev.slab is not None:
            # Lines on this rank's slab (within it, across ranks, or the
            # level gathered: parallel.lines).
            with trace.span('smooth.line'):
                e = lines.relax(e, s, lev, ax, nu,
                                local_state=lambda ax=ax: _line_state(
                                    lev, ax, storage))
            continue
        state = _line_state(lev, ax, storage)
        with trace.span('smooth.line'):
            e = line_gs.line_relaxation(e, s, state, nu)
    return e


def _residual_e(e, s, arrays):
    return stencil.residual_parts(*s, *e, *arrays)


def _restrict(r, lev, clev):
    """The coarse level's source from the residual ``r`` of ``lev``:
    restricted, PEC applied; on a sharded level across its ranks."""
    if lev.slab is not None:
        return halo.restrict(r, lev, clev)
    rc = transfers.restrict(*r, lev.rweights, lev.coarsen)
    return stencil.pec_mask_apply(*rc)


def _prolongate(e, ec, lev, clev):
    """``e`` plus the coarse correction ``ec``, PEC applied."""
    if lev.slab is not None:
        return halo.prolongate(e, ec, lev, clev)
    e = transfers.prolongate(*e, *ec, lev.pweights, lev.coarsen)
    return stencil.pec_mask_apply(*e)


def _space(lev):
    """The sums of a level (:class:`.parallel.halo.Space`): its rank's
    slab, summed over the ranks, or the whole level."""
    return halo.WHOLE if lev.slab is None else lev.slab


def _fresh(v, lev):
    """``v`` with its ghosts refreshed from their owners where ``lev``
    is sharded (a residual is wrong on its slab's ghost edges, and the
    smoothers and transfers read a source's ghosts); in place."""
    if lev.slab is not None:
        lev.slab.refresh(v)
    return v


def _level_norm(e, s, lev):
    """‖s − A e‖₂ on a level, summed across the ranks where it is
    sharded."""
    return _space(lev).norm(_residual_e(e, s, lev.arrays))


def _level_shape(lev):
    """A level's global cell shape (a sharded level's ``shape`` is its
    slab's)."""
    return lev.shape if lev.slab is None else lev.slab.shape


def _edge_shapes(shape):
    nx, ny, nz = shape
    return ((nx, ny+1, nz+1), (nx+1, ny, nz+1), (nx+1, ny+1, nz))


def _gs_info(it, level, cycmax, shape, norm):
    """Debug line after a smoothing step (verb>4; reference format)."""
    nx, ny, nz = shape
    return (f"     {it:2} {level} {cycmax} [{nx:3}, {ny:3}, "
            f"{nz:3}]: {norm:.3e} ")


def _mg_rec(e, s, levels, lvl, cycmax, new_cycmax, conf, dbg=None,
            storage=None):
    """Recursive multigrid body (reference parity: solver.py:478-604).

    Includes the ``new_cycmax = cycmax - it`` F-cycle construction; the
    top level (``lvl == 0``) runs one cycle per call.  ``dbg`` is the
    MGParameters instance when verb>4: each smoothing step then logs
    its residual norm.  ``storage`` goes to every smoothing call.
    """
    (nu_pre, nu_coarse, nu_post, cycle, lr_dir) = conf
    lev = levels[lvl]

    def report(it_, cycmax_, tag):
        if dbg is not None:
            nrm = _level_norm(e, s, lev)
            dbg.cprint(_gs_info(it_, lvl, cycmax_, _level_shape(lev), nrm)
                       + tag, 4)

    if lvl == len(levels) - 1:
        # Coarsest grid: nu_coarse smoothing steps act as direct solve.
        e = _smooth(e, s, lev, nu_coarse, lr_dir, storage)
        report(0, 1, "coarsest level")
        return e

    if lvl == 0 or new_cycmax == 0 or cycle != 'F':
        cycmax_here = cycmax
    else:
        cycmax_here = new_cycmax

    it = 0
    while it < cycmax_here:
        e = _smooth(e, s, lev, nu_pre, lr_dir, storage)
        if nu_pre > 0:
            report(it, cycmax_here, "pre-smoothing")

        rc = _restrict(_residual_e(e, s, lev.arrays), lev, levels[lvl + 1])
        lead = tuple(e[0].shape[:-3])        # the lanes of a batched solve
        ec = tuple(torch.zeros(lead + sh, dtype=e[0].dtype,
                               device=e[0].device)
                   for sh in _edge_shapes(levels[lvl + 1].shape))

        ec = _mg_rec(ec, rc, levels, lvl + 1,
                     2 if cycle in ['F', 'W'] else 1,
                     cycmax_here - it, conf, dbg, storage)

        e = _prolongate(e, ec, lev, levels[lvl + 1])

        e = _smooth(e, s, lev, nu_post, lr_dir, storage)
        if nu_post > 0:
            report(it, cycmax_here, "post-smoothing")

        it += 1
        if lvl == 0:
            break
    return e


def run_one_cycle(e, s, levels, conf, nu_init=0, dbg=None, storage=None):
    """One top-level MG cycle; returns the new field tensors.  ``storage``
    stores the smoothers' s/params streams (correction systems only)."""
    if nu_init > 0:
        e = _smooth(e, s, levels[0], nu_init, conf[4], storage)
        if dbg is not None:
            nrm = _level_norm(e, s, levels[0])
            dbg.cprint(_gs_info(0, 0, 1, _level_shape(levels[0]), nrm)
                       + "initial smoothing", 4)
    return _mg_rec(e, s, levels, 0, 2 if conf[3] in ['F', 'W'] else 1, 0,
                   conf, dbg, storage)


def _norm_b(rx, ry, rz):
    """Per-lane norms of batched fields: (B,) real tensor."""
    return torch.sqrt(sum((r.real**2 + r.imag**2).reshape(r.shape[0], -1)
                          .sum(1) for r in (rx, ry, rz)))


def residual_norms(e, s, arrays):
    """Per-lane ‖s − A e‖₂ of batched fields, as a numpy array."""
    return _fetch(_norm_b(*_residual_e(e, s, arrays)))


def _fetch(t):
    """``t`` as a numpy array on the host (one blocking fetch)."""
    with trace.span('sync'):
        return t.cpu().numpy()


# ======================================================================
# Host loop
# ======================================================================

def _upload(flds, dtype, device):
    """Host Fields' components on ``device`` in ``dtype``, per component
    a (B, ...) stack of the B fields (stacked on the host where B > 1)."""
    with trace.span('setup.upload'):
        out = []
        for name in ('fx', 'fy', 'fz'):
            a = [np.asarray(getattr(f, name)) for f in flds]
            out.append(torch.tensor(np.stack(a) if len(a) > 1 else a[0][None],
                                    dtype=dtype, device=device))
        trace.count('copy.h2d_bytes', trace.nbytes(out))
    return tuple(out)


def _records(sfields, grid):
    """The sources' records (:attr:`.fields.SourceField.record`), or None
    unless every source still holds one on ``grid``'s edges."""
    shapes = _edge_shapes(grid.shape_cells)
    recs = [getattr(sf, 'record', None) for sf in sfields]
    if any(r is None for r in recs) or any(
            sf.shape != shapes for sf in sfields):
        return None
    return recs


def _place(records, shapes, dtype, device):
    """Recorded sources on ``device`` in ``dtype``: per component a
    (B, ...) stack of the lanes' zeros with every lane's values written
    in one indexed write.  Only the records' indices and values cross
    (two copies), and the stacks equal those of the lanes' dense arrays
    uploaded, to the bit."""
    with trace.span('setup.upload'):
        sizes = [int(np.prod(sh)) for sh in shapes]
        idx, vals = [], []
        for c, n in enumerate(sizes):
            for b, rec in enumerate(records):
                idx.append(rec[c][0] + b * n)
                vals.append(rec[c][1])
        counts = [sum(r[c][0].size for r in records) for c in range(3)]
        idx, vals = np.concatenate(idx), np.concatenate(vals)
        trace.count('copy.h2d_bytes', idx.nbytes + vals.nbytes)
        idx = torch.from_numpy(idx).to(device).split(counts)
        vals = torch.from_numpy(vals).to(device=device,
                                         dtype=dtype).split(counts)
        out = []
        for c, shape in enumerate(shapes):
            t = torch.zeros((len(records),) + tuple(shape), dtype=dtype,
                            device=device)
            for b, rec in enumerate(records):
                zero = rec[c][2]
                if zero.view(np.uint8).any():      # a negative zero
                    t[b].fill_(zero[0].item())
            t.view(-1)[idx[c]] = vals[c]
            out.append(t)
    return tuple(out)


def _sources(sfields, grid, dtype, device):
    """The sources ``sfields`` on ``device`` in ``dtype``, per component
    a (B, ...) stack of the B lanes, placed from their records
    (:func:`_place`) or their dense arrays uploaded (:func:`_upload`);
    and the records, or None."""
    records = _records(sfields, grid)
    if records is not None:
        trace.count('source.compact', len(sfields))
        return _place(records, sfields[0].shape, dtype, device), records
    trace.count('source.dense', len(sfields))
    return _upload(sfields, dtype, device), None


class _SolveContext:
    """Per-solve state: device fields and level hierarchies per sc_dir.

    The precision is ``dtype``, by default the source's
    (:func:`.dtypes.precision`): complex64 puts s, e and every level in
    complex64/float32.
    ``e_lo`` is the two-float lo stream of the solution once it is live
    (complex64 solves), else None.  ``storage`` is the reduced storage
    the solve may use (BF16 for a complex64 single solve where
    :data:`BF16_STORAGE` allows it, else None); the levels on slabs
    store in float32 whatever it is.  ``sharding`` (the normalized
    option, or None) distributes the levels
    (:func:`.parallel.halo.shard_levels`); ``s`` and ``e`` (and
    ``e_lo``) are then this rank's slabs of the finest level.

    ``sfield`` and ``efield`` are host Fields, or an unsharded solve's
    component tensors already on ``device`` in ``dtype`` (taken as they
    are); ``efield`` None starts an unsharded solve from zeros made on
    the device.  A source from :func:`.fields.get_source_field` keeps
    its nonzero edges and builds its dense host arrays only on access:
    an unsharded or batched solve places it on the device from those
    edges (:func:`_place`), a sharded one reads its dense arrays.
    """

    def __init__(self, grid, vmodel, sfield, efield, var, device,
                 sharding=None, dtype=None):
        self.grid = grid
        self.vmodel = vmodel
        self.var = var
        self.device = device
        self.sharding = sharding
        self.dtype = dtype if dtype is not None \
            else precision(sfield.dtype)[1]
        self._levels = {}
        self._ds_params = None
        self.meter = {'bytes': 0}
        self.lanes = None
        self.e_lo = None
        self.storage = _storage(self.dtype, torch.device(device))
        self.s = self.put(sfield)
        if efield is None and sharding is None:
            with trace.span('setup.zero_field'):
                self.e = tuple(torch.zeros(sh, dtype=self.dtype,
                                           device=device)
                               for sh in _edge_shapes(grid.shape_cells))
        else:
            self.e = self.put(efield)

    def put(self, fld):
        """A host Field's components on the solve's device, in its dtype
        (this rank's slabs where the finest level is sharded)."""
        if isinstance(fld, tuple):
            return fld
        if self.sharding is None:
            return tuple(t[0] for t in _upload([fld], self.dtype,
                                               self.device))
        with trace.span('setup.upload'):
            # Each rank keeps its slab of the finest level.
            comps = tuple(torch.tensor(np.asarray(f), dtype=self.dtype)
                          for f in (fld.fx, fld.fy, fld.fz))
            fine = self.levels(int(self.var.sc_dir))[0]
            if fine.slab is not None:
                comps = fine.slab.cut_field(comps)
            out = tuple(c.to(self.device) for c in comps)
            trace.count('copy.h2d_bytes', trace.nbytes(out))
        return out

    @classmethod
    def batched(cls, grid, vmodel, s, var, device, lanes):
        """The context of a batched solve: ``s`` the (B, ...) source
        tensors, ``lanes`` their :class:`Lanes`; the field starts at 0."""
        ctx = cls.__new__(cls)
        ctx.grid, ctx.vmodel, ctx.var = grid, vmodel, var
        ctx.device, ctx.lanes = device, lanes
        ctx.sharding = None
        ctx.dtype = s[0].dtype
        ctx.s = s
        ctx.e = tuple(torch.zeros_like(c) for c in s)
        ctx.e_lo = None
        ctx._levels = {}
        ctx._ds_params = None
        ctx.meter = {'bytes': 0}
        ctx.storage = None          # batched solves store in their precision
        return ctx

    def field(self, e=None):
        """A finest-level field (the solution ``e`` by default) on this
        rank, whole (a sharded solve gathers its finest slabs on every
        rank)."""
        e = self.e if e is None else e
        fine = self.levels(int(self.var.sc_dir))[0]
        if fine.slab is None:
            return e
        return fine.slab.gather(e)

    def residual_ds(self, ehi, elo, s):
        """s − A·(ehi + elo) on the finest level in double-single
        arithmetic (:func:`.ops.dsres.residual_ds`), the float32 operator
        built once per solve.  On a slab (its own ``ds_params``, K6 on the
        card) the ghosts of ``ehi`` and ``elo`` are refreshed first (``s``
        keeps valid ghosts: its slab is cut, or scaled, from the whole
        source), and those of the result after: it is the next cycle's
        source."""
        fine = self.levels(int(self.var.sc_dir))[0]
        if self._ds_params is None:
            self._ds_params = dsres.ds_params(fine.arrays)
        r = dsres.residual_ds(_fresh(ehi, fine), _fresh(elo, fine), s,
                              fine.arrays, self._ds_params)
        return _fresh(r, fine)

    def _min_planes(self):
        return self.sharding.get('min_local_planes', 4)

    def _finest_partition(self):
        """The finest level's boundaries shared by the hierarchies of
        every semicoarsening direction the solve's schedule visits
        (:func:`.parallel.halo.joint_partition`), or None where no level
        is sharded."""
        if not hasattr(self, '_finest'):
            mesh = self.sharding['mesh']
            shape = tuple(self.grid.shape_cells)
            hier = []
            for sc in sorted({int(d) for d in self.var._raw_sc_cycle}):
                shapes = level_shapes(shape, sc, int(self.var.clevel[sc]))
                m = halo.sharded_count(shapes, mesh, self._min_planes())
                if m:
                    hier.append(shapes[:m])
            self._finest = halo.joint_partition(mesh, hier) if hier \
                else None
        return self._finest

    def levels(self, sc_dir):
        if sc_dir not in self._levels:
            with trace.span('setup.levels'):
                self._levels[sc_dir] = self._hierarchy(sc_dir)
        return self._levels[sc_dir]

    def _hierarchy(self, sc_dir):
        """The level hierarchy of ``sc_dir``, on the solve's device.  The
        finest level is the same in every hierarchy: a later one shares
        the first one's parameters and line states (no number
        changes)."""
        clevel = int(self.var.clevel[int(sc_dir)])
        first = next(iter(self._levels.values()))[0] if self._levels \
            else None
        if self.sharding is None:
            levels = build_levels(
                self.grid, self.vmodel, int(sc_dir), clevel, self.device,
                self.meter, self.lanes, self.dtype,
                fine=None if first is None else first.arrays)
            if first is not None:
                trace.count('levels.fine_shared', 1)
        else:
            # Built on the host, then each rank keeps its slabs of the
            # sharded levels and the replicated levels whole; every
            # hierarchy nests into one partition of the finest level.
            levels = halo.shard_levels(
                build_levels(self.grid, self.vmodel, int(sc_dir),
                             clevel, 'cpu', self.meter, dtype=self.dtype),
                self.sharding['mesh'], self._min_planes(), self.device,
                self._finest_partition())
            if first is not None:
                levels[0].arrays = first.arrays
        for lev in levels:
            # Slabs store in float32 (see _smooth).
            lev.bf16 = self.storage is not None and lev.slab is None
        if first is not None:
            levels[0].lstate = first.lstate
        return levels


def _ds_wanted(e, var):
    """Two-float accumulation applies: complex64 storage and a tol below
    the single-float solution-representation floor (~2e-6 relative)
    (the JAX package's ``_ds_wanted``)."""
    return e[0].dtype == torch.complex64 and float(var.tol) < 2e-5


def multigrid(ctx, var, e=None, s=None, track=True):
    """Run MG cycles with the reference's termination logic.

    If ``e``/``s`` are given, runs on those fields (the Krylov
    preconditioner); else on ctx.e/ctx.s (standalone; stores the
    solution in ``ctx.e``).  One cycle at a time, as the JAX package
    does on the CPU (its chunked and pipelined dispatch exist only for
    the TPU).  ``track`` records the per-cycle runtime and error and
    logs each cycle.

    A standalone complex64 solve switches to two-float (hi, lo) storage
    once the error nears the float32 representation floor
    (:class:`_TwoFloat`); the lo stream lands in ``ctx.e_lo``.  Where the
    solve stores in bfloat16 (``ctx.storage``) and ``nu_init`` is 0, a
    standalone solve runs in correction form from its first cycle, as the
    JAX package's ``corr`` mode (solver.py:1617-1621, 1737-1748): r = s −
    A·e in float32, δ = MG(0, r) with the s/params streams stored in
    bfloat16, e += δ; the same iteration, whose fixed point the bfloat16
    rounding cannot move.  The two-float cycles store so too.
    """
    standalone = e is None
    if standalone:
        e, s = ctx.e, ctx.s
    fine = ctx.levels(int(var.sc_dir))[0]
    l2_last = _level_norm(e, s, fine)
    l2_prev = None
    l2_stag = np.ones(var._maxcycle) * l2_last
    # As a Krylov preconditioner the rhs is a Krylov vector, not the
    # source: judge convergence against this call's own rhs norm.
    refe = var.l2_refe if standalone else l2_last

    dbg = var if var.verb > 4 else None
    if dbg is not None:
        var.cprint("     it cycmax               error", 4)
        var.cprint("      level [  dimension  ]            info\n", 4)
        var.cprint(_gs_info(0, 0, var.cycmax, _level_shape(fine), l2_last)
                   + "initial error", 4)

    it = 0
    first = True
    ds = _TwoFloat(ctx, var, s, _space(fine).norm)
    spdt = ctx.storage if standalone else None
    corr = spdt is not None and var.nu_init == 0
    r = None        # the correction form's residual, once evaluated
    for _ in trace.each('mg.cycle'):
        conf = (var.nu_pre, var.nu_coarse, var.nu_post, var.cycle,
                int(var.lr_dir))
        levels = ctx.levels(int(var.sc_dir))
        nu_init = var.nu_init if first else 0
        if first and var.verb > 3 and var._first_cycle:
            _qc_levels(var._level_all, len(levels), 0,
                       2 if var.cycle in ('F', 'W') else 1, 0,
                       var.cycle)
        first = False

        if ds.lo is not None:
            e, l2 = ds.cycle(e, levels, conf, dbg=dbg, storage=spdt)
        elif corr:
            if r is None:
                r = _fresh(_residual_e(e, s, levels[0].arrays), levels[0])
            zero = tuple(torch.zeros_like(c) for c in e)
            delta = run_one_cycle(zero, r, levels, conf, dbg=dbg,
                                  storage=spdt)
            e = tuple(a + d for a, d in zip(e, delta))
            r = _fresh(_residual_e(e, s, levels[0].arrays), levels[0])
            l2 = _space(levels[0]).norm(r)
        else:
            e = run_one_cycle(e, s, levels, conf, nu_init=nu_init, dbg=dbg)
            l2 = _level_norm(e, s, levels[0])

        # Advance sc/lr schedules (per top-level cycle).
        if var.sc_cycle:
            var.sc_dir = next(var.sc_cycle)
        if var.lr_cycle:
            var.lr_dir = next(var.lr_cycle)

        # Reference bookkeeping: store the previous error at slot
        # (it-1) BEFORE incrementing, compare the new error against the
        # value of the same cycle type, maxcycle checks ago
        # (solver.py:519-521, 588-604).
        l2_stag[(it - 1) % var._maxcycle] = l2_last
        it += 1
        var.it += 1
        l2_prev = l2_last
        l2_last = l2

        if track:
            var.runtime_at_cycle = np.r_[var.runtime_at_cycle,
                                         var.time.elapsed]
            var.error_at_cycle = np.r_[var.error_at_cycle, l2_last]
            _print_cycle_info(var, l2_last, l2_prev)

        if _terminate(var, l2_last, l2_stag[(it - 1) % var._maxcycle],
                      it, refe=refe):
            break

        if standalone:
            ds.switch(e, l2_last, var.l2_refe)

    var.l2 = l2_last
    if standalone:
        ctx.e = e
        ctx.e_lo = ds.lo
    return e


class _TwoFloat:
    """The two-float mode of standalone multigrid in complex64 (the JAX
    package's solver.py:1568-1835, batched :3150-3215).

    Once the error is below ``tau = max(100·tol, 1e-5)`` of the source
    norm (and :func:`_ds_wanted`), the solution is a (hi, lo) pair: each
    cycle runs in correction form (δ = MG(0, r)), accumulates δ with a
    two-sum (:func:`.ops.dsres.ds_accumulate`) and takes the
    double-single residual of hi + lo as its convergence residual and
    next source.  ``norm`` is the residual norm, a float (single solve)
    or one per lane (batched).
    """

    def __init__(self, ctx, var, s, norm):
        self.ctx, self.var, self.s, self.norm = ctx, var, s, norm
        self.tau = max(100.0 * float(var.tol), 1e-5)
        self.lo = None    # the lo stream, once live
        self.r = None     # its double-single residual

    def cycle(self, e, levels, conf, dbg=None, storage=None):
        """One correction cycle from hi ``e``: (new hi, residual norm);
        ``storage`` stores the smoothers' s/params streams."""
        zero = tuple(torch.zeros_like(c) for c in e)
        delta = run_one_cycle(zero, self.r, levels, conf, dbg=dbg,
                              storage=storage)
        e, self.lo = dsres.ds_accumulate(e, self.lo, delta)
        self.r = self.ctx.residual_ds(e, self.lo, self.s)
        return e, self.norm(self.r)

    def switch(self, e, l2, refe):
        """Go two-float once every ``l2`` is below tau·``refe``."""
        if (self.lo is None and _ds_wanted(e, self.var)
                and np.all(l2 < self.tau * refe)):
            self.lo = tuple(torch.zeros_like(c) for c in e)
            self.r = self.ctx.residual_ds(e, self.lo, self.s)


def _qc_levels(out, nlevels, lvl, cycmax, new_cycmax, cycle):
    """Replay the cycle's level visits for the QC graph.

    Records a level at call entry and again after every prolongation,
    like the reference (solver.py:496, 567).
    """
    out.append(lvl)
    if lvl == nlevels - 1:
        return
    if lvl == 0 or new_cycmax == 0 or cycle != 'F':
        cm = cycmax
    else:
        cm = new_cycmax
    it = 0
    while it < cm:
        _qc_levels(out, nlevels, lvl + 1,
                   2 if cycle in ('F', 'W') else 1, cm - it, cycle)
        out.append(lvl)
        it += 1
        if lvl == 0:
            break


def _qc_graph(level_seq, width=70):
    """ASCII rendering of the level trajectory (verb>3 QC figure)."""
    seq = np.asarray(level_seq, dtype=int)
    if seq.size < 2:
        return ""
    frm, to = seq[:-1], seq[1:]
    row = np.minimum(frm, to)
    down = to > frm
    ncol = min(len(row), width)
    lines = ["       h_"]
    for r in range(int(seq.max())):
        marks = ''.join(
            ('\\' if down[v] else '/') if row[v] == r and frm[v] != to[v]
            else ' ' for v in range(ncol))
        lines.append(f"   {2**(r+1):4}h_ {marks}")
    out = "\n".join(lines) + "\n\n"
    if len(row) > width:
        out += (f"  (Cycle-QC restricted to first {width} steps of "
                f"{len(row)} steps.)\n")
    return out


def _print_cycle_info(var, l2_last, l2_prev):
    """Per-cycle log line (reference parity: solver.py:1575-1648)."""
    if var.verb < 0:
        var.one_liner(l2_last)
        return
    if var.verb < 3:
        return
    info = "\n" if var.verb > 4 else ""
    if var._first_cycle:
        if var.verb > 3 and var._level_all:
            info += _qc_graph(var._level_all)
        elif var.verb > 3:
            info += "\n"
        var._first_cycle = False
    info += f"   [{var.time.now}]   {l2_last/var.l2_refe:.3e} "
    info += f"after {var.it:3} {var.cycle}-cycles; "
    info += f"[{l2_last:.3e}, {l2_last/max(l2_prev, 1e-300):.3f}]"
    info += f" {int(var.sc_dir)} {int(var.lr_dir)}"
    if var.verb > 4:
        info += "\n"
    var.cprint(info, 3)


def _terminate(var, l2_last, l2_stag, it, refe=None):
    """Termination criteria (reference parity: solver.py:1908-1941).

    ``refe`` overrides the reference norm (preconditioner calls judge
    against their own rhs norm, see :func:`multigrid`).  Under a Krylov
    solver, DIVERGED and STAGNATED raise :class:`_ConvergenceError`, and
    reaching ``maxit`` ends the preconditioner call without a message.
    """
    if refe is None:
        refe = var.l2_refe
    finished = False
    sslabort = False

    if l2_last < var.tol * refe:
        var.exit_message = "CONVERGED"
        finished = True
    elif l2_last > 10 * refe or not math.isfinite(l2_last):
        var.exit_message = "DIVERGED"
        finished = True
        sslabort = True
    elif it > 2 and l2_last >= l2_stag:
        var.exit_message = "STAGNATED"
        finished = True
        sslabort = True
    elif it == var.maxit:
        if not var.sslsolver:
            var.exit_message = "MAX. ITERATION REACHED, NOT CONVERGED"
        finished = True

    if finished:
        if var.sslsolver and sslabort:
            raise _ConvergenceError
        elif not var.sslsolver:
            add = "\n" if var.verb < 5 else ""
            var.cprint(add + "   > " + var.exit_message, 2)
    return finished


class _ConvergenceError(Exception):
    """Raised to abort the Krylov loop on divergence/stagnation."""


# ======================================================================
# Krylov (reference parity: solver.py:1948-2124, 2669-2750)
# ======================================================================

def _dot(a, b, sp):
    """Standard complex inner product <a, b> = sum(conj(a)*b) over the
    level's edges (``sp``, a :class:`.parallel.halo.Space`: the whole
    level, or a rank's slab and then over the ranks), as a Python
    complex (one host sync)."""
    d = torch.stack([torch.vdot(sp.owned_view(x, c).reshape(-1),
                                sp.owned_view(y, c).reshape(-1))
                     for c, (x, y) in enumerate(zip(a, b))])
    with trace.span('sync'):
        return sum(sp.reduce(d).tolist(), 0j)


def _axpy(alpha, x, y):
    return tuple(yy + alpha * xx for xx, yy in zip(x, y))


def krylov(ctx, var):
    """MG-preconditioned BiCGSTAB/CGS/GCROT(m,k) (reference:
    solver.py:1965-2124).

    scipy's algorithms with host scalars, so iteration counts are
    comparable (GCROT(m,k) with its basis on the device,
    :func:`_gcrotmk`); the right preconditioner M is :func:`multigrid`
    on a zero field (up to ``var.maxit`` cycles, with the sc/lr
    schedules advancing one step per cycle).  A diverging or stagnating
    preconditioner aborts with a zero field.
    """
    fine = ctx.levels(int(var.sc_dir))[0]
    arrays = fine.arrays
    s = ctx.s
    x = ctx.e
    # A sharded finest level: the vectors are this rank's slabs, their
    # ghosts refreshed before the operator, the preconditioner and a
    # residual read them; the norms and inner products sum each owned
    # edge once, then over the ranks (they never read a ghost).
    sp = _space(fine)

    def fresh(v):
        return _fresh(v, fine)

    def matvec(e):
        return stencil.amat(*fresh(e), *arrays)

    def precond(r):
        ez = tuple(torch.zeros_like(c) for c in r)
        return multigrid(ctx, var, e=ez, s=fresh(r), track=False)

    def true_norm(xk):
        return _level_norm(fresh(xk), s, fine)

    def callback(xk, l2=None):
        var._ssl_it += 1
        var.runtime_at_cycle = np.r_[var.runtime_at_cycle,
                                     var.time.elapsed]
        var.l2 = true_norm(xk) if l2 is None else l2
        var.error_at_cycle = np.r_[var.error_at_cycle, var.l2]
        if var.verb > 3:
            log = f"   [{var.time.now}]   {var.l2/var.l2_refe:.3e} "
            log += f" after {var._ssl_it:3} {var.sslsolver}-cycles"
            var.cprint(log, 3)
        elif var.verb < 0:
            var.one_liner(var.l2)

    bnorm = sp.norm(s)
    atol = max(float(var.tol) * bnorm, 1e-30)
    solver = functools.partial({'bicgstab': _bicgstab, 'cgs': _cgs,
                                'gcrotmk': _gcrotmk}[var.sslsolver], sp=sp)
    l2_final = None
    try:
        if s[0].dtype == torch.complex64:
            x, l2_final, info = _krylov_refined(ctx, var, solver, matvec,
                                                callback, x, bnorm, sp,
                                                fresh)
        else:
            x, info = solver(matvec, precond, s, x, atol, var.ssl_maxit,
                             callback)
    except _ConvergenceError:
        info = -1
        x = tuple(torch.zeros_like(c) for c in s)
        ctx.e_lo = None
        l2_final = None
        var.exit_message += " (returned field is zero)"

    pre = "\n   > "
    if info < 0:
        if var.exit_message == '':
            var.exit_message = f"Error in {var.sslsolver} ({info})"
        pre = "\n* ERROR   :: "
    elif info > 0:
        var.exit_message = "MAX. ITERATION REACHED, NOT CONVERGED"
    else:
        var.exit_message = "CONVERGED"
    var.cprint(pre + var.exit_message, 2)

    ctx.e = x
    # The refined path reports the double-single-evaluated true residual
    # (a float32 evaluation would report its own noise floor).
    var.l2 = l2_final if l2_final is not None else true_norm(x)
    return x


# MG cycles of the single solve's refinement shortcut (the JAX
# package's _REFINE_SHORTCUT_CYCLES, hardware-tuned there).
_REFINE_SHORTCUT_CYCLES = 1


def _refine_krylov(residual_fn, norm_fn, precond, inner, xhi, xlo, atol,
                   maxit):
    """Two-float iterative refinement around a Krylov inner solve (the
    JAX package's ``_refine_krylov``, solver.py:1471-1535, at its
    settings: no pass-0 loosening, one shortcut try).

    The Krylov recursive residual converges below tol, but with float32
    solution storage the true residual floors at a few e-6, so the
    solution accumulates as a (hi, lo) pair, each pass solves the
    correction system for the double-single true residual, and
    convergence is judged on that.  ``norm_fn``/``atol`` may be scalars
    (single solve) or per-lane arrays (batched); termination is
    all-lanes.  ``inner(r0, x0)`` runs one Krylov solve of the
    correction system and returns ``(dx, info)``.  A pass after the
    first starts within a few × tol, so it first tries one cheap
    preconditioner application (``precond``), kept where it reduces the
    residual.  Returns ``(xhi, xlo, rn_true, info)``.
    """
    info = 0
    rn_true = None
    for _pass in range(4):
        r0 = residual_fn(xhi, xlo)
        rn_true = norm_fn(r0)
        if np.all(rn_true <= atol):
            # The double-single true residual is the arbiter: a
            # converged solution clears any stale inner-pass code.
            info = 0
            break
        if info != 0 or _pass == 3:
            if info == 0:
                info = maxit
            break
        if _pass >= 1:
            xh2, xl2 = dsres.ds_accumulate(xhi, xlo, precond(r0))
            r2 = residual_fn(xh2, xl2)
            rn2 = norm_fn(r2)
            if np.all(rn2 <= rn_true):
                xhi, xlo, r0, rn_true = xh2, xl2, r2, rn2
                if np.all(rn2 <= atol):
                    info = 0
                    break
        zero = tuple(torch.zeros_like(c) for c in xhi)
        dx, info = inner(r0, zero)
        xhi, xlo = dsres.ds_accumulate(xhi, xlo, dx)
    return xhi, xlo, rn_true, info


def _krylov_refined(ctx, var, solver, matvec, callback, x, bnorm, sp,
                    fresh):
    """A complex64 Krylov solve under :func:`_refine_krylov` (the JAX
    package's accelerator path, solver.py:2005-2090): the unit-norm
    system s/‖s‖, ``solver`` (the port's BiCGSTAB, CGS or GCROT(m,k)) as
    the inner solve of each correction system, preconditioned by
    :func:`_precond_fixed_cycles`, and the shortcut by one MG cycle.
    Norms over the space ``sp`` (:func:`_dot`); ``fresh`` refreshes a
    vector's ghosts on a sharded level before a preconditioner reads it.
    Returns ``(x, l2, info)``: hi scaled back, its double-single true
    residual norm, the Krylov code; the lo stream goes to ``ctx.e_lo``.
    """
    sc = 1.0 / max(bnorm, 1e-300)
    s_n = tuple(c * sc for c in ctx.s)
    xhi = tuple(c * sc for c in x)
    xlo = tuple(torch.zeros_like(c) for c in xhi)
    atol_n = max(float(var.tol), 1e-30)
    rhs = [None]      # the correction system of the current pass

    def inner_callback(xk, l2=None):
        # The inner solvers report the correction system's residual
        # (recursive, or r0 − A·dx); scaled back to the source's norm.
        if l2 is None:
            l2 = sp.norm(tuple(r - a for r, a in zip(rhs[0], matvec(xk))))
        callback(xk, l2=l2 * bnorm)

    def inner(r0, x0):
        rhs[0] = r0
        return solver(matvec,
                      lambda r: _precond_fixed_cycles(ctx, var, fresh(r)),
                      r0, x0, atol_n, var.ssl_maxit, inner_callback)

    xhi, xlo, rn_true, info = _refine_krylov(
        lambda h, lo: ctx.residual_ds(h, lo, s_n),
        sp.norm,
        lambda r: _precond_fixed_cycles(ctx, var, fresh(r),
                                        cycles=_REFINE_SHORTCUT_CYCLES),
        inner, xhi, xlo, atol_n, var.ssl_maxit)
    ctx.e_lo = tuple(c * bnorm for c in xlo)
    return tuple(c * bnorm for c in xhi), rn_true * bnorm, info


def _bicgstab(matvec, precond, b, x, atol, maxiter, callback, sp):
    """Right-preconditioned BiCGSTAB (scipy-compatible formulation);
    norms and inner products over the space ``sp`` (:func:`_dot`)."""
    r = tuple(bb - aa for bb, aa in zip(b, matvec(x)))
    rtilde = r
    rho_prev, alpha, omega = 1.0, 1.0, 1.0
    v = p = None

    for it in trace.each('krylov.iter', range(maxiter)):
        if sp.norm(r) <= atol:
            return x, 0
        rho = _dot(rtilde, r, sp)
        if rho == 0:
            return x, -10
        if it == 0:
            p = r
        else:
            beta = (rho / rho_prev) * (alpha / omega)
            p = tuple(rr + beta * (pp - omega * vv)
                      for rr, pp, vv in zip(r, p, v))
        phat = precond(p)
        v = matvec(phat)
        denom = _dot(rtilde, v, sp)
        if denom == 0:
            return x, -11
        alpha = rho / denom
        sres = tuple(rr - alpha * vv for rr, vv in zip(r, v))
        if sp.norm(sres) <= atol:
            x = _axpy(alpha, phat, x)
            callback(x)
            return x, 0
        shat = precond(sres)
        t = matvec(shat)
        tt = _dot(t, t, sp)
        if tt == 0:
            return x, -12
        omega = _dot(t, sres, sp) / tt
        x = _axpy(alpha, phat, x)
        x = _axpy(omega, shat, x)
        r = tuple(ss - omega * ttt for ss, ttt in zip(sres, t))
        rho_prev = rho
        callback(x)
        if omega == 0:
            return x, -13
    return x, maxiter


# ----------------------------------------------------------------------
# GCROT(m, k) with a device-resident basis (reference parity:
# emg3d_tpu/solver.py:2190-2424, the complex128 branch at 2097-2099).
# The Krylov basis V, the flexible preconditioned vectors Z and the
# recycled pairs (C, U) are slot-stacked tensors on the device; the host
# fetches one packed vector per inner step and solves the ≤ m×m
# least-squares problems.
# ----------------------------------------------------------------------

_GCROT_M = 20
_GCROT_K = 10


def _st_dots(stacks, w, sp):
    """<stack_i, w> summed over the components and ranks: (S,) complex
    on the device (``sp`` as in :func:`_dot`)."""
    tot = None
    for c, (B, x) in enumerate(zip(stacks, w)):
        Bo = sp.owned_view(B, c)
        d = Bo.reshape(Bo.shape[0], -1).conj() @ \
            sp.owned_view(x, c).reshape(-1)
        tot = d if tot is None else tot + d
    return sp.reduce(tot)


def _st_comb(stacks, coef):
    """Σ_i coef_i · stack_i per component (coef: (S,) complex)."""
    return tuple((coef @ B.reshape(B.shape[0], -1)).reshape(B.shape[1:])
                 for B in stacks)


def _st_zeros(nslots, like):
    return tuple(torch.zeros((nslots,) + tuple(c.shape), dtype=c.dtype,
                             device=c.device) for c in like)


def _gc_append(stack, idx, v, scale):
    """Slot write: stack[idx] := v · scale (in place)."""
    for B, c in zip(stack, v):
        B[idx] = c * scale
    return stack


def _dot_d(a, b, sp):
    """<a, b> over the components and ranks as a device scalar (no host
    sync; ``sp`` as in :func:`_dot`)."""
    tot = None
    for c, (x, y) in enumerate(zip(a, b)):
        d = torch.vdot(sp.owned_view(x, c).reshape(-1),
                       sp.owned_view(y, c).reshape(-1))
        tot = d if tot is None else tot + d
    return sp.reduce(tot)


def _gc_ortho(cstack, vstack, cmask, vmask, w, sp):
    """Orthogonalize w against the active C and V slots (CGS2).

    Two classical Gram-Schmidt passes (as stable as modified GS);
    inactive slots are masked to zero.  Returns w, and ONE packed real
    vector [cd.re, cd.im, vd.re, vd.im, ‖w‖] for a single host fetch.
    """
    def gs_pass(w_):
        cd = _st_dots(cstack, w_, sp) * cmask
        vd = _st_dots(vstack, w_, sp) * vmask
        w_ = tuple(ww - cc - vv for ww, cc, vv in
                   zip(w_, _st_comb(cstack, cd), _st_comb(vstack, vd)))
        return w_, cd, vd

    w, cd1, vd1 = gs_pass(w)
    w, cd2, vd2 = gs_pass(w)
    cd = cd1 + cd2
    vd = vd1 + vd2
    wn = torch.sqrt(_dot_d(w, w, sp).real)
    pk = torch.cat([cd.real, cd.imag, vd.real, vd.imag, wn[None]])
    return w, pk


def _gc_update(x, r, cxr, uxr, sp):
    """x/r update along the new direction, and the packed diagnostics.

    gamma = <c_new, r> with c_new = cxr/‖cxr‖; x += gamma·u_new,
    r −= gamma·c_new.  Returns the new pair, rsqrt(‖cxr‖²) (the slot
    scale of the new outer pair) and [‖r_new‖², ‖cxr‖²] for one fetch.
    """
    n2 = _dot_d(cxr, cxr, sp).real
    g = _dot_d(cxr, r, sp)
    inv = torch.rsqrt(torch.clamp(n2, min=torch.finfo(n2.dtype).tiny))
    coef = torch.complex(g.real / n2, g.imag / n2)
    x_new = tuple(xx + coef * uu for xx, uu in zip(x, uxr))
    r_new = tuple(rr - coef * cc for rr, cc in zip(r, cxr))
    rn2 = _dot_d(r_new, r_new, sp).real
    return x_new, r_new, inv, torch.stack([rn2, n2])


def _gcrotmk(matvec, precond, b, x, atol, maxiter, callback, sp, m=None,
             k=None):
    """GCROT(m, k) with a device-resident basis and recycled subspace.

    Flexible inner FGMRES(m) (the preconditioner, MG cycles with
    advancing sc/lr schedules, may vary), outer recycling of k (c, u)
    pairs with oldest-out truncation.  Per inner step the host fetches
    one packed (4·slots+1)-float vector and solves a ≤ m×m least-squares
    problem (reference parity: emg3d_tpu/solver.py:2332-2422).
    """
    m = _GCROT_M if m is None else m
    k = _GCROT_K if k is None else k
    dev = b[0].device
    rdt = b[0].real.dtype       # masks in the solve's real precision

    def coef(c):
        return torch.tensor(c, dtype=b[0].dtype, device=dev)

    r = tuple(bb - aa for bb, aa in zip(b, matvec(x)))
    rn = sp.norm(r)
    if rn <= atol or maxiter == 0:
        return x, 0

    cstack = _st_zeros(k, r)
    ustack = _st_zeros(k, r)
    vstack = _st_zeros(m + 1, r)
    zstack = _st_zeros(m, r)
    cmask = np.zeros(k)
    cu_next = 0

    for _cycle in trace.each('krylov.iter', range(maxiter)):
        beta = rn
        _gc_append(vstack, 0, r, 1.0 / beta)
        v_cur = tuple(c * (1.0 / beta) for c in r)
        vmask = np.zeros(m + 1)
        vmask[0] = 1.0
        cmask_d = torch.tensor(cmask, dtype=rdt, device=dev)

        H = np.zeros((m + 1, m), np.complex128)
        Bm = np.zeros((k, m), np.complex128)
        e1 = np.zeros(m + 1, np.complex128)
        e1[0] = beta
        j = 0
        y = None
        while j < m:
            z = precond(v_cur)
            w = matvec(z)
            _gc_append(zstack, j, z, 1.0)
            w, pk = _gc_ortho(cstack, vstack, cmask_d,
                              torch.tensor(vmask, dtype=rdt, device=dev), w,
                              sp)
            pk = _fetch(pk)                           # ONE fetch
            cd = pk[:k] + 1j * pk[k:2 * k]
            vd = pk[2 * k:2 * k + m + 1] + 1j * pk[2 * k + m + 1:-1]
            wn = float(pk[-1])
            H[:, j] = vd
            H[j + 1, j] = wn
            Bm[:, j] = cd
            happy = not np.isfinite(wn) or wn <= 1e-30
            if not happy and j + 1 < m + 1:
                _gc_append(vstack, j + 1, w, 1.0 / wn)
                vmask[j + 1] = 1.0
                v_cur = tuple(c * (1.0 / wn) for c in w)
            j += 1
            y = np.linalg.lstsq(H[:j + 1, :j], e1[:j + 1], rcond=None)[0]
            pres = np.linalg.norm(e1[:j + 1] - H[:j + 1, :j] @ y)
            if pres <= atol or happy:
                break

        hy = np.zeros(m + 1, np.complex128)
        hy[:j + 1] = H[:j + 1, :j] @ y
        ypad = np.zeros(m, np.complex128)
        ypad[:j] = y
        yb = Bm[:, :j] @ y
        # The new outer pair before normalization: cx = V·(H y) is the
        # A-image of ux = Z·y − U·(B y) in the C-complement.
        cxr = _st_comb(vstack, coef(hy))
        uxr = tuple(zz - uu for zz, uu in zip(_st_comb(zstack, coef(ypad)),
                                              _st_comb(ustack, coef(yb))))
        x, r, inv_d, diag = _gc_update(x, r, cxr, uxr, sp)
        _gc_append(cstack, cu_next, cxr, inv_d)
        _gc_append(ustack, cu_next, uxr, inv_d)
        cmask[cu_next] = 1.0
        cu_next = (cu_next + 1) % k

        rn2, n2 = _fetch(diag)                       # one fetch per cycle
        rn = float(np.sqrt(max(rn2, 0.0)))
        callback(x, l2=rn)
        if not np.isfinite(rn) or n2 <= 0:
            return x, -1
        if rn <= atol:
            return x, 0
    return x, maxiter


def _cgs(matvec, precond, b, x, atol, maxiter, callback, sp):
    """Preconditioned CGS; ``sp`` as in :func:`_bicgstab`."""
    r = tuple(bb - aa for bb, aa in zip(b, matvec(x)))
    rtilde = r
    rho_prev = 1.0
    u = p = q = None

    for it in trace.each('krylov.iter', range(maxiter)):
        if sp.norm(r) <= atol:
            return x, 0
        rho = _dot(rtilde, r, sp)
        if rho == 0:
            return x, -10
        if it == 0:
            u = r
            p = r
        else:
            beta = rho / rho_prev
            u = tuple(rr + beta * qq for rr, qq in zip(r, q))
            p = tuple(uu + beta * (qq + beta * pp)
                      for uu, qq, pp in zip(u, q, p))
        phat = precond(p)
        vhat = matvec(phat)
        denom = _dot(rtilde, vhat, sp)
        if denom == 0:
            return x, -11
        alpha = rho / denom
        q = tuple(uu - alpha * vv for uu, vv in zip(u, vhat))
        uq = tuple(uu + qq for uu, qq in zip(u, q))
        uqhat = precond(uq)
        x = _axpy(alpha, uqhat, x)
        w = matvec(uqhat)
        r = tuple(rr - alpha * ww for rr, ww in zip(r, w))
        rho_prev = rho
        callback(x)
    return x, maxiter


def _resolve_device(device):
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "emg3d_tpu_torch.solve runs on CUDA by default, and no CUDA "
            "device is available; pass device='cpu' to solve on the "
            "CPU.")
    return device


def solve(grid, model, sfield, efield=None, cycle='F', sslsolver=False,
          semicoarsening=False, linerelaxation=False, verb=2, device=None,
          **kwargs):
    """Solve the 3-D EM diffusion system A E = s·μ0·Js.

    Same signature, defaults, termination behavior, info_dict contents
    and in-place efield update as ``emg3d_tpu.solve``, plus ``device``.

    Parameters (selection)
    ----------
    grid : TensorMesh
    model : Model
    sfield : SourceField
    efield : Field, optional — initial guess; updated in place (host
        arrays); if provided, nothing is returned (unless return_info).
    cycle : {'F', 'V', 'W'}
    sslsolver : {False, True, 'bicgstab', 'cgs', 'gcrotmk'}
    semicoarsening : bool/int/digit-cycle
    linerelaxation : bool/int/digit-cycle
    verb : int
    device : torch device or str, optional — where the solve runs.
        None means ``'cuda'`` and raises when no CUDA device exists;
        CPU runs ask for ``device='cpu'``.
    kwargs : tol, maxit, nu_init, nu_pre, nu_coarse, nu_post, clevel,
        return_info, log; ``profile=dir`` traces the solve with
        ``torch.profiler`` into ``dir`` (a TensorBoard/Chrome trace);
        ``sharding``: a ``DeviceMesh`` of the process group's ranks, or
        :func:`.parallel.shard_solve_options` of one, runs the solve on
        y/z slabs across the ranks (:mod:`.parallel.halo`).  Every rank
        calls ``solve`` with the same arguments; each returns the whole
        field.  A level is distributed while each rank keeps
        ``min_local_planes`` cells along every sharded axis; the coarser
        ones run whole on every rank.  Point smoothing, line relaxation
        (:mod:`.parallel.lines`), semicoarsening and the Krylov solvers,
        in complex128 or complex64 (the two-float cycles and the
        refined Krylov solves, K6 on the finest slab); a complex64
        solve's levels on slabs store in float32, the replicated ones
        as the unsharded solve does (:data:`BF16_STORAGE`).

    Returns
    -------
    efield : Field (if no initial efield was provided)
    info_dict : dict (if return_info=True)
    """
    device = _resolve_device(device)
    with _profiler(kwargs.pop('profile', None), device), \
            trace.span('solve', new_solve=True):
        with trace.span('solve.setup'):
            var, ctx, done = _solve_setup(
                grid, model, sfield, efield, device, kwargs, verb=verb,
                cycle=cycle, sslsolver=sslsolver,
                linerelaxation=linerelaxation, semicoarsening=semicoarsening)
        if ctx is None:
            return done
        # krylov() catches _ConvergenceError itself, and standalone
        # multigrid never raises it.
        if var.sslsolver:
            krylov(ctx, var)
        else:
            multigrid(ctx, var)

        var.runtime_at_cycle = np.r_[var.runtime_at_cycle, var.time.elapsed]
        var.error_at_cycle = np.r_[var.error_at_cycle, var.l2]

        if var.verb < 0:
            var.one_liner(var.l2, True)
        elif var.verb > 1:
            var.cprint(f"\n:: emg3d_tpu_torch END   :: {var.time.now} :: "
                       f"runtime = {var.time.runtime}\n", 2)

        with trace.span('solve.result'):
            return _hand_back(ctx, var, sfield, efield)


def _solve_setup(grid, model, sfield, efield, device, kwargs, **opts):
    """Everything :func:`solve` does before its first cycle: ``(var,
    ctx, None)``, or ``(var, None, what solve returns)`` where nothing
    is left to solve (a zero source, a converged warm start).  The
    context holds the source and start fields on the device and the
    first level hierarchy.

    An unsharded solve copies the source and the model's properties to
    its device once and makes the rest there: the source's norm (one
    fetch), η and ζ (:class:`.models.DeviceVolumeModel`) and the zero
    start field.  A sharded solve takes them on the host, as it builds
    its levels there before cutting them into slabs; prebuilt η/ζ
    (``_vmodel``, the differentiable solve's) are taken as given."""
    sharding = kwargs.pop('sharding', None)
    if sharding is not None:
        sharding = _normalize_sharding(sharding)
    # Prebuilt volume parameters η/ζ (the differentiable solve passes
    # them; ``model`` is then unused and may be None).
    vmodel = kwargs.pop('_vmodel', None)
    var = MGParameters(shape_cells=tuple(grid.shape_cells), **opts, **kwargs)

    do_return = efield is None
    if not do_return:
        var.do_return = False
    var.cprint(f"\n:: emg3d_tpu_torch START :: {var.time.now} :: "
               f"v{__import__('emg3d_tpu_torch').__version__}\n", 2)
    var.cprint(var, 2)

    src_dtype = sfield.dtype
    # The x64 switch is read here, once: the solve keeps this precision.
    dtype = precision(src_dtype)[1]

    # Compute reference error for tolerance.
    if sharding is None:
        s = tuple(t[0] for t in _sources([sfield], grid, dtype, device)[0])
        with trace.span('setup.norm'):
            var.l2_refe = halo.WHOLE.norm(s)
    else:
        trace.count('source.dense', 1)
        s = sfield
        with trace.span('setup.norm'):
            var.l2_refe = float(sfield.norm())

    # Zero source field => zero efield.
    if var.l2_refe == 0:
        var.exit_message = "CONVERGED"
        var.cprint("   > RETURN ZERO E-FIELD (provided sfield is zero)\n",
                   2)
        with trace.span('setup.zero_field'):
            z = fields.Field.zeros(grid, frequency=sfield._frequency,
                                   dtype=src_dtype)
        if not do_return:
            for a, b in zip((efield.fx, efield.fy, efield.fz),
                            (z.fx, z.fy, z.fz)):
                np.asarray(a)[...] = b
            return var, None, _info_dict(var) if var.return_info else None
        return var, None, (z, _info_dict(var)) if var.return_info else z

    with trace.span('setup.volume_model'):
        if vmodel is None and sharding is None:
            vmodel = models.DeviceVolumeModel(grid, model, sfield, device,
                                              dtype)
            trace.count('setup.device_params', 1)
        elif vmodel is None:
            vmodel = models.VolumeModel(grid, model, sfield)

    if do_return and sharding is not None:
        with trace.span('setup.zero_field'):
            efield = fields.Field.zeros(grid, frequency=sfield._frequency,
                                        dtype=src_dtype)
    ctx = _SolveContext(grid, vmodel, s, efield, var, device, sharding,
                        dtype)
    # The first hierarchy, which the cycles would build first.
    fine = ctx.levels(int(var.sc_dir))[0]
    if not do_return:
        # Warm start: if converged already, return immediately.
        l2 = _level_norm(ctx.e, ctx.s, fine)
        if l2 < var.tol * var.l2_refe and not var.sslsolver:
            var.exit_message = "CONVERGED"
            var.cprint("   > NOTHING DONE (provided efield already "
                       "converged)\n", 2)
            return var, None, _info_dict(var) if var.return_info else None
    return var, ctx, None


def _hand_back(ctx, var, sfield, efield):
    """What :func:`solve` returns once its cycles are done: the solution
    fetched from the device, as a new Field or into ``efield`` (the warm
    start, updated in place), with the info dict if asked for."""
    comps = _result(ctx.field(), None if ctx.e_lo is None
                    else ctx.field(ctx.e_lo), sfield.dtype)
    out = fields.Field(comps[0], comps[1], comps[2],
                       frequency=sfield._frequency)

    if efield is not None:
        # In-place update of the provided field (reference semantics);
        # if its buffers are read-only, rebind.
        for name in ('fx', 'fy', 'fz'):
            dst = np.asarray(getattr(efield, name))
            src = getattr(out, name)
            if dst.flags.writeable:
                dst[...] = src
            else:
                setattr(efield, name, src)
        if var.return_info:
            return _info_dict(var)
        return None

    if var.return_info:
        return out, _info_dict(var)
    return out


def _result(comps, lows, src_dtype):
    """The solution's host components as the JAX package returns them
    (``emg3d_tpu/solver.py:2879-2885``): hi + lo collapsed on the host
    in complex128 (exact) where the two-float ``lows`` are live, a
    Laplace-domain field too; else in the dtype the device computed in
    (complex64 for a complex128 source with x64 off), the real part for
    a real ``src_dtype`` (a Laplace-domain solve runs promoted to
    complex, with an imaginary part that stays exactly zero)."""
    trace.count('copy.d2h_bytes', trace.nbytes(comps))
    comps = [_fetch(t) for t in comps]
    if lows is not None:
        trace.count('copy.d2h_bytes', trace.nbytes(lows))
        return [hi.astype(np.complex128) + _fetch(lo)
                for hi, lo in zip(comps, lows)]
    if not np.iscomplexobj(np.zeros(0, src_dtype)):
        comps = [c.real for c in comps]
    return [np.ascontiguousarray(c) for c in comps]


def _normalize_sharding(sharding):
    """The ``sharding`` option as a dict (``emg3d_tpu/solver.py:1395``):
    a mesh alone takes the default ``min_local_planes``."""
    if not isinstance(sharding, dict):
        sharding = {'mesh': sharding}
    mesh = sharding.get('mesh')
    import torch.distributed as dist
    if mesh is None or not dist.is_initialized() or \
            mesh.mesh.numel() != dist.get_world_size():
        raise ValueError("sharding: a DeviceMesh over every rank of the "
                         "initialized process group "
                         "(emg3d_tpu_torch.parallel.make_mesh)")
    return sharding


def _profiler(trace_dir, device):
    """``torch.profiler`` around a solve, writing its trace into
    ``trace_dir`` (the JAX package's ``profile=dir``); a null context
    without one."""
    import contextlib
    if not trace_dir:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(
            str(trace_dir)))


def _info_dict(var, l2=None, refe=None):
    """The info dict of a solve; a batched solve's gives its lanes' final
    residual norms ``l2`` and source norms ``refe`` (arrays)."""
    if l2 is None:
        l2, refe = var.l2, var.l2_refe
        rel = l2 / refe if refe else 0.0
    else:
        rel = l2 / refe
    return {
        'exit': 0 if var.exit_message == 'CONVERGED' else 1,
        'exit_message': var.exit_message,
        'abs_error': l2,
        'rel_error': rel,
        'ref_error': refe,
        'tol': var.tol,
        'it_mg': var.it,
        'it_ssl': var._ssl_it,
        'time': var.time.elapsed,
        'runtime_at_cycle': var.runtime_at_cycle,
        'error_at_cycle': var.error_at_cycle,
        'log': var.log_message,
    }


# ======================================================================
# Batched multi-source solve (reference parity: solver.py:2929-3472)
# ======================================================================

def solve_batched(grid, model, sfields, cycle='F', semicoarsening=False,
                  linerelaxation=False, verb=2, device=None, **kwargs):
    """Solve for many sources at once on one grid, advanced together.

    The (source, frequency) pairs are stacked on a leading lane axis and
    every multigrid cycle advances all lanes: residuals, transfers and
    line relaxation (K3 and K4 take every lane in one launch) run once
    for the batch, the point smoother once per lane.  Sources may have
    different frequencies: η is then stacked per lane, and the line
    smoother keeps one factor stack (K5) per frequency.  ``sslsolver``
    'bicgstab' (True) and 'cgs' run with per-lane scalars on the device
    and an MG preconditioner of ``maxit`` fixed cycles; 'gcrotmk' is
    refused.  ``device`` as in :func:`solve`.

    Termination: CONVERGED when every lane's residual is below tol;
    DIVERGED if any lane diverges; STAGNATED only when every lane has
    stagnated; MAX-IT on the worst lane.  ``it_mg`` is shared,
    ``rel_error`` per lane.

    Returns
    -------
    efields : list of Field (one per source field, with its frequency)
    info : dict — per-lane 'abs_error', 'rel_error' and 'ref_error'
        arrays, shared 'it_mg' and 'it_ssl', etc.
    """
    if not sfields:
        raise ValueError("Provide at least one source field.")
    device = _resolve_device(device)
    with trace.span('solve', new_solve=True):
        with trace.span('solve.setup'):
            var, ctx, refe = _batched_setup(
                grid, model, sfields, device, kwargs, verb=verb, cycle=cycle,
                linerelaxation=linerelaxation, semicoarsening=semicoarsening)

        if var.sslsolver:
            e, l2_last = _krylov_batched(ctx, var, refe)
        else:
            e, l2_last = _multigrid_batched(ctx, var, refe)

        with trace.span('solve.result'):
            src_dtype = np.result_type(*(sf.dtype for sf in sfields))
            comps = _result(e, ctx.e_lo, src_dtype)
            out = [fields.Field(*(np.ascontiguousarray(c[b]) for c in comps),
                                frequency=sf._frequency)
                   for b, sf in enumerate(sfields)]
    return out, _info_dict(var, l2_last, refe)


def _batched_setup(grid, model, sfields, device, kwargs, **opts):
    """Everything :func:`solve_batched` does before its first cycle:
    ``(var, ctx, refe)``, the context holding the stacked sources on the
    device and the first level hierarchy, ``refe`` the lanes' source
    norms (1 where a source is zero)."""
    sslsolver = kwargs.pop('sslsolver', False)
    var = MGParameters(sslsolver=sslsolver,
                       shape_cells=tuple(grid.shape_cells), **opts, **kwargs)
    if var.sslsolver and var.sslsolver not in ('bicgstab', 'cgs'):
        raise NotImplementedError(
            "Batched Krylov implements bicgstab and cgs only.")

    # One VolumeModel per frequency; a per-lane list stacks η.
    lane_freqs = [float(sf._frequency) for sf in sfields]
    by_freq = {}
    with trace.span('setup.volume_model'):
        for sf, f in zip(sfields, lane_freqs):
            if f not in by_freq:
                by_freq[f] = models.VolumeModel(grid, model, sf)
    vmodel = by_freq[lane_freqs[0]] if len(by_freq) == 1 \
        else [by_freq[f] for f in lane_freqs]
    lanes = Lanes(lane_freqs, device)

    # The lanes stack in one dtype (numpy promotes them, as the JAX
    # package's np.stack does); the x64 switch is read here, once.
    src_dtype = np.result_type(*(sf.dtype for sf in sfields))
    cdtype = precision(src_dtype)[1]
    s, records = _sources(sfields, grid, cdtype, device)
    ctx = _SolveContext.batched(grid, vmodel, s, var, device, lanes)

    with trace.span('setup.norm'):
        refe = np.array([float(sf.norm()) if records is None
                         else sf._record_norm() for sf in sfields])
    var.l2_refe = float(refe.max())
    refe = np.where(refe == 0, 1.0, refe)
    # The first hierarchy, which the cycles would build first.
    ctx.levels(int(var.sc_dir))
    return var, ctx, refe


def _multigrid_batched(ctx, var, refe):
    """MG cycles on every lane, with the batched termination rules
    (reference parity: solver.py:3127-3211).  A complex64 batch switches
    to two-float cycles once every lane is below tau (:class:`_TwoFloat`);
    its lo stream lands in ``ctx.e_lo``."""
    e, s = ctx.e, ctx.s
    l2_last = residual_norms(e, s, ctx.levels(int(var.sc_dir))[0].arrays)
    l2_stag = np.tile(l2_last, (var._maxcycle, 1))
    it = 0
    first = True
    ds = _TwoFloat(ctx, var, s, lambda r: _fetch(_norm_b(*r)))
    for _ in trace.each('mg.cycle'):
        conf = (var.nu_pre, var.nu_coarse, var.nu_post, var.cycle,
                int(var.lr_dir))
        levels = ctx.levels(int(var.sc_dir))
        nu_init = var.nu_init if first else 0
        first = False
        if ds.lo is not None:
            e, l2 = ds.cycle(e, levels, conf)
        else:
            e = run_one_cycle(e, s, levels, conf, nu_init=nu_init)
            l2 = residual_norms(e, s, levels[0].arrays)
        if var.sc_cycle:
            var.sc_dir = next(var.sc_cycle)
        if var.lr_cycle:
            var.lr_dir = next(var.lr_cycle)

        l2_stag[(it - 1) % var._maxcycle] = l2_last
        it += 1
        var.it += 1
        l2_last = l2
        rel = l2_last / refe
        if var.verb > 2:
            var.cprint(
                f"   [{var.time.now}]   max {rel.max():.3e} after "
                f"{it:3} {var.cycle}-cycles "
                f"({np.sum(rel < var.tol)}/{rel.size} converged)", 2)

        finished = True
        if np.all(rel < var.tol):
            var.exit_message = "CONVERGED"
        elif np.any(l2_last > 10 * refe) or not np.all(
                np.isfinite(l2_last)):
            var.exit_message = "DIVERGED"
        elif it > 2 and np.all(
                l2_last >= l2_stag[(it - 1) % var._maxcycle]):
            var.exit_message = "STAGNATED"
        elif it == var.maxit:
            var.exit_message = "MAX. ITERATION REACHED, NOT CONVERGED"
        else:
            finished = False
        if finished:
            add = "\n" if var.verb < 5 else ""
            var.cprint(add + "   > " + var.exit_message, 2)
            ctx.e_lo = ds.lo
            return e, l2_last
        ds.switch(e, l2_last, refe)


def _krylov_batched(ctx, var, refe):
    """Batched BiCGSTAB/CGS with per-lane device scalars, preconditioned
    by ``var.maxit`` fixed MG cycles (reference parity:
    solver.py:3050-3125).  complex128 needs neither the JAX package's
    unit-norm lane scaling nor its two-float refinement; convergence is
    judged per lane against tol·‖s_b‖.  A complex64 batch takes both
    (JAX solver.py:3063-3095): :func:`_krylov_batched_refined`."""
    fine = ctx.levels(int(var.sc_dir))[0]

    def matvec(ee):
        return stencil.amat(*ee, *fine.arrays)

    def prec(rr):
        return _precond_fixed_cycles(ctx, var, rr)

    def on_iter():
        var._ssl_it += 1

    kernel = _bicgstab_batched if var.sslsolver == 'bicgstab' \
        else _cgs_batched
    if ctx.s[0].dtype == torch.complex64:
        return _krylov_batched_refined(ctx, var, refe, kernel, matvec, prec,
                                       on_iter)
    x, info = kernel(matvec, prec, ctx.s, ctx.e, var.tol * refe,
                     var.ssl_maxit, on_iter)
    _batched_exit(var, info)
    return x, residual_norms(x, ctx.s, fine.arrays)


def _batched_exit(var, info):
    """The batched Krylov solve's exit message from its solver's
    ``info`` (0 converged, > 0 the iteration limit, < 0 a breakdown),
    printed."""
    if info == 0:
        var.exit_message = 'CONVERGED'
    elif info > 0:
        var.exit_message = 'MAX. ITERATION REACHED, NOT CONVERGED'
    else:
        var.exit_message = f'Error in {var.sslsolver} ({info})'
    var.cprint("\n   > " + var.exit_message, 2)


def _krylov_batched_refined(ctx, var, refe, kernel, matvec, prec, on_iter):
    """The complex64 batched Krylov solve: every lane scaled to unit norm
    (float32 breakdown guards square squared magnitudes and underflow on
    μ0-scaled sources otherwise), and per-lane two-float refinement
    (:func:`_refine_krylov`, shortcut by the full preconditioner) with
    the double-single residual of all lanes at once.  Returns the hi
    stream scaled back and its true residual norms; the lo stream goes
    to ``ctx.e_lo``."""
    sc = _bcast(torch.tensor(1.0 / refe, dtype=torch.float32,
                             device=ctx.s[0].device))
    s_n = tuple(c * sc for c in ctx.s)
    nlanes = len(refe)

    atol = np.full(nlanes, float(var.tol))

    def inner(r0, x0):
        return kernel(matvec, prec, r0, x0, atol, var.ssl_maxit, on_iter)

    xhi = ctx.e
    xlo = tuple(torch.zeros_like(c) for c in xhi)
    xhi, xlo, rn_true, info = _refine_krylov(
        lambda h, lo: ctx.residual_ds(h, lo, s_n),
        lambda r: _fetch(_norm_b(*r)),
        prec, inner, xhi, xlo, atol, var.ssl_maxit)
    _batched_exit(var, info)
    us = _bcast(torch.tensor(refe, dtype=torch.float32,
                             device=ctx.s[0].device))
    ctx.e_lo = tuple(c * us for c in xlo)
    return tuple(c * us for c in xhi), rn_true * refe


def _precond_fixed_cycles(ctx, var, r, cycles=None):
    """Preconditioner: exactly ``cycles`` (default ``var.maxit``) MG
    cycles from a zero field, no norms, the sc/lr schedules advancing per
    cycle (reference parity: solver.py:3432-3472; ``var.maxit`` is the
    schedule's length under a Krylov solver).  A correction solve by
    construction, so its smoothers store their s/params streams in
    ``ctx.storage`` (the JAX package's ``_smooth_spdt(r)``, :3444)."""
    e = tuple(torch.zeros_like(c) for c in r)
    for _ in range(var.maxit if cycles is None else cycles):
        conf = (var.nu_pre, var.nu_coarse, var.nu_post, var.cycle,
                int(var.lr_dir))
        e = run_one_cycle(e, r, ctx.levels(int(var.sc_dir)), conf,
                          storage=ctx.storage)
        var.it += 1
        if var.sc_cycle:
            var.sc_dir = next(var.sc_cycle)
        if var.lr_cycle:
            var.lr_dir = next(var.lr_cycle)
    return e


def _dot_b(a, b):
    """Per-lane inner products <a_b, b_b> = Σ conj(a_b)·b_b: (B,)."""
    tot = None
    for x, y in zip(a, b):
        v = torch.linalg.vecdot(x.reshape(x.shape[0], -1),
                                y.reshape(y.shape[0], -1))
        tot = v if tot is None else tot + v
    return tot


def _bcast(scal):
    """(B,) scalars -> broadcastable (B, 1, 1, 1)."""
    return scal.reshape(-1, 1, 1, 1)


def _cdiv_guard(num, den, guard):
    """num/den with den replaced by 1 where ``guard`` is False."""
    return num / torch.where(guard, den, torch.ones_like(den))


def _freeze(mask, new, old):
    """Lane-wise where(mask, new, old) of field tuples."""
    m = _bcast(mask)
    return tuple(torch.where(m, nn, oo) for nn, oo in zip(new, old))


def _lanes_done(r, active, atol):
    """Host check of the lanes: (all settled, all converged, new active
    mask) from one fetch of the per-lane residual norms.  Where the loop
    goes on, counts the lanes its step computes (``krylov.lane_iters``)
    and those of them already settled, whose results the step's
    :func:`_freeze` discards (``krylov.settled_lane_iters``)."""
    rn = _fetch(torch.sqrt(_dot_b(r, r).real))
    act = _fetch(active)
    done = rn <= atol
    settled = done | ~act
    if not np.all(settled):
        trace.count('krylov.lane_iters', settled.size)
        trace.count('krylov.settled_lane_iters', np.count_nonzero(settled))
    return (bool(np.all(settled)), bool(np.all(done)),
            torch.tensor(act & ~done, device=active.device))


def _bicgstab_batched(matvec, precond, b, x, atol, maxiter, on_iter):
    """Per-lane BiCGSTAB with (B,) device scalars and lane freezing.

    Converged or broken-down lanes are frozen by masks; the iteration
    stops when every lane is settled (or at maxiter).  Returns (x, info)
    with info 0 if every lane converged, -1 if some broke down.
    """
    r = tuple(bb - aa for bb, aa in zip(b, matvec(x)))
    rtilde = r
    one = torch.ones(r[0].shape[0], dtype=r[0].dtype, device=r[0].device)
    rho_prev = alpha = omega = one
    v = tuple(torch.zeros_like(c) for c in r)
    p = tuple(torch.zeros_like(c) for c in r)
    active = torch.ones(len(one), dtype=torch.bool, device=one.device)

    for _ in trace.each('krylov.iter', range(maxiter)):
        settled, converged, active = _lanes_done(r, active, atol)
        if settled:
            return x, 0 if converged else -1

        rho = _dot_b(rtilde, r)
        active = active & ((rho.real**2 + rho.imag**2) > 0)
        beta = (_cdiv_guard(rho, rho_prev, active) *
                _cdiv_guard(alpha, omega, active))
        bb_, om_ = _bcast(beta), _bcast(omega)
        p = _freeze(active, tuple(rr + bb_ * (pp - om_ * vv)
                                  for rr, pp, vv in zip(r, p, v)), p)

        phat = precond(p)
        v = _freeze(active, matvec(phat), v)
        denom = _dot_b(rtilde, v)
        active = active & ((denom.real**2 + denom.imag**2) > 0)
        alpha = _cdiv_guard(rho, denom, active)
        al_ = _bcast(alpha)
        sres = tuple(rr - al_ * vv for rr, vv in zip(r, v))

        shat = precond(sres)
        t = matvec(shat)
        tt = _dot_b(t, t)
        omega = _cdiv_guard(_dot_b(t, sres), tt, active & (tt.real > 0))
        om2_ = _bcast(omega)
        x = _freeze(active, tuple(xx + al_ * ph + om2_ * sh for xx, ph, sh
                                  in zip(x, phat, shat)), x)
        r = _freeze(active, tuple(ss - om2_ * ttt
                                  for ss, ttt in zip(sres, t)), r)
        rho_prev = rho
        on_iter()
    return x, maxiter


def _cgs_batched(matvec, precond, b, x, atol, maxiter, on_iter):
    """Per-lane CGS with (B,) device scalars and lane freezing (the lane
    protocol of :func:`_bicgstab_batched`).  With q = p = 0 and
    rho_prev = 1 the first iteration needs no special case."""
    r = tuple(bb - aa for bb, aa in zip(b, matvec(x)))
    rtilde = r
    rho_prev = torch.ones(r[0].shape[0], dtype=r[0].dtype,
                          device=r[0].device)
    q = tuple(torch.zeros_like(c) for c in r)
    p = tuple(torch.zeros_like(c) for c in r)
    active = torch.ones(len(rho_prev), dtype=torch.bool,
                        device=rho_prev.device)

    for _ in trace.each('krylov.iter', range(maxiter)):
        settled, converged, active = _lanes_done(r, active, atol)
        if settled:
            return x, 0 if converged else -1

        rho = _dot_b(rtilde, r)
        active = active & ((rho.real**2 + rho.imag**2) > 0)
        bb_ = _bcast(_cdiv_guard(rho, rho_prev, active))
        u = tuple(rr + bb_ * qq for rr, qq in zip(r, q))
        p = _freeze(active, tuple(uu + bb_ * (qq + bb_ * pp)
                                  for uu, qq, pp in zip(u, q, p)), p)

        phat = precond(p)
        vhat = matvec(phat)
        denom = _dot_b(rtilde, vhat)
        active = active & ((denom.real**2 + denom.imag**2) > 0)
        al_ = _bcast(_cdiv_guard(rho, denom, active))
        q = _freeze(active, tuple(uu - al_ * vv
                                  for uu, vv in zip(u, vhat)), q)
        uq = tuple(uu + qq for uu, qq in zip(u, q))

        uqhat = precond(uq)
        w = matvec(uqhat)
        x = _freeze(active, tuple(xx + al_ * uu
                                  for xx, uu in zip(x, uqhat)), x)
        r = _freeze(active, tuple(rr - al_ * ww for rr, ww in zip(r, w)), r)
        rho_prev = rho
        on_iter()
    return x, maxiter
