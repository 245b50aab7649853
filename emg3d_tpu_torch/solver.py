"""Multigrid solve and MG-preconditioned Krylov (the JAX package's
solver.py, in torch).

Counterpart of ``emg3d_tpu/solver.py``: ``solve`` with any ``cycle``
('F', 'V', 'W'), ``semicoarsening`` and ``linerelaxation`` (fixed or
rotating schedules), standalone or as the preconditioner of
``sslsolver`` 'bicgstab' (True) or 'cgs'.

- The level hierarchy (coarse η/ζ, cell widths, transfer weights) is
  built at solve start, on the device, once per semicoarsening
  direction.  The smoothers' field-independent state (point: η edge
  sums, ζ face weights, node-block LDLᵀ factors; line: rotated
  parameters and block-Thomas factor stacks) is built lazily, once per
  level (and axis) and solve; the finest level's line state is shared
  by all hierarchies, and factor stacks are cached only up to a share
  of the card (:data:`.ops.line_gs.LINE_SHARE`).
- The V/W/F recursion (including the ``cycmax − it`` F-cycle trick) runs
  eagerly, cycle by cycle, as the JAX package does on the CPU; PyTorch
  needs no jit, chunked dispatch or compile probes.
- The host loop pulls one residual norm per cycle and applies the
  reference's termination logic (CONVERGED / DIVERGED / STAGNATED /
  MAX-IT); the Krylov solvers take the JAX package's host-scalar route.

GCROT(m,k) and batched solves belong to later slices of the port and
raise ``NotImplementedError``.
"""
import itertools
import math
from dataclasses import dataclass

import numpy as np
import torch

from . import fields, models, utils
from .dtypes import COMPLEX, REAL
from .ops import line_gs, point_gs, stencil, transfers

__all__ = ['solve', 'multigrid', 'krylov', 'MGParameters']


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
                 'nodes', 'h_np', 'pstate', 'lstate', 'meter')

    def __init__(self, shape, arrays, h_np, nodes, meter):
        self.shape = shape          # cell shape
        self.arrays = arrays        # (eta_x, eta_y, eta_z, zeta, hx, hy, hz)
        self.h_np = h_np            # numpy widths (for weight building)
        self.nodes = nodes          # numpy node vectors
        self.coarsen = None
        self.rweights = None
        self.pweights = None
        self.pstate = None          # point-smoother state (built lazily)
        self.lstate = {}            # axis -> line state (built lazily)
        self.meter = meter          # cached factor bytes, solve-wide


def build_levels(grid, vmodel, sc_dir, clevel, device, meter):
    """Build the full level hierarchy for one top-level sc_dir.

    η is complex128 on ``device`` (a real Laplace-domain η is promoted;
    its imaginary part stays exactly zero), ζ and the widths float64.
    ``meter`` is the solve's ``{'bytes': n}`` of cached line factors.
    """
    def tens(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    eta_x = tens(vmodel.eta_x, COMPLEX)
    eta_y = eta_x if vmodel.eta_y is vmodel.eta_x \
        else tens(vmodel.eta_y, COMPLEX)
    eta_z = eta_x if vmodel.eta_z is vmodel.eta_x \
        else tens(vmodel.eta_z, COMPLEX)
    zeta = tens(vmodel.zeta, REAL)

    h_np = [np.asarray(h, dtype=np.float64) for h in grid.h]
    nodes = [np.r_[0., np.cumsum(h)] + o
             for h, o in zip(h_np, grid.origin)]
    shape = tuple(grid.shape_cells)
    arrays = (eta_x, eta_y, eta_z, zeta, *[tens(h, REAL) for h in h_np])
    levels = [_Level(shape, arrays, h_np, nodes, meter)]

    for _ in range(clevel):
        cur = levels[-1]
        coarsen = _coarsen_flags(_current_sc_dir(sc_dir, cur.shape))
        cur.coarsen = coarsen

        # Coarse grid geometry.
        cnodes = [cur.nodes[ax][::2] if coarsen[ax] else cur.nodes[ax]
                  for ax in range(3)]
        ch_np = [np.diff(cn) for cn in cnodes]
        cshape = tuple(len(h) for h in ch_np)

        # Restriction / prolongation weights (host, then device).
        rw, pw = [None]*3, [None]*3
        for ax in range(3):
            if coarsen[ax]:
                centers = (cur.nodes[ax][:-1] + cur.nodes[ax][1:]) / 2
                ccenters = (cnodes[ax][:-1] + cnodes[ax][1:]) / 2
                rw[ax] = tuple(tens(w, REAL) for w in
                               transfers.restrict_weights_1d(
                                   cur.nodes[ax], centers, cur.h_np[ax],
                                   cnodes[ax], ccenters, ch_np[ax]))
                pw[ax] = tens(transfers.prolong_weights_1d(
                    cur.nodes[ax], cnodes[ax]), REAL)
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
        carrays = (cex, cey, cez, czeta, *[tens(h, REAL) for h in ch_np])
        levels.append(_Level(cshape, carrays, ch_np, cnodes, meter))
    return levels


# ======================================================================
# The MG cycle
# ======================================================================

# Point-smoother modes: None takes the kernel point_gs.point_kernel
# names for the level (the faster one on the card, K1 only where its
# factor stack fits); 'factored'/'fused' pin a kernel; 'plain' runs the
# plain torch version on any device (comparisons on the card).
_MODES = (None, 'factored', 'fused', 'plain')


def _level_state(lev, mode):
    """The level's point-smoother state, built once per level and solve."""
    if lev.pstate is None:
        dev = lev.arrays[0].device
        factored = mode in ('factored', 'plain') or (
            mode is None and point_gs.point_kernel(lev.shape, dev)
            == 'factored')
        lev.pstate = point_gs.point_state(lev.arrays, lev.shape,
                                          factored=factored)
    return lev.pstate


def _line_state(lev, axis, mode=None):
    """The level's ``axis``-line state, built once per level and solve.

    Memory rule: the factor stack is kept only while the solve's cached
    stacks stay within :func:`.ops.line_gs.cache_budget`; otherwise the
    state holds none and every smoothing call rebuilds it (the JAX
    package's ``()`` sentinel, solver.py:697-719).  The numbers are the
    same either way.  ``mode='plain'`` builds the stack with the plain
    elimination (no kernel), as the plain smoothers run.
    """
    state = lev.lstate.get(axis)
    if state is None:
        nbytes = line_gs.factor_bytes(lev.shape, axis)
        keep = (lev.meter['bytes'] + nbytes
                <= line_gs.cache_budget(lev.arrays[0].device))
        state = line_gs.line_state(lev.arrays, lev.shape, axis,
                                   factors=keep, plain=mode == 'plain')
        if keep:
            lev.meter['bytes'] += nbytes
        lev.lstate[axis] = state
    return state


def _smooth(e, s, lev, nu, lr_dir, mode=None):
    """Smoothing dispatch (reference parity: solver.py:461-523).

    Point smoothing where the level's lr_dir is 0, else line relaxation
    along each of its axes in turn.  Updates ``e`` in place and returns
    it.
    """
    if nu <= 0:
        return e
    lr = _current_lr_dir(lr_dir, lev.shape)
    if lr == 0:
        state = _level_state(lev, mode)
        if mode == 'plain':
            return point_gs.gauss_seidel_point_plain(e, s, state, nu)
        return point_gs.gauss_seidel_point(e, s, state, nu)
    for ax in _lr_axes(lr):
        state = _line_state(lev, ax, mode)
        if mode == 'plain':
            e = line_gs.line_relaxation_plain(e, s, state, nu)
        else:
            e = line_gs.line_relaxation(e, s, state, nu)
    return e


def _residual_e(e, s, arrays):
    return stencil.residual_parts(*s, *e, *arrays)


def _edge_shapes(shape):
    nx, ny, nz = shape
    return ((nx, ny+1, nz+1), (nx+1, ny, nz+1), (nx+1, ny+1, nz))


def _gs_info(it, level, cycmax, shape, norm):
    """Debug line after a smoothing step (verb>4; reference format)."""
    nx, ny, nz = shape
    return (f"     {it:2} {level} {cycmax} [{nx:3}, {ny:3}, "
            f"{nz:3}]: {norm:.3e} ")


def _mg_rec(e, s, levels, lvl, cycmax, new_cycmax, conf, mode=None,
            dbg=None):
    """Recursive multigrid body (reference parity: solver.py:478-604).

    Includes the ``new_cycmax = cycmax - it`` F-cycle construction; the
    top level (``lvl == 0``) runs one cycle per call.  ``dbg`` is the
    MGParameters instance when verb>4: each smoothing step then logs
    its residual norm.
    """
    (nu_pre, nu_coarse, nu_post, cycle, lr_dir) = conf
    lev = levels[lvl]

    def report(it_, cycmax_, tag):
        if dbg is not None:
            nrm = residual_norm(e, s, lev.arrays)
            dbg.cprint(_gs_info(it_, lvl, cycmax_, lev.shape, nrm)
                       + tag, 4)

    if lvl == len(levels) - 1:
        # Coarsest grid: nu_coarse smoothing steps act as direct solve.
        e = _smooth(e, s, lev, nu_coarse, lr_dir, mode)
        report(0, 1, "coarsest level")
        return e

    if lvl == 0 or new_cycmax == 0 or cycle != 'F':
        cycmax_here = cycmax
    else:
        cycmax_here = new_cycmax

    it = 0
    while it < cycmax_here:
        e = _smooth(e, s, lev, nu_pre, lr_dir, mode)
        if nu_pre > 0:
            report(it, cycmax_here, "pre-smoothing")

        r = _residual_e(e, s, lev.arrays)
        rc = transfers.restrict(*r, lev.rweights, lev.coarsen)
        rc = stencil.pec_mask_apply(*rc)
        ec = tuple(torch.zeros(sh, dtype=e[0].dtype, device=e[0].device)
                   for sh in _edge_shapes(levels[lvl + 1].shape))

        ec = _mg_rec(ec, rc, levels, lvl + 1,
                     2 if cycle in ['F', 'W'] else 1,
                     cycmax_here - it, conf, mode, dbg)

        e = transfers.prolongate(*e, *ec, lev.pweights, lev.coarsen)
        e = stencil.pec_mask_apply(*e)

        e = _smooth(e, s, lev, nu_post, lr_dir, mode)
        if nu_post > 0:
            report(it, cycmax_here, "post-smoothing")

        it += 1
        if lvl == 0:
            break
    return e


def run_one_cycle(e, s, levels, conf, nu_init=0, mode=None, dbg=None):
    """One top-level MG cycle; returns the new field tensors."""
    if nu_init > 0:
        e = _smooth(e, s, levels[0], nu_init, conf[4], mode)
        if dbg is not None:
            nrm = residual_norm(e, s, levels[0].arrays)
            dbg.cprint(_gs_info(0, 0, 1, levels[0].shape, nrm)
                       + "initial smoothing", 4)
    return _mg_rec(e, s, levels, 0, 2 if conf[3] in ['F', 'W'] else 1, 0,
                   conf, mode, dbg)


def _norm(rx, ry, rz):
    return torch.sqrt(sum(torch.sum(r.real**2 + r.imag**2)
                          for r in (rx, ry, rz)))


def residual_norm(e, s, arrays):
    """‖s − A e‖₂ as a Python float (one device-to-host copy)."""
    return float(_norm(*_residual_e(e, s, arrays)))


# ======================================================================
# Host loop
# ======================================================================

class _SolveContext:
    """Per-solve state: device fields and level hierarchies per sc_dir."""

    def __init__(self, grid, vmodel, sfield, efield, var, device, mode):
        self.grid = grid
        self.vmodel = vmodel
        self.var = var
        self.device = device
        self.mode = mode
        self.s = tuple(torch.tensor(np.asarray(f), dtype=COMPLEX,
                                    device=device)
                       for f in (sfield.fx, sfield.fy, sfield.fz))
        self.e = tuple(torch.tensor(np.asarray(f), dtype=COMPLEX,
                                    device=device)
                       for f in (efield.fx, efield.fy, efield.fz))
        self._levels = {}
        self.meter = {'bytes': 0}

    def levels(self, sc_dir):
        if sc_dir not in self._levels:
            clevel = int(self.var.clevel[int(sc_dir)])
            levels = build_levels(self.grid, self.vmodel, int(sc_dir),
                                  clevel, self.device, self.meter)
            if self._levels:
                # The finest level is the same in every hierarchy: share
                # its parameters and line states (no number changes).
                fine = next(iter(self._levels.values()))[0]
                levels[0].arrays = fine.arrays
                levels[0].lstate = fine.lstate
            self._levels[sc_dir] = levels
        return self._levels[sc_dir]


def multigrid(ctx, var, e=None, s=None, track=True):
    """Run MG cycles with the reference's termination logic.

    If ``e``/``s`` are given, runs on those fields (the Krylov
    preconditioner); else on ctx.e/ctx.s (standalone; stores the
    solution in ``ctx.e``).  One cycle at a time, as the JAX package
    does on the CPU (its chunked and pipelined dispatch exist only for
    the TPU).  ``track`` records the per-cycle runtime and error and
    logs each cycle.
    """
    standalone = e is None
    if standalone:
        e, s = ctx.e, ctx.s
    fine = ctx.levels(int(var.sc_dir))[0]
    l2_last = residual_norm(e, s, fine.arrays)
    l2_prev = None
    l2_stag = np.ones(var._maxcycle) * l2_last
    # As a Krylov preconditioner the rhs is a Krylov vector, not the
    # source: judge convergence against this call's own rhs norm.
    refe = var.l2_refe if standalone else l2_last

    dbg = var if var.verb > 4 else None
    if dbg is not None:
        var.cprint("     it cycmax               error", 4)
        var.cprint("      level [  dimension  ]            info\n", 4)
        var.cprint(_gs_info(0, 0, var.cycmax, fine.shape, l2_last)
                   + "initial error", 4)

    it = 0
    first = True
    while True:
        conf = (var.nu_pre, var.nu_coarse, var.nu_post, var.cycle,
                int(var.lr_dir))
        levels = ctx.levels(int(var.sc_dir))
        nu_init = var.nu_init if first else 0
        if first and var.verb > 3 and var._first_cycle:
            _qc_levels(var._level_all, len(levels), 0,
                       2 if var.cycle in ('F', 'W') else 1, 0,
                       var.cycle)
        first = False

        e = run_one_cycle(e, s, levels, conf, nu_init=nu_init,
                          mode=ctx.mode, dbg=dbg)
        l2 = residual_norm(e, s, levels[0].arrays)

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

    var.l2 = l2_last
    if standalone:
        ctx.e = e
    return e


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

def _dot(a, b):
    """Standard complex inner product <a, b> = sum(conj(a)*b)."""
    tot = 0j
    for x, y in zip(a, b):
        tot = tot + complex(torch.vdot(x.reshape(-1), y.reshape(-1)))
    return tot


def _axpy(alpha, x, y):
    return tuple(yy + alpha * xx for xx, yy in zip(x, y))


def krylov(ctx, var):
    """MG-preconditioned BiCGSTAB/CGS (reference: solver.py:1965-2124).

    scipy's algorithms with host scalars, so iteration counts are
    comparable; the right preconditioner M is :func:`multigrid` on a
    zero field (up to ``var.maxit`` cycles, with the sc/lr schedules
    advancing one step per cycle).  A diverging or stagnating
    preconditioner aborts with a zero field.
    """
    fine = ctx.levels(int(var.sc_dir))[0]
    arrays = fine.arrays
    s = ctx.s
    x = ctx.e

    def matvec(e):
        return stencil.amat(*e, *arrays)

    def precond(r):
        ez = tuple(torch.zeros_like(c) for c in r)
        return multigrid(ctx, var, e=ez, s=r, track=False)

    def callback(xk):
        var._ssl_it += 1
        var.runtime_at_cycle = np.r_[var.runtime_at_cycle,
                                     var.time.elapsed]
        var.l2 = residual_norm(xk, s, arrays)
        var.error_at_cycle = np.r_[var.error_at_cycle, var.l2]
        if var.verb > 3:
            log = f"   [{var.time.now}]   {var.l2/var.l2_refe:.3e} "
            log += f" after {var._ssl_it:3} {var.sslsolver}-cycles"
            var.cprint(log, 3)
        elif var.verb < 0:
            var.one_liner(var.l2)

    bnorm = float(_norm(*s))
    atol = max(float(var.tol) * bnorm, 1e-30)
    solver = _bicgstab if var.sslsolver == 'bicgstab' else _cgs
    try:
        x, info = solver(matvec, precond, s, x, atol, var.ssl_maxit,
                         callback)
    except _ConvergenceError:
        info = -1
        x = tuple(torch.zeros_like(c) for c in s)
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
    var.l2 = residual_norm(x, s, arrays)
    return x


def _bicgstab(matvec, precond, b, x, atol, maxiter, callback):
    """Right-preconditioned BiCGSTAB (scipy-compatible formulation)."""
    r = tuple(bb - aa for bb, aa in zip(b, matvec(x)))
    rtilde = r
    rho_prev, alpha, omega = 1.0, 1.0, 1.0
    v = p = None

    for it in range(maxiter):
        if float(_norm(*r)) <= atol:
            return x, 0
        rho = _dot(rtilde, r)
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
        denom = _dot(rtilde, v)
        if denom == 0:
            return x, -11
        alpha = rho / denom
        sres = tuple(rr - alpha * vv for rr, vv in zip(r, v))
        if float(_norm(*sres)) <= atol:
            x = _axpy(alpha, phat, x)
            callback(x)
            return x, 0
        shat = precond(sres)
        t = matvec(shat)
        tt = _dot(t, t)
        if tt == 0:
            return x, -12
        omega = _dot(t, sres) / tt
        x = _axpy(alpha, phat, x)
        x = _axpy(omega, shat, x)
        r = tuple(ss - omega * ttt for ss, ttt in zip(sres, t))
        rho_prev = rho
        callback(x)
        if omega == 0:
            return x, -13
    return x, maxiter


def _cgs(matvec, precond, b, x, atol, maxiter, callback):
    """Preconditioned CGS."""
    r = tuple(bb - aa for bb, aa in zip(b, matvec(x)))
    rtilde = r
    rho_prev = 1.0
    u = p = q = None

    for it in range(maxiter):
        if float(_norm(*r)) <= atol:
            return x, 0
        rho = _dot(rtilde, r)
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
        denom = _dot(rtilde, vhat)
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
    sslsolver : {False, True, 'bicgstab', 'cgs'} ('gcrotmk' is not
        ported yet)
    semicoarsening : bool/int/digit-cycle
    linerelaxation : bool/int/digit-cycle
    verb : int
    device : torch device or str, optional — where the solve runs.
        None means ``'cuda'`` and raises when no CUDA device exists;
        CPU runs ask for ``device='cpu'``.
    kwargs : tol, maxit, nu_init, nu_pre, nu_coarse, nu_post, clevel,
        return_info, log

    Returns
    -------
    efield : Field (if no initial efield was provided)
    info_dict : dict (if return_info=True)
    """
    device = _resolve_device(device)
    # Private: pin the point-smoother kernel ('factored', 'fused') or
    # run the plain torch version ('plain'); see _MODES.
    mode = kwargs.pop('_mode', None)
    if mode not in _MODES:
        raise ValueError(f"_mode must be one of {_MODES}; got {mode!r}")
    var = MGParameters(
        verb=verb, cycle=cycle, sslsolver=sslsolver,
        linerelaxation=linerelaxation, semicoarsening=semicoarsening,
        shape_cells=tuple(grid.shape_cells), **kwargs)
    if var.sslsolver == 'gcrotmk':
        raise NotImplementedError(
            "sslsolver='gcrotmk' is not ported to emg3d_tpu_torch yet; "
            "it comes with the GCROT(m,k) slice of the port (use "
            "'bicgstab' or 'cgs').")

    do_return = True

    # Compute reference error for tolerance.
    var.l2_refe = float(sfield.norm())
    var.cprint(f"\n:: emg3d_tpu_torch START :: {var.time.now} :: "
               f"v{__import__('emg3d_tpu_torch').__version__}\n", 2)
    var.cprint(var, 2)

    vmodel = models.VolumeModel(grid, model, sfield)
    out_dtype = np.asarray(sfield.fx).dtype

    if efield is None:
        efield = fields.Field.zeros(grid, frequency=sfield._frequency,
                                    dtype=out_dtype)
    else:
        do_return = False
        var.do_return = False
        # Warm start: if converged already, return immediately.
        ctx0 = _SolveContext(grid, vmodel, sfield, efield, var, device,
                             mode)
        fine = ctx0.levels(int(var.sc_dir))[0]
        l2 = residual_norm(ctx0.e, ctx0.s, fine.arrays)
        if l2 < var.tol * var.l2_refe and not var.sslsolver:
            var.exit_message = "CONVERGED"
            var.cprint("   > NOTHING DONE (provided efield already "
                       "converged)\n", 2)
            if var.return_info:
                return _info_dict(var)
            return None

    # Zero source field => zero efield.
    if var.l2_refe == 0:
        var.exit_message = "CONVERGED"
        var.cprint("   > RETURN ZERO E-FIELD (provided sfield is zero)\n",
                   2)
        z = fields.Field.zeros(grid, frequency=sfield._frequency,
                               dtype=out_dtype)
        if not do_return:
            for a, b in zip((efield.fx, efield.fy, efield.fz),
                            (z.fx, z.fy, z.fz)):
                np.asarray(a)[...] = b
            if var.return_info:
                return _info_dict(var)
            return None
        if var.return_info:
            return z, _info_dict(var)
        return z

    ctx = _SolveContext(grid, vmodel, sfield, efield, var, device, mode)
    # krylov() catches _ConvergenceError itself, and standalone multigrid
    # never raises it.
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

    comps = [t.cpu().numpy() for t in ctx.e]
    if not np.iscomplexobj(np.zeros(0, out_dtype)):
        # Laplace domain: the solve ran promoted to complex128, with an
        # imaginary part that stays exactly zero.
        comps = [c.real for c in comps]
    comps = [np.ascontiguousarray(c, dtype=out_dtype) for c in comps]
    out = fields.Field(comps[0], comps[1], comps[2],
                       frequency=sfield._frequency)

    if not do_return:
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


def _info_dict(var):
    return {
        'exit': 0 if var.exit_message == 'CONVERGED' else 1,
        'exit_message': var.exit_message,
        'abs_error': var.l2,
        'rel_error': var.l2 / var.l2_refe if var.l2_refe else 0.0,
        'ref_error': var.l2_refe,
        'tol': var.tol,
        'it_mg': var.it,
        'it_ssl': var._ssl_it,
        'time': var.time.elapsed,
        'runtime_at_cycle': var.runtime_at_cycle,
        'error_at_cycle': var.error_at_cycle,
        'log': var.log_message,
    }
