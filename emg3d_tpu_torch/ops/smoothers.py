"""Parallel multicolor point smoother as torch ops (the plain version).

Counterpart of ``emg3d_tpu/ops/smoothers.py:42-126``: the [ArFW00]
overlapping 6-edge node blocks, updated in δ-form — solve
``A_block δ = r_block`` (the current residual restricted to the block)
and add δ.  Nodes are updated in 8 colours by full index parity, so the
blocks of one colour are uncoupled and each colour is a true
block-Gauss-Seidel step.  All node systems of a colour are solved at
once by the batched sparse 6×6 LDLᵀ.

This is the math that the CUDA kernels of :mod:`.point_gs` are held
to; their wrapper runs it for CPU tensors.  The line-relaxation half of
the JAX module belongs to a later slice of the port.
"""
import torch

from . import stencil
from .blocksolve import ldl_factor_sparse, ldl_solve_factored
from .coeffs import node_coefficients, node_block_entries

__all__ = ['gauss_seidel_point', 'color_sequence', 'color_steps',
           'node_factors']


def color_sequence(nu):
    """Colours 0..7 on even sweeps and 7..0 on odd sweeps."""
    seq = []
    for it in range(nu):
        seq.extend(range(8) if it % 2 == 0 else range(7, -1, -1))
    return seq


def _residual(e, s, par):
    return stencil.residual_parts(s[0], s[1], s[2], e[0], e[1], e[2], *par)


def _point_color_update(e, s, par, fact, color):
    """One color of the 8-color node-block update (returns new tensors).

    ``color`` 0..7 encodes the parity triple (cx, cy, cz) = (color % 2,
    (color // 2) % 2, color // 4): a node (ix, iy, iz) is active iff
    (ix%2, iy%2, iz%2) == (cx, cy, cz).  Eight colors are required (not
    two): blocks of face- and edge-diagonal neighbor nodes are coupled
    through the operator, so only full-parity separation makes the
    simultaneous update a true block-GS step.
    """
    ex, ey, ez = e
    rx, ry, rz = _residual(e, s, par)

    # Residual at the six block edges of every interior node.
    rb = [rx[:-1, 1:-1, 1:-1], rx[1:, 1:-1, 1:-1],
          ry[1:-1, :-1, 1:-1], ry[1:-1, 1:, 1:-1],
          rz[1:-1, 1:-1, :-1], rz[1:-1, 1:-1, 1:]]

    delta = ldl_solve_factored(6, fact[0], fact[1], rb)

    # Node color mask; zero-based node (i0,j0,k0) = (ix-1, iy-1, iz-1).
    nsh = rb[0].shape
    dev = rb[0].device
    px, py, pz = color % 2, (color // 2) % 2, color // 4
    ii = torch.arange(nsh[0], device=dev)[:, None, None]
    jj = torch.arange(nsh[1], device=dev)[None, :, None]
    kk = torch.arange(nsh[2], device=dev)[None, None, :]
    mask = ((((ii + 1) % 2) == px) & (((jj + 1) % 2) == py) &
            (((kk + 1) % 2) == pz))
    dm = [torch.where(mask, d, torch.zeros((), dtype=d.dtype, device=dev))
          for d in delta]

    # Scatter-add: each edge receives δ from exactly one active node.
    pad = torch.nn.functional.pad
    ex = ex.clone()
    ey = ey.clone()
    ez = ez.clone()
    ex[:, 1:-1, 1:-1] += pad(dm[0], (0, 0, 0, 0, 0, 1)) + \
        pad(dm[1], (0, 0, 0, 0, 1, 0))
    ey[1:-1, :, 1:-1] += pad(dm[2], (0, 0, 0, 1, 0, 0)) + \
        pad(dm[3], (0, 0, 1, 0, 0, 0))
    ez[1:-1, 1:-1, :] += pad(dm[4], (0, 1, 0, 0, 0, 0)) + \
        pad(dm[5], (1, 0, 0, 0, 0, 0))
    return ex, ey, ez


def node_factors(par):
    """Sparse LDLᵀ factors (L, dinv) of every interior node block."""
    return ldl_factor_sparse(6, node_block_entries(node_coefficients(*par)))


def color_steps(e, s, par, seq, fact=None):
    """Colour steps in the order of ``seq`` (returns new tensors).

    With ``fact=None`` the blocks are re-factored every step, as the
    fused kernel does; otherwise ``fact`` is used throughout.
    """
    for color in seq:
        f = node_factors(par) if fact is None else fact
        e = _point_color_update(e, s, par, f, color)
    return e


def gauss_seidel_point(ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
                       hx, hy, hz, nu):
    """nu sweeps of 8-color node-block Gauss-Seidel (returns new tensors).

    Each sweep updates all eight colors; the color order alternates
    between sweeps.  The default nu is calibrated in
    :class:`emg3d_tpu_torch.solver.MGParameters`: three color-sweeps
    match two lexicographic sweeps in two-grid strength.
    """
    par = (eta_x, eta_y, eta_z, zeta, hx, hy, hz)
    # The block factorization is field-independent: factor once here,
    # outside the color sweep.
    return color_steps((ex, ey, ez), (sx, sy, sz), par,
                       color_sequence(nu), fact=node_factors(par))
