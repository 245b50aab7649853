"""Parallel multicolor point smoother as torch ops (the plain version).

Counterpart of ``emg3d_tpu/ops/smoothers.py:42-126``: the [ArFW00]
overlapping 6-edge node blocks, updated in δ-form — solve
``A_block δ = r_block`` (the current residual restricted to the block)
and add δ.  Nodes are updated in 8 colours by full index parity, so the
blocks of one colour are uncoupled and each colour is a true
block-Gauss-Seidel step.  All node systems of a colour are solved at
once by the batched sparse 6×6 LDLᵀ.

This is the math that the CUDA kernels of :mod:`.point_gs` are held
to; their wrapper runs it for CPU tensors.

The second half is line relaxation (``emg3d_tpu/ops/smoothers.py:
245-482``): 4-colour x-line Gauss-Seidel, each line a 5×5
block-tridiagonal system solved by the sparse-entry block-Thomas of
:mod:`.blocksolve`; y- and z-lines run the x-line code in a cyclically
rotated frame.  The field-independent factor stack is one tensor
(:func:`line_factor_stack`: the packed entries of
:func:`pack_line_entries`, eliminated in place by
:func:`factor_line_stack_`), which the line kernels of :mod:`.line_gs`
build and read as it is; :func:`line_factor_stack` and
:func:`line_color_steps` are the math they are held to.
"""
import torch

from . import stencil
from .blocksolve import (block_tridiag_factor_entries,
                         block_tridiag_solve_entries, ldl_factor_sparse,
                         ldl_solve_factored)
from .coeffs import (face_coefficients, node_block_entries,
                     node_coefficients)

__all__ = ['gauss_seidel_point', 'color_sequence', 'color_steps',
           'node_factors', 'line_relaxation', 'line_color_sequence',
           'line_color_steps', 'line_factor_stack', 'pack_line_entries',
           'line_station_entries', 'factor_line_stack_', 'rotate_arrays',
           'rotate_fields', 'unrotate_fields', 'rotate_shape',
           'line_thomas_x', 'dense_station_blocks', 'LINE_BKEYS', 'NLINE']


def color_sequence(nu):
    """Colours 0..7 on even sweeps and 7..0 on odd sweeps."""
    seq = []
    for it in range(nu):
        seq.extend(range(8) if it % 2 == 0 else range(7, -1, -1))
    return seq


def _residual(e, s, par, sw=None):
    """s − A e from the model parameters ``par``, or, where ``sw`` is
    given, from its (η edge sums, ζ face weights, inverse widths)."""
    if sw is not None:
        return stencil.residual_sw(*s, *e, *sw)
    return stencil.residual_parts(s[0], s[1], s[2], e[0], e[1], e[2], *par)


def _point_color_update(e, s, par, fact, color, sw=None):
    """One color of the 8-color node-block update (returns new tensors).

    ``color`` 0..7 encodes the parity triple (cx, cy, cz) = (color % 2,
    (color // 2) % 2, color // 4): a node (ix, iy, iz) is active iff
    (ix%2, iy%2, iz%2) == (cx, cy, cz).  Eight colors are required (not
    two): blocks of face- and edge-diagonal neighbor nodes are coupled
    through the operator, so only full-parity separation makes the
    simultaneous update a true block-GS step.
    """
    ex, ey, ez = e
    rx, ry, rz = _residual(e, s, par, sw)

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


def node_factors(par, sw=None):
    """Sparse LDLᵀ factors (L, dinv) of every interior node block, from
    the model parameters ``par`` or, where given, from ``sw`` (η edge
    sums, ζ face weights, inverse widths: the fused kernel's inputs)."""
    c = node_coefficients(*par) if sw is None else face_coefficients(*sw)
    return ldl_factor_sparse(6, node_block_entries(c))


def color_steps(e, s, par, seq, fact=None, sw=None):
    """Colour steps in the order of ``seq`` (returns new tensors).

    With ``fact=None`` the blocks are re-factored every step, as the
    fused kernel does; otherwise ``fact`` is used throughout.  ``sw``
    (η edge sums, ζ face weights, inverse widths) replaces the model
    parameters in the residuals and the re-factored blocks: a
    bfloat16-stored solve passes them rounded, as its kernels load them.
    """
    for color in seq:
        f = node_factors(par, sw) if fact is None else fact
        e = _point_color_update(e, s, par, f, color, sw)
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


# ----------------------------------------------------------------------
# Line relaxation
# ----------------------------------------------------------------------

# Entry planes of the line factor stack (S, NLINE, 2, 2, ny2, nz2): the
# strict-lower LDLᵀ factors of the eliminated station blocks C_i in
# _lower_keys(5) order (planes 0-9), their inverse diagonals (10-14) and
# the sparse sub-diagonal coupling blocks B_i (15-22, LINE_BKEYS order).
# The order of the JAX package's Pallas stack (_LORD, dinv, _BORD of
# pallas_lr.py:71-74) and of the line kernel.
LINE_BKEYS = ((0, 1), (0, 2), (0, 3), (0, 4), (1, 1), (2, 2), (3, 3),
              (4, 4))
NLINE = 10 + 5 + len(LINE_BKEYS)

# Station-block entry (a, b) of the x-line system <- node-block entry.
_D_MAP = {(0, 0): (0, 0), (1, 1): (2, 2), (2, 2): (3, 3),
          (3, 3): (4, 4), (4, 4): (5, 5), (1, 0): (2, 0),
          (2, 0): (3, 0), (3, 0): (4, 0), (4, 0): (5, 0),
          (3, 1): (4, 2), (4, 1): (5, 2), (3, 2): (4, 3),
          (4, 2): (5, 3)}


def _l_plane(a, b):
    """Plane of L(a, b), a > b, in ``_lower_keys(5)`` order."""
    return a * (a - 1) // 2 + b


def dense_station_blocks(q):
    """Dense 5×5 blocks ``(D, B)``, each ``(..., 5, 5)``, of the packed
    entry planes ``q`` (NLINE, ...) of one station before the
    elimination: D symmetric from its diagonal (planes 10-14) and lower
    (:func:`_l_plane`) planes, B's entries (a, k) from plane 15 + p of
    LINE_BKEYS, the others zero."""
    rows = []
    for a in range(5):
        rows.append(torch.stack([q[10 + a] if a == b else
                                 q[_l_plane(max(a, b), min(a, b))]
                                 for b in range(5)], -1))
    D = torch.stack(rows, -2)
    B = torch.zeros(q.shape[1:] + (5, 5), dtype=q.dtype, device=q.device)
    for p, (a, k) in enumerate(LINE_BKEYS):
        B[..., a, k] = q[15 + p]
    return D, B


def pack_line_entries(arrays, shape):
    """Station entries of the x-lines, packed where their factors go.

    Returns the ``(nx, NLINE, 2, 2, ny2, nz2)`` stack before the
    elimination: the 13 present entries D(a, b) of the station blocks
    at the plane of L(a, b) (a > b) or of the inverse diagonal
    (10 + a), zeros at the absent (2, 1) and (4, 3), and the B entries
    at planes 15-22 as in the finished stack.  The elimination
    (:func:`factor_line_stack_`) then overwrites planes 0-14 station by
    station, in place.
    """
    return _pack_entries(node_coefficients(*arrays), shape)


def line_station_entries(st, w, ih, shape):
    """:func:`pack_line_entries` from the η edge sums, ζ face weights and
    inverse widths of the (rotated) frame: the inputs the line kernel K5
    reads, in its formulas (:func:`.coeffs.face_coefficients`)."""
    return _pack_entries(face_coefficients(st, w, ih), shape)


def _pack_entries(c, shape):
    nx, ny, nz = shape
    ny2, nz2 = ny // 2, nz // 2          # = ceil((n-1)/2) interior lines
    ent = node_block_entries(c)
    nsh = ent[(0, 0)].shape              # (nx-1, nyn, nzn) interior nodes
    dev = ent[(0, 0)].device
    dtype = torch.promote_types(ent[(0, 0)].dtype, torch.complex64)
    # The station entries (emg3d_tpu/ops/smoothers.py:245-321), split
    # into the four line parities at once: (K, nx-1, nyn, nzn) ->
    # (K, nx-1, 2, 2, ny2, nz2); line (j0, k0), zero-based, sits at
    # [j0 % 2, k0 % 2, j0 // 2, k0 // 2].  Padded lines get identity
    # diagonals, the ex-only last station identity transverse rows.
    diag = [(0, 0), (2, 2), (3, 3), (4, 4), (5, 5)]          # planes 10-14
    off = {_l_plane(a, b): k for (a, b), k in _D_MAP.items() if a != b}
    bmix = [(2, 1), (3, 1), (4, 1), (5, 1)]                  # planes 15-18
    bdiag = [c.mzxLym, c.mzxLyp, c.myxLzm, c.myxLzp]         # planes 19-22
    vals = ([ent[k] for k in diag] + [ent[off[p]] for p in sorted(off)]
            + [ent[k] for k in bmix] + [-(m * c.ihxm) for m in bdiag]
            + [ent[(1, 1)]])
    real = c.ihxm.dtype
    del c, ent, bdiag
    # Zero-padded to even transverse extents, then viewed by parity.
    q = torch.zeros((len(vals), nsh[0], 2 * ny2, 2 * nz2), dtype=dtype,
                    device=dev)
    body = q[:, :, :nsh[1], :nsh[2]]
    for n in range(len(vals)):
        body[n] = vals[n]
        vals[n] = None
    q = q.reshape(-1, nsh[0], ny2, 2, nz2, 2).permute(0, 1, 3, 5, 2, 4)
    # pm (2, 2, ny2, nz2): 1 at padded (out-of-range) lines.
    jj = (2 * torch.arange(ny2, device=dev)[None, None, :, None]
          + torch.arange(2, device=dev)[:, None, None, None])
    kk = (2 * torch.arange(nz2, device=dev)[None, None, None, :]
          + torch.arange(2, device=dev)[None, :, None, None])
    pm = ((jj >= nsh[1]) | (kk >= nsh[2])).to(real)

    out = torch.zeros((nx, NLINE, 2, 2, ny2, nz2), dtype=dtype, device=dev)
    lo = sorted(off)
    out[:-1, 10:15] = q[:5].transpose(0, 1) + pm
    out[:-1, lo] = q[5:13].transpose(0, 1)
    # The ex-only last station: (1, 1) of the last node, identity rows.
    out[-1, 10] = q[21, -1] + pm
    out[-1, 11:15] = 1.0
    out[1:, 15:19] = q[13:17].transpose(0, 1)
    out[1:-1, 19:23] = q[17:21, 1:].transpose(0, 1)
    return out


def factor_line_stack_(stack):
    """Block-Thomas elimination of a packed stack, in place (plain).

    ``stack`` is :func:`pack_line_entries`' output; the D entries are
    read from their planes (the absent (2, 1) and (4, 3) stay absent)
    before each station's factors overwrite them: the elimination half
    of the line kernel K5's plain version.  Returns ``stack``.
    """
    Dent = {(a, b): stack[:, 10 + a if a == b else _l_plane(a, b)]
            for (a, b) in _D_MAP}
    Bent = {k: stack[:, 15 + p] for p, k in enumerate(LINE_BKEYS)}
    block_tridiag_factor_entries(5, Dent, Bent, out=stack[:, :15])
    return stack


def line_factor_stack(arrays, shape):
    """Factor stack ``(nx, NLINE, 2, 2, ny2, nz2)`` of the x-lines.

    Field-independent: the block-Thomas elimination of every line of
    the level (all four parities), written station by station into the
    packed entries (no second stack is ever held).  Lines are the
    fastest-varying axes, so the threads of one colour read
    neighbouring addresses.  ``arrays``/``shape`` are those of the
    (rotated) frame whose x-lines are solved.
    """
    return factor_line_stack_(pack_line_entries(arrays, shape))


def _parity_pick(a, cy, cz, ny2, nz2):
    """(..., S, Ny, Nz) -> the (cy, cz)-parity quarter (..., S, ny2,
    nz2)."""
    n1, n2 = a.shape[-2:]
    a = torch.nn.functional.pad(a, (0, 2 * nz2 - n2, 0, 2 * ny2 - n1))
    return a.reshape(*a.shape[:-2], ny2, 2, nz2, 2)[..., cy, :, cz]


def _parity_embed(d, cy, cz, nyn, nzn):
    """Inverse of :func:`_parity_pick`: quarter -> (..., S, nyn, nzn),
    zeros at the three inactive parities."""
    ny2, nz2 = d.shape[-2:]
    full = torch.zeros((*d.shape[:-2], ny2, 2, nz2, 2), dtype=d.dtype,
                       device=d.device)
    full[..., cy, :, cz] = d
    return full.reshape(*d.shape[:-2], 2 * ny2, 2 * nz2)[..., :nyn, :nzn]


def _line_color_update_x(e, s, par, fac, color, sw=None):
    """One colour of the 4-colour x-line update (returns new tensors).

    ``color`` = cy + 2·cz selects the lines whose transverse parity is
    (cy, cz); adjacent and diagonal lines are coupled through the
    operator, so only full transverse-parity separation makes the
    simultaneous update a true block-GS step.  Reference parity:
    ``emg3d_tpu/ops/smoothers.py:347-400``.
    """
    return line_thomas_x(e, _residual(e, s, par, sw), fac, color)


def line_thomas_x(e, r, fac, color, stations=None):
    """The block-Thomas half of a colour step, given the residual ``r``.

    Solves every line of the colour against the factor stack and adds
    δ into the line's ex and its adjacent ey/ez edges (new tensors).
    ``stations`` < nx solves the segment of the first ``stations``
    stations (one lane): its last station is a full one (no PEC end),
    against the first ``stations`` of ``fac``.
    With a leading lane axis on ``e`` and ``r`` (B, ...), ``fac`` is
    (B, ...) too: lane b's stack.  The lanes ride along the lines (the
    station recurrence is elementwise in them), so each lane's numbers
    are those of its one-lane call.
    """
    ex, ey, ez = e
    rx, ry, rz = r
    ny2, nz2 = fac.shape[-2:]
    nyn = rx.shape[-2] - 2         # interior node counts
    nzn = rx.shape[-1] - 2
    cy, cz = color % 2, color // 2
    lanes = rx.ndim == 4
    nx = rx.shape[-3]
    ns = nx if stations is None else int(stations)
    seg = ns < nx
    if seg and lanes:
        raise ValueError("line_thomas_x: a segment takes one lane")

    def first(t):                  # (B, S, ...) -> (S, B, ...)
        return t.movedim(0, 1) if lanes else t

    # Station residuals (5 component stacks), parity-picked; the last
    # station of a whole line has no transverse edges (zero-padded).
    if seg:
        tr = (ry[..., 1:ns + 1, :-1, 1:-1], ry[..., 1:ns + 1, 1:, 1:-1],
              rz[..., 1:ns + 1, 1:-1, :-1], rz[..., 1:ns + 1, 1:-1, 1:])
        fac = fac[:ns]
    else:
        px = (0, 0, 0, 0, 0, 1)
        pad = torch.nn.functional.pad
        tr = (pad(ry[..., 1:-1, :-1, 1:-1], px),
              pad(ry[..., 1:-1, 1:, 1:-1], px),
              pad(rz[..., 1:-1, 1:-1, :-1], px),
              pad(rz[..., 1:-1, 1:-1, 1:], px))
    rq = [first(_parity_pick(a, cy, cz, ny2, nz2))
          for a in (rx[..., :ns, 1:-1, 1:-1],) + tr]

    q = fac[..., cy, cz, :, :]
    facts = ([first(q[..., p, :, :]) for p in range(10)],
             [first(q[..., 10 + p, :, :]) for p in range(5)])
    Bent = {k: first(q[..., 15 + p, :, :])
            for p, k in enumerate(LINE_BKEYS)}
    delta = block_tridiag_solve_entries(5, facts, Bent, rq)
    dm = [_parity_embed(first(d), cy, cz, nyn, nzn) for d in delta]

    ex, ey, ez = ex.clone(), ey.clone(), ez.clone()
    # Station i's transverse edges lie on node i + 1; a whole line's
    # last station has none.
    t = slice(1, ns + 1) if seg else slice(1, -1)
    dt = [d if seg else d[..., :-1, :, :] for d in dm[1:]]
    ex[..., :ns, 1:-1, 1:-1] += dm[0]
    ey[..., t, :-1, 1:-1] += dt[0]
    ey[..., t, 1:, 1:-1] += dt[1]
    ez[..., t, 1:-1, :-1] += dt[2]
    ez[..., t, 1:-1, 1:] += dt[3]
    return ex, ey, ez


def line_color_sequence(nu):
    """Colours 0..3 on even sweeps and 3..0 on odd sweeps."""
    seq = []
    for it in range(nu):
        seq.extend(range(4) if it % 2 == 0 else range(3, -1, -1))
    return seq


def line_color_steps(e, s, par, fac, seq, sw=None):
    """x-line colour steps in the order of ``seq`` (new tensors); ``sw``
    as in :func:`color_steps`."""
    for color in seq:
        e = _line_color_update_x(e, s, par, fac, color, sw)
    return e


def _rot_fwd(a):
    """Cyclic axis rotation x→y→z→x of the last three tensor axes ((1,
    2, 0) of a 3-D tensor; leading lane axes stay)."""
    return a.movedim(-3, -1)


def _rot_bwd(a):
    return a.movedim(-1, -3)


def rotate_arrays(arrays, axis):
    """Model parameters in the frame whose x-lines are ``axis``-lines.

    Contiguous copies; η tensors shared in ``arrays`` stay shared.
    Reference parity: ``emg3d_tpu/ops/pallas_lr.py:908-925``.
    """
    if axis == 0:
        return tuple(arrays)
    eta_x, eta_y, eta_z, zeta, hx, hy, hz = arrays
    rot = _rot_fwd if axis == 1 else _rot_bwd
    done = {}

    def r(a):
        if id(a) not in done:
            done[id(a)] = rot(a).contiguous()
        return done[id(a)]

    if axis == 1:
        return (r(eta_y), r(eta_z), r(eta_x), r(zeta), hy, hz, hx)
    if axis == 2:
        return (r(eta_z), r(eta_x), r(eta_y), r(zeta), hz, hx, hy)
    raise ValueError(f"axis must be 0, 1, or 2; got {axis}.")


def rotate_shape(shape, axis):
    return tuple(shape[(axis + i) % 3] for i in range(3))


def rotate_fields(f, axis):
    """Edge fields (fx, fy, fz) in the rotated frame of ``axis`` (views)."""
    fx, fy, fz = f
    if axis == 0:
        return (fx, fy, fz)
    if axis == 1:
        # new-x = old-y: fields (fy, fz, fx).
        return (_rot_fwd(fy), _rot_fwd(fz), _rot_fwd(fx))
    if axis == 2:
        # new-x = old-z: fields (fz, fx, fy).
        return (_rot_bwd(fz), _rot_bwd(fx), _rot_bwd(fy))
    raise ValueError(f"axis must be 0, 1, or 2; got {axis}.")


def unrotate_fields(f, axis):
    """Inverse of :func:`rotate_fields` (views)."""
    if axis == 0:
        return tuple(f)
    if axis == 1:
        return (_rot_bwd(f[2]), _rot_bwd(f[0]), _rot_bwd(f[1]))
    if axis == 2:
        return (_rot_fwd(f[1]), _rot_fwd(f[2]), _rot_fwd(f[0]))
    raise ValueError(f"axis must be 0, 1, or 2; got {axis}.")


def line_relaxation(ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
                    hx, hy, hz, nu, axis):
    """nu sweeps of 4-colour line relaxation along ``axis`` (0=x,1=y,2=z).

    Returns new tensors.  The y/z variants run the x-line code in a
    cyclically rotated frame (exact: the Yee discretization is symmetric
    under x→y→z→x with simultaneous rotation of field components and
    model parameters).  The factor stack is built here, once per call,
    as the JAX package's XLA path does (smoothers.py:403-438).
    """
    par = rotate_arrays((eta_x, eta_y, eta_z, zeta, hx, hy, hz), axis)
    shape = rotate_shape(tuple(eta_x.shape), axis)
    e = tuple(t.contiguous() for t in rotate_fields((ex, ey, ez), axis))
    s = tuple(t.contiguous() for t in rotate_fields((sx, sy, sz), axis))
    out = line_color_steps(e, s, par, line_factor_stack(par, shape),
                           line_color_sequence(nu))
    return unrotate_fields(out, axis)
