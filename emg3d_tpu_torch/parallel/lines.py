"""Line relaxation on slabs: lines within a rank and lines across ranks.

Counterpart of the line half of ``emg3d_tpu/parallel/shmap.py``
(``line_relaxation_shmap``, ``_line_body``, ``_line_body_xsh``, :701-1166).
Every rank relaxes the lines of its slab (:class:`.halo.Slab`) with the
port's line kernels, in the rotated frame whose x-lines are the lines
(:mod:`..ops.line_gs`): K3 ``line_residual`` writes the colour's
residual, K4 ``line_thomas`` solves the lines, K5 ``line_factor`` builds
the factor stacks.  After each of the four colour steps the planes that
step changed go to the neighbours (:meth:`.halo.Slab.exchange`).  Three
cases, by the line axis:

- **Within a rank** (an unsharded axis, or an axis whose mesh dimension
  has one rank): the slab is a level of its own whose boundary planes
  are the ghosts, so K5 builds the slab's stack, K3 writes the colour's
  edges (``line_gs.colour_edges`` skips the slab boundary, which is the
  ghosts) and K4 solves every line whole.  A line colour is the parity
  of the rotated frame's two transverse axes, grid axes ``(a + 1) % 3``
  and ``(a + 2) % 3`` of a-lines; where the slab starts at an odd node
  along one of them, that bit flips (:func:`local_colour`).  At each
  rank boundary across the lines exactly one side's boundary node plane
  has the colour's parity, and only its lines change the shared cell
  plane's edges: that side sends its three planes, as for points.
- **Across ranks** (the line axis split over ranks, every rank keeping
  ``halo.MIN_LINE_PLANES`` node planes or more): the substructured
  (Schur-complement) solve of ``_line_body_xsh``.  Station i of a line
  is ex of cell i with the four transverse edges of node i + 1.  Rank t
  owns the stations whose transverse node it owns: nodes [a, b), so
  stations a − 1 .. b − 2, its slab's stations 0 .. L − 2 (the last
  rank's also L − 1, the line's PEC end); its first station is the
  interface u_t, the rest the interior, a segment that starts with no
  coupling below and (but on the last rank) ends in a full station
  coupled to the next rank's interface.  Once per line state: K5
  factors the interior (the ``stations`` segment of the level that
  starts at slab cell 1), the spikes Φ = T⁻¹E₀B₁ and Ψ = T⁻¹E_last
  B_nextᵀ are solved against that stack with torch ops (their first
  and last stations kept), and every rank of the line gathers the
  pieces of the reduced block-tridiagonal system over the P interface
  stations and LU-factors it, dense 5P × 5P per line.  Per colour step:
  K3 on the slab, K4 on the interior into a zero field (Y = T⁻¹r), one
  ``all_gather`` of the interface right-hand sides, the reduced solve,
  u_t added at the interface, the right-hand side's first and last
  interior stations corrected by B₁u_t and B_nextᵀu_{t+1}, and K4 on
  the interior again, adding x = T⁻¹(r − E₀B₁u_t − E_last B_nextᵀ
  u_{t+1}).  Exact: it differs from a sequential block-Thomas by
  rounding only.
- **Gathered** (the line axis split into shares below that): the JAX
  package leaves such levels to GSPMD.  The port gathers the level on
  every rank (:meth:`.halo.Slab.gather`), relaxes it whole with the
  kernels, and cuts the slab back; :data:`GATHERED` counts these calls
  per level and axis.

Where :func:`..ops._build.kernels` says no, the plain versions of
K3/K4/K5 run in every case; where it says yes, the kernels run or raise.
"""
from collections import namedtuple

import torch

from ..ops import line_gs, smoothers
from ..ops.blocksolve import block_tridiag_solve_entries
from ..ops.smoothers import LINE_BKEYS

__all__ = ['relax', 'schur_state', 'local_colour', 'GATHERED',
           'reset_gathered', 'SchurState']

# Smoothing calls that gathered a level, by (global cell shape, axis),
# since the last reset_gathered().
GATHERED = {}


def reset_gathered():
    GATHERED.clear()


SchurState = namedtuple('SchurState', [
    'slab',       # LineState of the rotated slab (K3; no stack)
    'sub',        # LineState of the level from slab cell 1 on (K4/K5)
    'fac',        # the interior's segment stack (stations, 23, 2, 2, ...)
    'stations',   # interior stations
    'last',       # this rank ends the line (its interior ends in PEC)
    'B1',         # (2, 2, ny2, nz2, 5, 5) the first interior station's B
    'Bn',         # the next interface's B (coupling to our last), or None
    'lu', 'piv',  # reduced system per line, LU factors (torch.linalg)
    'index',      # this rank's place along the line
])


def _transverse(axis):
    """Grid axes of the rotated frame's y and z (the colour's bits)."""
    return ((axis + 1) % 3, (axis + 2) % 3)


def local_colour(slab, axis, colour):
    """The slab's line colour of a global one: a transverse bit flips
    where the slab starts at an odd node along its grid axis."""
    bits = [colour % 2, colour // 2]
    for i, g in enumerate(_transverse(axis)):
        if g in slab.owned:
            bits[i] ^= slab.lo[g] & 1
    return bits[0] + 2 * bits[1]


def _parity(axis, colour):
    """{grid axis: parity of the nodes whose lines ``colour`` updates}:
    lines (j, k) with (j − 1) % 2 == cy and (k − 1) % 2 == cz."""
    return {g: ((colour >> i) & 1) ^ 1
            for i, g in enumerate(_transverse(axis))}


def relax(e, s, lev, axis, nu, local_state=None):
    """nu sweeps of 4-colour line relaxation along grid ``axis`` on the
    sharded level ``lev`` (its slab); updates ``e`` in place.

    ``local_state()`` gives the slab's line state with its K5 stack
    (the solver's cached one) for lines within a rank.  ``e`` and ``s``
    hold valid ghosts; ``e``'s are valid after.  The states of lines
    across ranks and of gathered levels are cached in ``lev.lstate``,
    their stacks under the solve's factor-byte meter (``lev.meter``, per
    rank) as the solver caches the others: a stack that would cross
    :func:`.ops.line_gs.cache_budget` is rebuilt at every call.
    """
    slab = lev.slab
    if not slab.split(axis):
        return _steps(e, s, slab, local_state(), nu)
    if not slab.line_supported(axis):
        return _gathered(e, s, lev, axis, nu)
    st = lev.lstate.get(('schur', axis))
    if st is None:
        st = schur_state(lev, axis)
        # The reduced systems stay (rebuilding them takes a collective
        # along the line); they count against the budget of the stacks.
        lev.meter['bytes'] += _nbytes(st.B1, st.Bn, st.lu, st.piv)
        keep = line_gs.keep_stack(lev.meter, _nbytes(st.fac),
                                  st.fac.device)
        lev.lstate[('schur', axis)] = st if keep else st._replace(fac=None)
    elif st.fac is None:
        st = st._replace(fac=line_gs.segment_stack(st.sub, st.stations))
    return _steps(e, s, slab, st.slab, nu, st)


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _steps(e, s, slab, state, nu, schur=None):
    """The colour steps in the rotated frame (:class:`.ops.line_gs.Sweep`),
    each followed by its messages (sent from the sweep's view of the
    rotated tensors in the slab's frame)."""
    a = state.axis
    sweep = line_gs.Sweep(e, s, state)
    for colour in smoothers.line_color_sequence(nu):
        lc = local_colour(slab, a, colour)
        sweep.residual(lc)
        if schur is None:
            sweep.solve(lc)
        else:
            _schur_step(sweep, schur, lc, slab)
        slab.exchange(sweep.view, _parity(a, colour),
                      line_axis=a if schur else None)
    return sweep.finish()


# ----------------------------------------------------------------------
# Lines across ranks
# ----------------------------------------------------------------------

def _entries(ar, rs, cells):
    """Packed station entries (len(cells), NLINE, 2, 2, ny2, nz2) of the
    rotated level made of the slab cells ``cells`` (an index list along
    the line)."""
    idx = torch.tensor(cells, device=ar[0].device)
    mini = tuple(t.index_select(0, idx) for t in ar[:4]) + \
        (ar[4].index_select(0, idx), ar[5], ar[6])
    return smoothers.pack_line_entries(mini, (len(cells),) + tuple(rs[1:]))


def _segment_solve(fac, rhs):
    """Block-Thomas solve of the segment stack ``fac`` with right-hand
    sides ``rhs`` (five (stations, 2, 2, ny2, nz2, K) tensors)."""
    def q(p):
        return fac[:, p, ..., None]
    facts = ([q(p) for p in range(10)], [q(10 + p) for p in range(5)])
    bent = {k: q(15 + p) for p, k in enumerate(LINE_BKEYS)}
    return block_tridiag_solve_entries(5, facts, bent, rhs)


def _spike(fac, station, block):
    """T⁻¹ E_station ``block``: the five column solves of the segment
    with ``block``'s columns at ``station``; returns the solution's
    first and last stations, (..., 5, 5) each (rows: unknowns)."""
    ns = fac.shape[0]
    shape = (ns,) + tuple(block.shape[:-2]) + (5,)
    rhs = []
    for a in range(5):
        t = torch.zeros(shape, dtype=block.dtype, device=block.device)
        t[station] = block[..., a, :]
        rhs.append(t)
    d = _segment_solve(fac, rhs)
    return (torch.stack([v[0] for v in d], -2),
            torch.stack([v[-1] for v in d], -2))


def schur_state(lev, axis):
    """The field-independent state of the Schur-complement smoother of
    ``axis``-lines on the sharded level ``lev`` (see the module
    docstring): the slab's line state, the interior's segment stack (K5
    with ``stations``), the coupling blocks and the factored reduced
    system (one ``all_gather`` along the line)."""
    slab = lev.slab
    full = line_gs.line_state(lev.arrays, lev.shape, axis, factors=False)
    ar, rs = full.arrays, full.shape
    L = rs[0]
    last = slab.nbr[axis][1] is None
    ns = L - 1 if last else L - 2
    sub_ar = tuple(t.narrow(0, 1, L - 1) for t in ar[:5]) + ar[5:]
    sub = line_gs.line_state(sub_ar, (L - 1,) + tuple(rs[1:]), 0,
                             factors=False)
    fac = line_gs.segment_stack(sub, ns)

    head = _entries(ar, rs, [0, 1, 2])
    D0 = smoothers.dense_station_blocks(head[0])[0]
    B1 = smoothers.dense_station_blocks(head[1])[1]
    phi0, phil = _spike(fac, 0, B1)
    Dpart = D0 - B1.transpose(-1, -2) @ phi0
    if last:
        Bn = None
        Pp = Ps = torch.zeros_like(Dpart)
    else:
        # The next interface's B: node L − 1's x-row and node L's
        # coupling through cell L − 1 (a repeated cell L − 1 stands in
        # for the cell beyond the slab; no entry read depends on it).
        Bn = smoothers.dense_station_blocks(
            _entries(ar, rs, [L - 2, L - 1, L - 1])[1])[1]
        _, psil = _spike(fac, ns - 1, Bn.transpose(-1, -2))
        Pp = Bn @ psil
        Ps = -(Bn @ phil)
    parts = slab.line_gather(torch.stack([Dpart, Pp, Ps]), axis)
    P = len(parts)
    M = torch.zeros(Dpart.shape[:-2] + (5 * P, 5 * P), dtype=Dpart.dtype,
                    device=Dpart.device)
    for t in range(P):
        blk = slice(5 * t, 5 * t + 5)
        M[..., blk, blk] = parts[t][0]
        if t:
            prev = slice(5 * t - 5, 5 * t)
            M[..., blk, blk] -= parts[t - 1][1]
            M[..., blk, prev] = parts[t - 1][2]
            M[..., prev, blk] = parts[t - 1][2].transpose(-1, -2)
    lu, piv = torch.linalg.lu_factor(M)
    return SchurState(full, sub, fac, ns, last, B1, Bn, lu, piv,
                      slab.coord[axis])


def _station(f, i, cy, cz, cny, cnz):
    """Views of station ``i``'s five edges of the colour's lines (cny ×
    cnz) of rotated edge fields ``f``: ex(i, j, k), ey(i + 1, j − 1|j,
    k), ez(i + 1, j, k − 1|k)."""
    jl = slice(1 + cy, 1 + cy + 2 * cny, 2)
    kl = slice(1 + cz, 1 + cz + 2 * cnz, 2)
    return (f[0][i, jl, kl],
            f[1][i + 1, cy:cy + 2 * cny:2, kl], f[1][i + 1, jl, kl],
            f[2][i + 1, jl, cz:cz + 2 * cnz:2], f[2][i + 1, jl, kl])


def _get(f, i, c):
    return torch.stack(_station(f, i, *c), -1)


def _add(f, i, c, v):
    for m, view in enumerate(_station(f, i, *c)):
        view.add_(v[..., m])


def _matvec(B, v):
    return (B @ v[..., None])[..., 0]


def _schur_step(sweep, st, lc, slab):
    """One colour step of the Schur-complement smoother in the rotated
    frame of ``sweep``, whose ``r`` holds K3's residual of the colour on
    the slab."""
    er, r, kern = sweep.er, sweep.r, sweep.kern
    cy, cz = lc % 2, lc // 2
    _, ny, nz = st.slab.shape
    c = (cy, cz, (ny - cy) // 2, (nz - cz) // 2)
    if c[2] * c[3] == 0:
        return
    L, ns = st.slab.shape[0], st.stations

    def sub(f):
        return (f[0].narrow(0, 1, L - 1), f[1].narrow(0, 1, L),
                f[2].narrow(0, 1, L))

    def thomas(e_, r_):
        if kern:
            line_gs.thomas(e_, r_, st.fac, st.sub, lc, stations=ns)
        else:
            line_gs.thomas_plain(e_, r_, st.fac, lc, stations=ns)

    rs = sub(r)
    quarter = (cy, cz, slice(0, c[2]), slice(0, c[3]))
    B1 = st.B1[quarter]
    # Y = T⁻¹ r on the interior: its first and last stations.
    y = tuple(torch.zeros_like(t) for t in sub(er))
    thomas(y, rs)
    g = _get(r, 0, c) - _matvec(B1.transpose(-1, -2), _get(y, 0, c))
    q = torch.zeros_like(g) if st.last else \
        _matvec(st.Bn[quarter], _get(y, ns - 1, c))
    parts = slab.line_gather(torch.cat([g, q], -1), st.slab.axis)
    rhs = torch.cat([p[..., :5] - (parts[t - 1][..., 5:] if t else 0)
                     for t, p in enumerate(parts)], -1)
    u = torch.linalg.lu_solve(st.lu[quarter], st.piv[quarter],
                              rhs[..., None])[..., 0]
    t = st.index
    ut = u[..., 5 * t:5 * t + 5]
    _add(er, 0, c, ut)
    _add(rs, 0, c, -_matvec(B1, ut))
    if not st.last:
        un = u[..., 5 * t + 5:5 * t + 10]
        _add(rs, ns - 1, c, -_matvec(st.Bn[quarter].transpose(-1, -2), un))
    thomas(sub(er), rs)


# ----------------------------------------------------------------------
# Gathered levels
# ----------------------------------------------------------------------

def _gathered(e, s, lev, axis, nu):
    """The whole level's line relaxation on every rank, the slab cut
    back (lines along an axis split into shares too short for the
    Schur smoother)."""
    slab = lev.slab
    key = (slab.shape, axis)
    GATHERED[key] = GATHERED.get(key, 0) + 1
    st = lev.lstate.get(('whole', axis))
    if st is None:
        whole = tuple(t.to(e[0].device) for t in slab.whole)
        keep = line_gs.keep_stack(lev.meter, line_gs.factor_bytes(
            slab.shape, axis, whole[0].dtype), e[0].device)
        st = lev.lstate[('whole', axis)] = line_gs.line_state(
            whole, slab.shape, axis, factors=keep)
    ew, sw = slab.gather(e), slab.gather(s)
    line_gs.line_relaxation(ew, sw, st, nu)
    for dst, src in zip(e, slab.cut_field(ew)):
        dst.copy_(src)
    return e
