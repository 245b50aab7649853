"""The discrete system of the solve: emg3d's finite-volume curl-curl
operator on a staggered (Yee) tensor grid, with perfectly conducting
outer walls (Mulder 2006, Geophysics 71(6), G285; the emg3d manual).

A cell grid of widths ``h = (hx, hy, hz)``.  Edges carry the electric
field: ex has shape (nx, ny + 1, nz + 1), ey (nx + 1, ny, nz + 1), ez
(nx + 1, ny + 1, nz).  With s = −2πif and the cell volumes V,

    η = s μ0 V σ   (per axis, σ = 1/ρ),   ζ = V / μr   (μr = 1 here),

and the residual of an interior edge, e.g. an x-edge between the cells
(j−1, j) in y and (k−1, k) in z,

    r = s_src − ( ½ [curl of u]_x − ¼ (η₁ + η₂ + η₃ + η₄) e_x ),

where u = (ζ_a + ζ_b) · (∇ × e) lives on the cell faces (ζ_a, ζ_b the
two cells beside the face; a wall face takes its one cell twice) and
the outer curl divides each face's u by the width of its own cell.
Rows of edges on the walls are no unknowns: their residual is the
source there (zero for a source inside the grid).  The source vector is
s μ0 times the dipole's moment distributed onto the edges: its segment
is cut at every node plane, and each piece's length fraction goes to
the four edges of its component around the piece's midpoint with
bilinear weights.
"""
import numpy as np
import torch
from scipy.constants import mu_0

__all__ = ['smu0', 'eta_zeta', 'source_field', 'residual_norms',
           'relative_residuals']


def smu0(frequency):
    """s μ0 of a frequency in Hz (s = −2πif)."""
    return -2j * np.pi * float(frequency) * mu_0


def _volumes(h):
    hx, hy, hz = (np.asarray(a, dtype=np.float64) for a in h)
    return hx[:, None, None] * hy[None, :, None] * hz[None, None, :]


def eta_zeta(h, resistivity, frequency):
    """(η_x, η_y, η_z) complex128 and ζ float64 of a model.

    ``resistivity`` is (ρx, ρy, ρz), each a scalar or an array of the
    cell shape, in Ω·m.
    """
    vol = _volumes(h)
    eta = tuple(smu0(frequency) * vol / np.broadcast_to(
        np.asarray(rho, dtype=np.float64), vol.shape) for rho in resistivity)
    return eta, vol.copy()


def _dipole_ends(src, length=1.0):
    """The two ends of a source: a finite dipole (x0, x1, y0, y1, z0,
    z1) as given, or a point dipole (x, y, z, azimuth, dip) in degrees
    as a dipole of ``length`` metres centred on the point."""
    src = np.asarray(src, dtype=np.float64)
    if src.shape == (6,):
        return src[::2].copy(), src[1::2].copy()
    az, dip = np.deg2rad(src[3]), np.deg2rad(src[4])
    u = np.array([np.cos(az) * np.cos(dip), np.sin(az) * np.cos(dip),
                  np.sin(dip)])
    # Exact zeros for axis-aligned dipoles (cos 90° is not 0 in floats).
    u[np.abs(u) < 1e-15] = 0.0
    return src[:3] - u * length / 2, src[:3] + u * length / 2


def source_field(nodes, src, frequency, decimals=6):
    """The source vector (sx, sy, sz), complex128, of a unit-moment
    electric dipole ``src`` (see :func:`_dipole_ends`) on the grid of
    node coordinates ``nodes`` = (x, y, z).  The moment is the unit vector of the
    dipole; the node and end coordinates are rounded to ``decimals``
    before the segment is distributed, as emg3d does."""
    nodes = [np.round(np.asarray(n, dtype=np.float64), decimals)
             for n in nodes]
    ends = _dipole_ends(src)
    moment = (ends[1] - ends[0]) / np.linalg.norm(ends[1] - ends[0])
    p0, p1 = (np.round(p, decimals) for p in ends)
    d = p1 - p0
    # Cut the segment at every node plane it crosses.
    cuts = [0.0, 1.0]
    for ax in range(3):
        if d[ax] != 0:
            t = (nodes[ax] - p0[ax]) / d[ax]
            cuts.extend(t[(t > 0) & (t < 1)])
    t = np.unique(cuts)
    frac = np.diff(t)
    mids = p0[None, :] + ((t[:-1] + t[1:]) / 2)[:, None] * d[None, :]
    n = [len(a) - 1 for a in nodes]
    shapes = ((n[0], n[1] + 1, n[2] + 1), (n[0] + 1, n[1], n[2] + 1),
              (n[0] + 1, n[1] + 1, n[2]))
    out = [np.zeros(sh, dtype=np.complex128) for sh in shapes]
    for mid, w in zip(mids, frac):
        cell, off = [], []
        for ax in range(3):
            i = int(np.searchsorted(nodes[ax], mid[ax], side='right')) - 1
            i = min(max(i, 0), n[ax] - 1)
            cell.append(i)
            off.append((mid[ax] - nodes[ax][i])
                       / (nodes[ax][i + 1] - nodes[ax][i]))
        for comp in range(3):
            if moment[comp] == 0:
                continue
            # The component's edges around the cell: its own axis takes
            # the cell index, the two others the cell's two nodes.
            a, b = [ax for ax in range(3) if ax != comp]
            for da, wa in ((0, 1 - off[a]), (1, off[a])):
                for db, wb in ((0, 1 - off[b]), (1, off[b])):
                    idx = list(cell)
                    idx[a] += da
                    idx[b] += db
                    out[comp][tuple(idx)] += wa * wb * w * moment[comp]
    s = smu0(frequency)
    return tuple(o * s for o in out)


def _face_weights(zeta):
    """ζ_a + ζ_b on the x-, y- and z-faces; a wall face counts its one
    cell twice."""
    out = []
    for ax in range(3):
        pad = torch.cat([zeta.narrow(ax, 0, 1), zeta,
                         zeta.narrow(ax, zeta.shape[ax] - 1, 1)], dim=ax)
        n = pad.shape[ax]
        out.append(pad.narrow(ax, 0, n - 1) + pad.narrow(ax, 1, n - 1))
    return out


def _operator(e, eta, zeta, h):
    """A e at the interior edges of one field (3-D components):
    ax (nx, ny−1, nz−1), ay (nx−1, ny, nz−1), az (nx−1, ny−1, nz)."""
    ex, ey, ez = e
    hx, hy, hz = h
    ihx, ihy, ihz = (1 / hx)[:, None, None], (1 / hy)[None, :, None], \
        (1 / hz)[None, None, :]
    wx, wy, wz = _face_weights(zeta)
    # ∇ × e on the faces, weighted.
    ux = wx * ((ez[:, 1:, :] - ez[:, :-1, :]) * ihy
               - (ey[:, :, 1:] - ey[:, :, :-1]) * ihz)
    uy = wy * ((ex[:, :, 1:] - ex[:, :, :-1]) * ihz
               - (ez[1:, :, :] - ez[:-1, :, :]) * ihx)
    uz = wz * ((ey[1:, :, :] - ey[:-1, :, :]) * ihx
               - (ex[:, 1:, :] - ex[:, :-1, :]) * ihy)
    # ∇ × u at the interior edges, each face's u over its cell's width.
    vz = uz[:, :, 1:-1] * ihy
    vy = uy[:, 1:-1, :] * ihz
    cx = (vz[:, 1:, :] - vz[:, :-1, :]) - (vy[:, :, 1:] - vy[:, :, :-1])
    vx = ux[1:-1, :, :] * ihz
    vz = uz[:, :, 1:-1] * ihx
    cy = (vx[:, :, 1:] - vx[:, :, :-1]) - (vz[1:, :, :] - vz[:-1, :, :])
    vy = uy[:, 1:-1, :] * ihx
    vx = ux[1:-1, :, :] * ihy
    cz = (vy[1:, :, :] - vy[:-1, :, :]) - (vx[:, 1:, :] - vx[:, :-1, :])

    def four(a, d1, d2):
        n1, n2 = a.shape[d1], a.shape[d2]
        b = a.narrow(d1, 0, n1 - 1) + a.narrow(d1, 1, n1 - 1)
        return b.narrow(d2, 0, n2 - 1) + b.narrow(d2, 1, n2 - 1)

    return (0.5 * cx - 0.25 * four(eta[0], 1, 2) * ex[:, 1:-1, 1:-1],
            0.5 * cy - 0.25 * four(eta[1], 0, 2) * ey[1:-1, :, 1:-1],
            0.5 * cz - 0.25 * four(eta[2], 0, 1) * ez[1:-1, 1:-1, :])


def residual_norms(e, s, eta, zeta, h, device='cpu'):
    """(‖s − A e‖, ‖s‖) of one field, each the 2-norm over every edge,
    in complex128 on ``device``.  ``e`` and ``s`` are component triples
    (arrays or tensors), ``eta`` a triple and ``zeta`` an array of the
    cell shape, ``h`` the widths."""
    def t(a, dtype=torch.complex128):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                               else a).to(device=device, dtype=dtype)
    e = tuple(t(c) for c in e)
    s = tuple(t(c) for c in s)
    eta = tuple(t(c) for c in eta)
    zeta = t(zeta, torch.float64)
    h = tuple(t(c, torch.float64) for c in h)
    ae = _operator(e, eta, zeta, h)
    sq = 0.0
    for comp, (sc, ac) in enumerate(zip(s, ae)):
        r = sc.clone()
        inner = [slice(1, -1)] * 3
        inner[comp] = slice(None)
        r[tuple(inner)] -= ac
        sq += float((r.real ** 2 + r.imag ** 2).sum())
    ss = sum(float((c.real ** 2 + c.imag ** 2).sum()) for c in s)
    return float(np.sqrt(sq)), float(np.sqrt(ss))


def relative_residuals(fields, sources, eta, zeta, h, device='cpu'):
    """‖s − A e‖ / ‖s‖ of each (field, source) pair; ``eta`` is one
    triple for all pairs or a list of triples, one per pair."""
    out = []
    for i, (e, s) in enumerate(zip(fields, sources)):
        et = eta[i] if isinstance(eta, list) else eta
        r, ref = residual_norms(e, s, et, zeta, h, device)
        out.append(r / ref)
    return out
