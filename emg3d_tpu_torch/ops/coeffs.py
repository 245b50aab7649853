"""Vectorized smoother coefficients: the node-block entries of A.

Counterpart of ``emg3d_tpu/ops/coeffs.py``.  The reference assembles,
per node and per sweep, 24 ζ-average ("m"-)coefficients and 6 η-sums
(emg3d/core.py:321-401).  Here they are whole-tensor slices, computed
once per level (the point smoother's factor stack) or once per colour
step (its plain fused version).  The functions take torch tensors.

Notation: for interior nodes (ix∈1..nx-1, iy∈1..ny-1, iz∈1..nz-1) the
eight surrounding cells are indexed by (a, b, c) ∈ {m, p}³ with
m = node_index-1, p = node_index.  All returned arrays have node shape
(nx-1, ny-1, nz-1).

Edge ordering of the 6-edge node block:
  0: ex(ix-1)  1: ex(ix)  2: ey(iy-1)  3: ey(iy)  4: ez(iz-1)  5: ez(iz)
"""
from collections import namedtuple

__all__ = ['node_coefficients', 'face_coefficients', 'NodeCoeffs']

_FIELDS = [
    # 24 zeta-average coefficients (k_t * (zeta + zeta)), real.
    'mzyLxm', 'mzyRxm', 'myzLxm', 'myzRxm',
    'mzyLxp', 'mzyRxp', 'myzLxp', 'myzRxp',
    'mzxLym', 'mzxRym', 'mxzLym', 'mxzRym',
    'mzxLyp', 'mzxRyp', 'mxzLyp', 'mxzRyp',
    'myxLzm', 'myxRzm', 'mxyLzm', 'mxyRzm',
    'myxLzp', 'myxRzp', 'mxyLzp', 'mxyRzp',
    # 6 eta sums (complex), NOT divided by 4.
    'st0', 'st1', 'st2', 'st3', 'st4', 'st5',
    # Inverse cell widths at the node (left/right per axis), 1-D bcast.
    'ihxm', 'ihxp', 'ihym', 'ihyp', 'ihzm', 'ihzp',
]

NodeCoeffs = namedtuple('NodeCoeffs', _FIELDS)


def _pair(a, axis):
    lo = [slice(None)] * a.ndim
    hi = [slice(None)] * a.ndim
    lo[axis] = slice(None, -1)
    hi[axis] = slice(1, None)
    return a[tuple(lo)] + a[tuple(hi)]


def node_coefficients(eta_x, eta_y, eta_z, zeta, hx, hy, hz):
    """Compute all node-block coefficients (see module docstring).

    Reference parity: the m/st terms of core.py:321-361 for every
    interior node at once.
    """
    m, p = slice(None, -1), slice(1, None)
    # The eight corner views of ζ, each sliced once (48 uses below).
    corners = {}

    def Z(a, b, c):
        key = (a is p, b is p, c is p)
        if key not in corners:
            corners[key] = zeta[a, b, c]
        return corners[key]

    kx = (0.5 / hx)
    ky = (0.5 / hy)
    kz = (0.5 / hz)
    # Broadcast to node arrays: x -> axis0 (nx-1), y -> axis1, z -> axis2.
    kxm = kx[:-1][:, None, None]
    kxp = kx[1:][:, None, None]
    kym = ky[:-1][None, :, None]
    kyp = ky[1:][None, :, None]
    kzm = kz[:-1][None, None, :]
    kzp = kz[1:][None, None, :]

    c = dict(
        mzyLxm=kym * (Z(m, m, p) + Z(m, m, m)),
        mzyRxm=kyp * (Z(m, p, p) + Z(m, p, m)),
        myzLxm=kzm * (Z(m, p, m) + Z(m, m, m)),
        myzRxm=kzp * (Z(m, p, p) + Z(m, m, p)),
        mzyLxp=kym * (Z(p, m, p) + Z(p, m, m)),
        mzyRxp=kyp * (Z(p, p, p) + Z(p, p, m)),
        myzLxp=kzm * (Z(p, p, m) + Z(p, m, m)),
        myzRxp=kzp * (Z(p, p, p) + Z(p, m, p)),
        mzxLym=kxm * (Z(m, m, p) + Z(m, m, m)),
        mzxRym=kxp * (Z(p, m, p) + Z(p, m, m)),
        mxzLym=kzm * (Z(p, m, m) + Z(m, m, m)),
        mxzRym=kzp * (Z(p, m, p) + Z(m, m, p)),
        mzxLyp=kxm * (Z(m, p, p) + Z(m, p, m)),
        mzxRyp=kxp * (Z(p, p, p) + Z(p, p, m)),
        mxzLyp=kzm * (Z(p, p, m) + Z(m, p, m)),
        mxzRyp=kzp * (Z(p, p, p) + Z(m, p, p)),
        myxLzm=kxm * (Z(m, p, m) + Z(m, m, m)),
        myxRzm=kxp * (Z(p, p, m) + Z(p, m, m)),
        mxyLzm=kym * (Z(p, m, m) + Z(m, m, m)),
        mxyRzm=kyp * (Z(p, p, m) + Z(m, p, m)),
        myxLzp=kxm * (Z(m, p, p) + Z(m, m, p)),
        myxRzp=kxp * (Z(p, p, p) + Z(p, m, p)),
        mxyLzp=kym * (Z(p, m, p) + Z(m, m, p)),
        mxyRzp=kyp * (Z(p, p, p) + Z(m, p, p)),
    )

    # Eta 4-cell sums at the six block edges.
    stx = _pair(_pair(eta_x, 1), 2)   # (nx, ny-1, nz-1)
    sty = _pair(_pair(eta_y, 0), 2)   # (nx-1, ny, nz-1)
    stz = _pair(_pair(eta_z, 0), 1)   # (nx-1, ny-1, nz)
    c.update(
        st0=stx[:-1], st1=stx[1:],
        st2=sty[:, :-1], st3=sty[:, 1:],
        st4=stz[:, :, :-1], st5=stz[:, :, 1:],
    )

    ihx = 1.0 / hx
    ihy = 1.0 / hy
    ihz = 1.0 / hz
    c.update(
        ihxm=ihx[:-1][:, None, None], ihxp=ihx[1:][:, None, None],
        ihym=ihy[:-1][None, :, None], ihyp=ihy[1:][None, :, None],
        ihzm=ihz[:-1][None, None, :], ihzp=ihz[1:][None, None, :],
    )
    return NodeCoeffs(**c)


def face_coefficients(st, w, ih):
    """The same coefficients from the level's η edge sums ``st``, ζ face
    weights ``w`` (:func:`.stencil.eta_edge_sums`,
    :func:`.stencil.zeta_face_weights`) and inverse widths ``ih``.

    The face-weight form that the CUDA kernels K2 and K5 compute
    (csrc/node_block.cuh): each ζ pair sum is the face weight between
    the two cells, each k = ½·ih.  Equal to :func:`node_coefficients`
    (a ζ sum is the same either way round; ½/h = ½·(1/h) exactly).
    """
    stx, sty, stz = st
    wx, wy, wz = w
    ihx, ihy, ihz = ih
    kx, ky, kz = 0.5 * ihx, 0.5 * ihy, 0.5 * ihz
    kxm = kx[:-1][:, None, None]
    kxp = kx[1:][:, None, None]
    kym = ky[:-1][None, :, None]
    kyp = ky[1:][None, :, None]
    kzm = kz[:-1][None, None, :]
    kzp = kz[1:][None, None, :]
    # Faces around the node (i0, j0, k0) = (ix-1, iy-1, iz-1).
    zmm, zmp = wz[:-1, :-1, 1:-1], wz[:-1, 1:, 1:-1]
    zpm, zpp = wz[1:, :-1, 1:-1], wz[1:, 1:, 1:-1]
    ymm, ymp = wy[:-1, 1:-1, :-1], wy[:-1, 1:-1, 1:]
    ypm, ypp = wy[1:, 1:-1, :-1], wy[1:, 1:-1, 1:]
    xmm, xmp = wx[1:-1, :-1, :-1], wx[1:-1, :-1, 1:]
    xpm, xpp = wx[1:-1, 1:, :-1], wx[1:-1, 1:, 1:]
    return NodeCoeffs(
        mzyLxm=kym * zmm, mzyRxm=kyp * zmp,
        myzLxm=kzm * ymm, myzRxm=kzp * ymp,
        mzyLxp=kym * zpm, mzyRxp=kyp * zpp,
        myzLxp=kzm * ypm, myzRxp=kzp * ypp,
        mzxLym=kxm * zmm, mzxRym=kxp * zpm,
        mxzLym=kzm * xmm, mxzRym=kzp * xmp,
        mzxLyp=kxm * zmp, mzxRyp=kxp * zpp,
        mxzLyp=kzm * xpm, mxzRyp=kzp * xpp,
        myxLzm=kxm * ymm, myxRzm=kxp * ypm,
        mxyLzm=kym * xmm, mxyRzm=kyp * xpm,
        myxLzp=kxm * ymp, myxRzp=kxp * ypp,
        mxyLzp=kym * xmp, mxyRzp=kyp * xpp,
        st0=stx[:-1], st1=stx[1:],
        st2=sty[:, :-1], st3=sty[:, 1:],
        st4=stz[:, :, :-1], st5=stz[:, :, 1:],
        ihxm=ihx[:-1][:, None, None], ihxp=ihx[1:][:, None, None],
        ihym=ihy[:-1][None, :, None], ihyp=ihy[1:][None, :, None],
        ihzm=ihz[:-1][None, None, :], ihzp=ihz[1:][None, None, :],
    )


def node_block_entries(c):
    """The sparse lower triangle of the 6×6 node blocks of A.

    Returns dict[(i, j)] -> array (node-shaped), suitable for
    :func:`emg3d_tpu.ops.blocksolve.ldl_solve_sparse`.

    Reference parity: core.py:363-401 (amat fill).
    """
    e = {
        (0, 0): (c.mzyRxm * c.ihyp + c.mzyLxm * c.ihym +
                 c.myzRxm * c.ihzp + c.myzLxm * c.ihzm - 0.25 * c.st0),
        (1, 1): (c.mzyRxp * c.ihyp + c.mzyLxp * c.ihym +
                 c.myzRxp * c.ihzp + c.myzLxp * c.ihzm - 0.25 * c.st1),
        (2, 2): (c.mzxRym * c.ihxp + c.mzxLym * c.ihxm +
                 c.mxzRym * c.ihzp + c.mxzLym * c.ihzm - 0.25 * c.st2),
        (3, 3): (c.mzxRyp * c.ihxp + c.mzxLyp * c.ihxm +
                 c.mxzRyp * c.ihzp + c.mxzLyp * c.ihzm - 0.25 * c.st3),
        (4, 4): (c.myxRzm * c.ihxp + c.myxLzm * c.ihxm +
                 c.mxyRzm * c.ihyp + c.mxyLzm * c.ihym - 0.25 * c.st4),
        (5, 5): (c.myxRzp * c.ihxp + c.myxLzp * c.ihxm +
                 c.mxyRzp * c.ihyp + c.mxyLzp * c.ihym - 0.25 * c.st5),
        (2, 0): -c.mzyLxm * c.ihxm,
        (3, 0): c.mzyRxm * c.ihxm,
        (4, 0): -c.myzLxm * c.ihxm,
        (5, 0): c.myzRxm * c.ihxm,
        (2, 1): c.mzyLxp * c.ihxp,
        (3, 1): -c.mzyRxp * c.ihxp,
        (4, 1): c.myzLxp * c.ihxp,
        (5, 1): -c.myzRxp * c.ihxp,
        (4, 2): -c.mxzLym * c.ihym,
        (5, 2): c.mxzRym * c.ihym,
        (4, 3): c.mxzLyp * c.ihyp,
        (5, 3): -c.mxzRyp * c.ihyp,
        # (1,0), (3,2), (5,4) are structurally zero.
    }
    return e
