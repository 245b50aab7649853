"""The matrix-free curl-curl + iωμσ̃ operator as torch ops.

Counterpart of ``emg3d_tpu/ops/stencil.py``: the operator

    A e = V (iωμ0 σ̃ e − ∇ × μr⁻¹ ∇ × e)          [Muld06 Eq. 2]

evaluated matrix-free on the staggered Yee grid, with PEC rows zeroed,
as whole-tensor first-curl (faces), ζ face-weighting, second-curl
(edges) and η edge-averaging.  Complex tensors are native (complex128,
or complex64 in a complex64 solve), not split re/im pairs.  Every function also takes a
leading lane axis on the fields (and on η), the lanes of a batched
solve: the grid axes are the last three.

Tensor layout (C-order, indexed [ix, iy, iz]):
  ex (nx, ny+1, nz+1), ey (nx+1, ny, nz+1), ez (nx+1, ny+1, nz)
  eta_x/eta_y/eta_z/zeta (nx, ny, nz);  hx (nx,), hy (ny,), hz (nz,)
"""
import torch

__all__ = ['curl_factors', 'amat', 'residual_parts', 'residual_sw',
           'pec_mask_apply', 'zeta_face_weights', 'eta_edge_sums']


def _adjpair(a, axis):
    """Adjacent-pair sum along ``axis`` (length n -> n-1)."""
    n = a.shape[axis]
    return a.narrow(axis, 0, n - 1) + a.narrow(axis, 1, n - 1)


def _edgepad_pair(a, axis):
    """Edge-replicate-pad by one on both ends, then adjacent-pair sum.

    Result has length n+1 along ``axis``: entry i = a[clip(i-1)] +
    a[clip(i)], matching the reference's clamped ixm/iym/izm indexing.
    """
    n = a.shape[axis]
    p = torch.cat([a.narrow(axis, 0, 1), a, a.narrow(axis, n - 1, 1)],
                  dim=axis)
    return _adjpair(p, axis)


def zeta_face_weights(zeta):
    """ζ-sums of the two cells adjacent to each face, per direction.

    Returns (wx, wy, wz):
      wx (nx+1, ny, nz) : weights on x-faces (for the curl x-component)
      wy (nx, ny+1, nz) : weights on y-faces
      wz (nx, ny, nz+1) : weights on z-faces
    Boundary faces use the clamped (doubled) single-cell value.
    """
    return (_edgepad_pair(zeta, -3), _edgepad_pair(zeta, -2),
            _edgepad_pair(zeta, -1))


def eta_edge_sums(eta_x, eta_y, eta_z):
    """4-cell η sums at interior edges (NOT divided by 4).

    Returns (stx, sty, stz):
      stx (nx, ny-1, nz-1) for x-edges at interior (iy, iz),
      sty (nx-1, ny, nz-1), stz (nx-1, ny-1, nz).
    """
    stx = _adjpair(_adjpair(eta_x, -2), -1)
    sty = _adjpair(_adjpair(eta_y, -3), -1)
    stz = _adjpair(_adjpair(eta_z, -3), -2)
    return stx, sty, stz


def _inverse_widths(hx, hy, hz):
    return _bcast_widths(1.0 / hx, 1.0 / hy, 1.0 / hz)


def _bcast_widths(ihx, ihy, ihz):
    return ihx[:, None, None], ihy[None, :, None], ihz[None, None, :]


def _curls(ex, ey, ez, w, ih):
    """ζ-weighted curls on faces from the face weights ``w`` and the
    broadcast inverse widths ``ih``."""
    ihx, ihy, ihz = ih
    v1 = torch.diff(ez, dim=-2) * ihy - torch.diff(ey, dim=-1) * ihz
    v2 = torch.diff(ex, dim=-1) * ihz - torch.diff(ez, dim=-3) * ihx
    v3 = torch.diff(ey, dim=-3) * ihx - torch.diff(ex, dim=-2) * ihy

    wx, wy, wz = w
    return v1 * wx, v2 * wy, v3 * wz


def curl_factors(ex, ey, ez, zeta, hx, hy, hz):
    """ζ-weighted curl on cell faces: u = (ζ_left + ζ_right) · (∇×E).

    Returns (u1, u2, u3) with shapes
      u1 (nx+1, ny, nz), u2 (nx, ny+1, nz), u3 (nx, ny, nz+1).

    (The conventional factor ½ of the ζ-average is applied later, in
    :func:`amat`, as in the reference.)
    """
    return _curls(ex, ey, ez, zeta_face_weights(zeta),
                  _inverse_widths(hx, hy, hz))


def _amat_parts(ex, ey, ez, st, w, ih):
    """Interior rows of A e from the η edge sums, face weights and
    broadcast inverse widths."""
    ihx, ihy, ihz = ih

    u1, u2, u3 = _curls(ex, ey, ez, w, ih)

    # Second curl, interior edges only.
    rrx = (torch.diff(u3[..., 1:-1] * ihy, dim=-2)
           - torch.diff(u2[..., 1:-1, :] * ihz, dim=-1))
    rry = (torch.diff(u1[..., 1:-1, :, :] * ihz, dim=-1)
           - torch.diff(u3[..., 1:-1] * ihx, dim=-3))
    rrz = (torch.diff(u2[..., 1:-1, :] * ihx, dim=-3)
           - torch.diff(u1[..., 1:-1, :, :] * ihy, dim=-2))

    # η-terms (4-cell averages; /4 folded into the 0.25 factor).
    stx, sty, stz = st

    ax = 0.5 * rrx - 0.25 * stx * ex[..., 1:-1, 1:-1]
    ay = 0.5 * rry - 0.25 * sty * ey[..., 1:-1, :, 1:-1]
    az = 0.5 * rrz - 0.25 * stz * ez[..., 1:-1, 1:-1, :]
    return ax, ay, az


def amat_interior(ex, ey, ez, eta_x, eta_y, eta_z, zeta, hx, hy, hz):
    """Interior (non-PEC) rows of A e, unpadded.

    Shapes: ax (nx, ny-1, nz-1), ay (nx-1, ny, nz-1),
    az (nx-1, ny-1, nz).
    """
    return _amat_parts(ex, ey, ez, eta_edge_sums(eta_x, eta_y, eta_z),
                       zeta_face_weights(zeta), _inverse_widths(hx, hy, hz))


def _pad_rows(ax, ay, az):
    pad = torch.nn.functional.pad
    # F.pad lists the last dimension first: (z_lo, z_hi, y_lo, y_hi, ...).
    return (pad(ax, (1, 1, 1, 1, 0, 0)), pad(ay, (1, 1, 0, 0, 1, 1)),
            pad(az, (0, 0, 1, 1, 1, 1)))


def amat(ex, ey, ez, eta_x, eta_y, eta_z, zeta, hx, hy, hz):
    """Apply the operator: returns (A e)_x, (A e)_y, (A e)_z.

    PEC rows (tangential boundary edges) are zero.
    """
    return _pad_rows(*amat_interior(ex, ey, ez, eta_x, eta_y, eta_z, zeta,
                                    hx, hy, hz))


def residual_sw(sx, sy, sz, ex, ey, ez, st, w, ih):
    """Residual r = s − A e from the η edge sums ``st``, ζ face weights
    ``w`` and inverse widths ``ih`` (1-D) of a level, as the smoother
    kernels read them: :func:`residual_parts` on given parameters (the
    plain versions of a bfloat16-stored solve pass them rounded)."""
    ax, ay, az = _pad_rows(*_amat_parts(ex, ey, ez, st, w,
                                        _bcast_widths(*ih)))
    return sx - ax, sy - ay, sz - az


def residual_parts(sx, sy, sz, ex, ey, ez, eta_x, eta_y, eta_z, zeta,
                   hx, hy, hz):
    """Residual r = s − A e (component tensors)."""
    ax, ay, az = amat(ex, ey, ez, eta_x, eta_y, eta_z, zeta, hx, hy, hz)
    return sx - ax, sy - ay, sz - az


def pec_mask_apply(fx, fy, fz):
    """Zero tangential boundary edges (PEC), in place; returns the tensors.

    The JAX counterpart returns new arrays; every caller here owns the
    tensors it masks, so the port writes into them.
    """
    for f, axes in ((fx, (-2, -1)), (fy, (-3, -1)), (fz, (-3, -2))):
        for ax in axes:
            f.select(ax, 0).zero_()
            f.select(ax, -1).zero_()
    return fx, fy, fz
