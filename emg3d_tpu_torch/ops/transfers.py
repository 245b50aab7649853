"""Grid-transfer operators: restriction and prolongation, as torch ops.

Counterpart of ``emg3d_tpu/ops/transfers.py``:

- **Restriction** (full-weighting, Muld06 Eq. 8): in the field direction
  the two fine children are pair-summed (strided slices); in the
  transverse directions 3-point weighted sums of strided slices.
- **Prolongation** (Muld06 Eq. 10): piecewise constant in the field
  direction (repeat), tensor-product linear interpolation in the
  transverse directions, decomposed into two 1-D interleave passes.

Fields and model parameters may carry leading lane axes (a batched
solve): the grid axes are the last three.

The 1-D weights are host-precomputed per level (restrict_weights_1d,
prolong_weights_1d, copied unchanged) and moved to the device once by
the solver's build_levels.
"""
import numpy as np
import torch

__all__ = ['restrict_weights_1d', 'prolong_weights_1d', 'restrict',
           'prolongate', 'restrict_model_parameter']


# ----------------------------------------------------------------------
# Host-side 1-D weight computation (setup time)
# ----------------------------------------------------------------------

def restrict_weights_1d(nodes, centers, h, cnodes, ccenters, ch):
    """Restriction weights (wl, w0, wr) for one direction.

    Generalized Muld06 Eq. 9 with MoSu94 boundary treatment.
    Reference parity: emg3d/core.py:1970-2041.
    """
    n = len(cnodes)
    d = np.empty(n + 1)
    d[0] = h[0] / 2
    d[-1] = h[-1] / 2
    d[1:n] = (h[:-1:2] + h[1::2]) / 2

    wl = 1 / d[:-1]
    wl[0] *= (nodes[0] - h[0] / 2) - (cnodes[0] - ch[0] / 2)
    wl[1:] *= centers[1::2] - ccenters

    w0 = np.ones(n)

    wr = 1 / d[1:]
    wr[-1] *= (cnodes[-1] + ch[-1] / 2) - (nodes[-1] + h[-1] / 2)
    wr[:-1] *= ccenters - centers[::2]

    return wl, w0, wr


def prolong_weights_1d(fnodes, cnodes):
    """Left-coarse-node weights for odd fine nodes (linear interp).

    Fine node 2c coincides with coarse node c; fine node 2c+1 lies
    between coarse nodes c and c+1 and receives
    a[c]·coarse[c] + (1−a[c])·coarse[c+1].
    """
    odd = fnodes[1::2]
    a = (cnodes[1:] - odd) / np.diff(cnodes)
    return a


# ----------------------------------------------------------------------
# Device-side operators
# ----------------------------------------------------------------------

def _sl(ndim, axis, s):
    out = [slice(None)] * ndim
    out[axis] = s
    return tuple(out)


def _along(w, ndim, axis):
    """View a 1-D weight tensor so it broadcasts along ``axis``."""
    shape = [1] * ndim
    shape[axis] = w.shape[0]
    return w.reshape(shape)


def _sum_pairs(f, axis):
    """Pair-sum along the (even-length) field-direction axis."""
    return f[_sl(f.ndim, axis, slice(0, None, 2))] + \
        f[_sl(f.ndim, axis, slice(1, None, 2))]


def _restrict_nodes(f, w, axis):
    """3-point weighted restriction along a node-direction axis.

    f has nN = nC+1 entries along ``axis``; result has cnN = nC/2+1.
    Boundary neighbor indices are clamped (MoSu94), accumulating onto
    the boundary value.
    """
    wl, w0, wr = w
    nd = f.ndim
    center = f[_sl(nd, axis, slice(None, None, 2))]
    inner = f[_sl(nd, axis, slice(1, None, 2))]   # indices 1,3,..,nN-2
    left = torch.cat([f[_sl(nd, axis, slice(0, 1))], inner], dim=axis)
    right = torch.cat([inner, f[_sl(nd, axis, slice(-1, None))]], dim=axis)
    return (left * _along(wl, nd, axis) + center * _along(w0, nd, axis)
            + right * _along(wr, nd, axis))


def restrict(rx, ry, rz, weights, coarsen):
    """Full-weighting restriction of an edge residual field.

    Parameters
    ----------
    rx, ry, rz : fine edge component tensors.
    weights : 3-tuple of (wl, w0, wr) tensors or None per direction.
    coarsen : 3-tuple of bool — which directions are coarsened.

    Returns coarse (crx, cry, crz); PEC boundaries are NOT re-zeroed
    here (caller applies PEC).
    """
    def tx(f, is_field_dir, axis):
        if not coarsen[axis]:
            return f
        if is_field_dir:
            return _sum_pairs(f, axis + f.ndim - 3)
        return _restrict_nodes(f, weights[axis], axis + f.ndim - 3)

    crx = tx(tx(tx(rx, True, 0), False, 1), False, 2)
    cry = tx(tx(tx(ry, False, 0), True, 1), False, 2)
    crz = tx(tx(tx(rz, False, 0), False, 1), True, 2)
    return crx, cry, crz


def _interleave_nodes(c, a, axis):
    """Linear-interpolation upsampling along a node-direction axis.

    c has cn entries; result has 2·cn−1 = fine nN entries: even entries
    copy c, odd entries are a·c[i] + (1−a)·c[i+1].
    """
    nd = c.ndim
    aa = _along(a, nd, axis)
    head = c[_sl(nd, axis, slice(None, -1))]
    odd = head * aa + c[_sl(nd, axis, slice(1, None))] * (1 - aa)
    # Interleave head and odd, then append the last even entry.
    stacked = torch.stack([head, odd], dim=axis + 1)
    newshape = list(c.shape)
    newshape[axis] = 2 * (c.shape[axis] - 1)
    merged = stacked.reshape(newshape)
    return torch.cat([merged, c[_sl(nd, axis, slice(-1, None))]], dim=axis)


def interpolate(cex, cey, cez, pweights, coarsen):
    """The coarse correction interpolated to the fine edges.

    pweights : per-direction odd-node weights (from prolong_weights_1d)
    coarsen : which directions were coarsened.
    """
    def up(c, field_dir, axis):
        if not coarsen[axis]:
            return c
        if axis == field_dir:
            return torch.repeat_interleave(c, 2, dim=axis + c.ndim - 3)
        return _interleave_nodes(c, pweights[axis], axis + c.ndim - 3)

    return (up(up(up(cex, 0, 2), 0, 1), 0, 0),
            up(up(up(cey, 1, 2), 1, 0), 1, 1),
            up(up(up(cez, 2, 1), 2, 0), 2, 2))


def prolongate(ex, ey, ez, cex, cey, cez, pweights, coarsen):
    """Add the interpolated coarse correction to the fine field.

    PEC is NOT re-applied here (caller's job, matching the reference's
    efield.ensure_pec after prolongation).
    """
    ix, iy, iz = interpolate(cex, cey, cez, pweights, coarsen)
    return ex + ix, ey + iy, ez + iz


def restrict_model_parameter(param, coarsen):
    """Coarsen η/ζ by summing child cells (2/4/8 depending on dirs).

    A 4-D ``param`` is a stack of lanes (B, nx, ny, nz), coarsened lane
    by lane (reference parity: solver.py:1747-1784,
    _restrict_model_parameters; emg3d_tpu/ops/transfers.py:193-206).
    """
    out = param
    for axis, c in enumerate(coarsen):
        if c:
            out = _sum_pairs(out, axis + param.ndim - 3)
    return out
