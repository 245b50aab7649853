"""Receiver responses of a field, worked out again with emg3d's documented
scheme (emg3d/fields.py ``get_receiver_response``; the emg3d manual).

Each component of an electric field lives on its own staggered points:
x-edges at (cell centres, nodes, nodes) in (x, y, z), y-edges at
(nodes, centres, nodes), z-edges at (nodes, nodes, centres).  One
boundary layer of points is stripped on every side.  A receiver at
(x, y, z) with azimuth θ and dip φ (degrees) reads

    cos θ cos φ · fx + sin θ cos φ · fy + sin φ · fz,

each component interpolated at the receiver by a cubic spline through
its points: the receiver's position becomes a fractional index per axis
(linear in the coordinate between two points), then
``scipy.ndimage.map_coordinates`` of order 3, real and imaginary parts
apart.  A receiver outside the stripped points reads NaN.  Components
whose weight is below 1e-10 for every receiver are left out, as emg3d
leaves them out.  Plain NumPy and SciPy; nothing of the program under
test is imported or called.
"""
import numpy as np
from scipy import ndimage

__all__ = ['weights', 'responses']


def weights(receivers):
    """(3, n) component weights of receivers ``[x, y, z, azimuth, dip]``."""
    rec = np.asarray(receivers, dtype=np.float64).reshape(-1, 5)
    az, dip = np.deg2rad(rec[:, 3]), np.deg2rad(rec[:, 4])
    w = np.stack([np.cos(az) * np.cos(dip), np.sin(az) * np.cos(dip),
                  np.sin(dip)])
    # Exact zeros for axis-aligned receivers (cos 90° is not 0 in floats).
    w[np.abs(w) < 1e-15] = 0.0
    return w


def _spline(values, coords):
    return ndimage.map_coordinates(values, coords, order=3, mode='constant',
                                   cval=np.nan)


def responses(nodes, field, receivers):
    """Complex responses, shape (n,), of the receivers ``[x, y, z,
    azimuth, dip]`` to the electric field ``field`` = (fx, fy, fz) on the
    grid of node coordinates ``nodes`` = (x, y, z)."""
    nodes = [np.asarray(n, dtype=np.float64) for n in nodes]
    centres = [(n[:-1] + n[1:]) / 2 for n in nodes]
    rec = np.asarray(receivers, dtype=np.float64).reshape(-1, 5)
    w = weights(rec)
    out = np.zeros(len(rec), dtype=np.complex128)
    for comp in range(3):
        if not np.any(np.abs(w[comp]) > 1e-10):
            continue
        points = [(centres if ax == comp else nodes)[ax][1:-1]
                  for ax in range(3)]
        coords = np.empty((3, len(rec)))
        inside = np.ones(len(rec), dtype=bool)
        for ax, p in enumerate(points):
            coords[ax] = np.interp(rec[:, ax], p, np.arange(len(p),
                                                            dtype=float))
            inside &= (rec[:, ax] >= p[0]) & (rec[:, ax] <= p[-1])
        vals = np.asarray(field[comp])[1:-1, 1:-1, 1:-1]
        got = _spline(vals.real.astype(np.float64), coords) \
            + 1j * _spline(vals.imag.astype(np.float64), coords)
        out += w[comp] * np.where(inside, got, np.nan)
    return out
