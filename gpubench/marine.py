"""Stretched grids and layered models of a marine configuration file, as
plain arrays.

Both sides take what these build: the program its mesh and model, the
reference the same widths and resistivities (as ``problem`` does for a
homogeneous fullspace).  A configuration's ``grid`` gives per axis a
``core`` of equal cells (first node, cells, width) and a ``pad``,
``[[cells, factor], [cells, factor]]`` below and above the core, each
padding cell ``factor`` times as wide as its neighbour towards the
core.  Its ``rehearsal_grid`` is a grid of the same form small enough
for the CPU.  Its ``model`` gives ``layers``, ``[top, bottom,
resistivity]`` in metres (z up) and Ω·m, and ``air``, the resistivity
above the first layer's top; each cell takes the resistivity of the
layer that holds its centre.
"""
import numpy as np

__all__ = ['widths', 'resistivity', 'survey']


def _axis(spec):
    """(widths, first node) of one axis."""
    start, cells, width = spec['core']
    (nlo, flo), (nhi, fhi) = spec['pad']
    core = np.full(int(cells), float(width))
    lo = float(width) * float(flo) ** np.arange(1, int(nlo) + 1)
    hi = float(width) * float(fhi) ** np.arange(1, int(nhi) + 1)
    return np.r_[lo[::-1], core, hi], float(start) - lo.sum()


def widths(config, rehearse=False):
    """(h, origin): the cell widths per axis and the first node, of the
    configuration's grid or, with ``rehearse``, of its rehearsal grid."""
    grid = config['rehearsal_grid' if rehearse else 'grid']
    axes = [_axis(grid[ax]) for ax in 'xyz']
    return [h for h, _ in axes], tuple(o for _, o in axes)


def _layer_of(model, z):
    """Resistivity at depth ``z`` (array): the air above the first
    layer's top, else the layer whose [bottom, top) holds it, the last
    layer below the last bottom."""
    z = np.asarray(z, dtype=float)
    layers = model['layers']
    out = np.full(z.shape, float(layers[-1][2]))
    for top, bottom, rho in reversed(layers):
        out = np.where((z < float(top)) & (z >= float(bottom)), float(rho),
                       out)
    return np.where(z >= float(layers[0][0]), float(model['air']), out)


def resistivity(model, h, origin):
    """(ρx, ρy, ρz) arrays of the cell shape (isotropic: one array three
    times) of the layered model on the grid (h, origin)."""
    hz = np.asarray(h[2], dtype=float)
    zc = origin[2] + np.cumsum(hz) - hz / 2
    rho = np.broadcast_to(_layer_of(model, zc)[None, None, :],
                          tuple(len(w) for w in h)).copy()
    return rho, rho, rho


def survey(config, offset=(0.0, 0.0)):
    """(sources, receivers, frequencies) of the configuration: each
    source ``[x, y, z, azimuth, dip]`` moved by ``offset`` in x and y,
    each receiver ``[x, y, z, azimuth, dip]``."""
    sv = config['survey']
    dx, dy = (float(v) for v in offset)
    x0, x1, n = sv['source_x']
    srcs = [[float(x) + dx, float(sv['source_y']) + dy, float(sv['source_z']),
             float(sv['azimuth']), float(sv['dip'])]
            for x in np.linspace(float(x0), float(x1), int(n))]
    x0, x1, n = sv['receiver_x']
    recs = [[float(x), float(sv['receiver_y']), float(sv['receiver_z']),
             float(sv['azimuth']), float(sv['dip'])]
            for x in np.linspace(float(x0), float(x1), int(n))]
    return srcs, recs, [float(f) for f in sv['frequencies']]
