"""Grids and models of a configuration file, as plain arrays.

Both sides take what these build: the program its inputs, the reference
the same arrays.  A configuration's ``grid`` gives per axis a ``core``
of equal cells (first node, cells, width); its ``model`` a
``background`` resistivity (ρx, ρy, ρz) in every cell.
"""
import numpy as np

__all__ = ['widths', 'nodes', 'rehearsal_grid', 'resistivity']


def widths(grid):
    """(h, origin): the cell widths per axis and the first node."""
    h, origin = [], []
    for ax in 'xyz':
        start, cells, width = grid[ax]['core']
        h.append(np.full(int(cells), float(width)))
        origin.append(float(start))
    return h, tuple(origin)


def nodes(h, origin):
    return tuple(o + np.r_[0.0, np.cumsum(w)] for w, o in zip(h, origin))


def rehearsal_grid(h, origin, cells=8):
    """The same domain in ``cells`` equal cells per axis (the CPU
    rehearsal of a cell)."""
    return [np.full(cells, w.sum() / cells) for w in h], origin


def resistivity(model, h):
    """(ρx, ρy, ρz) arrays of the cell shape."""
    shape = tuple(len(w) for w in h)
    return tuple(np.full(shape, float(v)) for v in model['background'])
