"""Model-parameter mappings and grid-to-grid interpolation.

Copy of ``emg3d_tpu/maps.py`` (numpy/scipy only), the counterpart of
the reference's maps layer (emg3d/maps.py).  The six bijections between the
inversion variable and conductivity are identical in math; the
interpolation / volume-averaging routines are implemented with
vectorized numpy (host-side, setup-time code) instead of numba kernels.
"""
import numpy as np
from scipy import interpolate as sint, ndimage

__all__ = [
    '_Map', 'MapConductivity', 'MapLgConductivity', 'MapLnConductivity',
    'MapResistivity', 'MapLgResistivity', 'MapLnResistivity', 'MAPLIST',
    'grid2grid', 'interp3d', 'volume_average', 'edges2cellaverages',
]


class _Map:
    """Base class for property mappings (variable <-> conductivity σ).

    Reference parity: emg3d/maps.py:284-334.
    """

    def __init__(self, description):
        self.name = self.__class__.__name__[3:]
        self.description = description

    def __repr__(self):
        return (f"{self.__class__.__name__}: {self.description}\n"
                "    Maps investigation variable `x` to\n"
                "    computational variable `σ` (conductivity).")

    def forward(self, conductivity):
        raise NotImplementedError("Forward map not implemented.")

    def backward(self, mapped):
        raise NotImplementedError("Backward map not implemented.")

    def derivative_chain(self, gradient, mapped):
        raise NotImplementedError("Derivative chain not implemented.")

    def to_dict(self, copy=False):
        return {'name': self.name, '__class__': self.__class__.__name__}

    @classmethod
    def from_dict(cls, inp):
        return MAPLIST[inp['name']]()


class MapConductivity(_Map):
    """σ <-> σ (identity)."""

    def __init__(self):
        super().__init__('conductivity')

    def forward(self, conductivity):
        return conductivity

    def backward(self, mapped):
        return mapped

    def derivative_chain(self, gradient, mapped):
        pass


class MapLgConductivity(_Map):
    """log10(σ) <-> σ."""

    def __init__(self):
        super().__init__('log_10(conductivity)')

    def forward(self, conductivity):
        return np.log10(conductivity)

    def backward(self, mapped):
        return 10**mapped

    def derivative_chain(self, gradient, mapped):
        gradient *= self.backward(mapped) * np.log(10)


class MapLnConductivity(_Map):
    """ln(σ) <-> σ."""

    def __init__(self):
        super().__init__('log_e(conductivity)')

    def forward(self, conductivity):
        return np.log(conductivity)

    def backward(self, mapped):
        return np.exp(mapped)

    def derivative_chain(self, gradient, mapped):
        gradient *= self.backward(mapped)


class MapResistivity(_Map):
    """ρ = σ⁻¹ <-> σ."""

    def __init__(self):
        super().__init__('resistivity')

    def forward(self, conductivity):
        return 1.0 / conductivity

    def backward(self, mapped):
        return 1.0 / mapped

    def derivative_chain(self, gradient, mapped):
        gradient *= -self.backward(mapped)**2


class MapLgResistivity(_Map):
    """log10(ρ) <-> σ."""

    def __init__(self):
        super().__init__('log_10(resistivity)')

    def forward(self, conductivity):
        return np.log10(1.0 / conductivity)

    def backward(self, mapped):
        return 10**-mapped

    def derivative_chain(self, gradient, mapped):
        gradient *= -self.backward(mapped) * np.log(10)


class MapLnResistivity(_Map):
    """ln(ρ) <-> σ."""

    def __init__(self):
        super().__init__('log_e(resistivity)')

    def forward(self, conductivity):
        return np.log(1.0 / conductivity)

    def backward(self, mapped):
        return np.exp(-mapped)

    def derivative_chain(self, gradient, mapped):
        gradient *= -self.backward(mapped)


MAPLIST = {M().name: M for M in [
    MapConductivity, MapLgConductivity, MapLnConductivity,
    MapResistivity, MapLgResistivity, MapLnResistivity]}


# ----------------------------------------------------------------------
# Grid-to-grid interpolation
# ----------------------------------------------------------------------

def grid2grid(grid, values, new_grid, method='linear', extrapolate=True,
              log=False):
    """Interpolate values from one tensor grid to another.

    method : 'linear' | 'cubic' | 'volume'
        Volume = conservative volume averaging (cell properties only).

    Reference parity: emg3d/maps.py:34-176.
    """
    from .fields import Field

    # Field: interpolate each component on its own edge-grid (recursive).
    if isinstance(values, Field):
        fx = grid2grid(grid, np.asarray(values.fx), new_grid, method,
                       extrapolate, log)
        fy = grid2grid(grid, np.asarray(values.fy), new_grid, method,
                       extrapolate, log)
        fz = grid2grid(grid, np.asarray(values.fz), new_grid, method,
                       extrapolate, log)
        return Field(fx, fy, fz, frequency=values._frequency)

    values = np.asarray(values)

    if method == 'volume':
        if values.shape != tuple(grid.shape_cells):
            raise ValueError("volume averaging requires cell-centered "
                             "values of shape grid.shape_cells.")
        points = (grid.nodes_x, grid.nodes_y, grid.nodes_z)
        new_points = (new_grid.nodes_x, new_grid.nodes_y, new_grid.nodes_z)
        if log:
            return 10**volume_average(points, np.log10(values), new_points,
                                      new_grid.cell_volumes)
        return volume_average(points, values, new_points,
                              new_grid.cell_volumes)

    # Node-based linear/cubic interpolation on matching dual grids.
    points, new_points = _axes_for_shape(grid, new_grid, values.shape)
    xi = np.stack(np.meshgrid(*new_points, indexing='ij'), axis=-1)
    out = interp3d(points, values, xi, method,
                   fill_value=None if extrapolate else 0.0,
                   mode='nearest' if extrapolate else 'constant', log=log)
    return out


def _axes_for_shape(grid, new_grid, shape):
    """Coordinate axes on which `shape`-shaped values live on both grids."""
    def axes(g):
        out = []
        for i, (n, name) in enumerate(zip(
                shape, ['x', 'y', 'z'])):
            if n == g.shape_cells[i]:
                out.append(getattr(g, 'cell_centers_' + name))
            elif n == g.shape_nodes[i]:
                out.append(getattr(g, 'nodes_' + name))
            else:
                raise ValueError(
                    f"values shape {shape} fits neither cells nor nodes.")
        return tuple(out)
    return axes(grid), axes(new_grid)


def interp3d(points, values, new_points, method='cubic', fill_value=0.0,
             mode='constant', log=False):
    """3-D interpolation: linear (regular-grid) or cubic (spline order 3).

    Complex values are interpolated as separate real/imag parts.
    Reference parity: emg3d/maps.py:179-272.
    """
    if log:
        values = np.log10(values)

    # Normalize point layout: (..., 3) with at least one leading axis.
    new_points = np.asarray(new_points, dtype=float)
    single = new_points.ndim == 1
    if single:
        new_points = new_points[None, :]

    if np.iscomplexobj(values):
        re = interp3d(points, values.real, new_points, method, fill_value,
                      mode)
        im = interp3d(points, values.imag, new_points, method, fill_value,
                      mode)
        out = re + 1j * im
    elif method == 'linear':
        fv = np.nan if fill_value is None else fill_value
        pts = np.asarray(new_points, dtype=float)
        if mode == 'nearest':
            # Nearest-style extrapolation of the linear interpolant:
            # evaluate at the query clamped into the grid hull
            # (reference maps.py:179-272; scipy's own extrapolation
            # would be linear, not clamped).
            pts = pts.copy()
            for i, ax in enumerate(points):
                pts[..., i] = np.clip(pts[..., i], ax[0], ax[-1])
        fn = sint.RegularGridInterpolator(
            points, values, method='linear', bounds_error=False,
            fill_value=None if mode == 'nearest' else fv)
        out = fn(pts)
    else:
        # Cubic via map_coordinates: transform physical coords to (frac)
        # index coordinates with 1-D interpolation per axis.
        coords = np.empty((3,) + np.asarray(new_points).shape[:-1])
        for i, pts in enumerate(points):
            idx = np.arange(len(pts), dtype=float)
            coords[i] = np.interp(new_points[..., i], pts, idx)
            # np.interp clamps outside -> 'nearest'-style extrapolation.
            if mode == 'constant':
                outside = ((new_points[..., i] < pts[0]) |
                           (new_points[..., i] > pts[-1]))
                coords[i] = np.where(outside, -2 * len(pts), coords[i])
        cval = 0.0 if fill_value is None else fill_value
        if np.isnan(cval):
            cval = np.nan
        out = ndimage.map_coordinates(
            values, coords, order=3, mode='nearest' if mode == 'nearest'
            else 'constant', cval=cval)

    if single:
        out = np.asarray(out).reshape(-1)[0] * np.ones(())
    if log:
        return 10**out
    return out


# ----------------------------------------------------------------------
# Conservative volume averaging  (vectorized; reference: maps.py:452-574)
# ----------------------------------------------------------------------

def _overlap_weights(edges_in, edges_out):
    """1-D overlap lengths between all (in, out) cell pairs, dense matrix.

    Returns W with W[i, j] = |[ei_j, ei_j+1] ∩ [eo_i, eo_i+1]|, after the
    input grid has been (virtually) extended to cover the output range
    (first/last input cells are stretched, matching the reference's
    behavior of clipping the output grid into the input extent).
    """
    ei = np.asarray(edges_in, dtype=float).copy()
    eo = np.asarray(edges_out, dtype=float)
    # Stretch outermost input edges to cover the output domain.
    ei[0] = min(ei[0], eo[0])
    ei[-1] = max(ei[-1], eo[-1])
    lo = np.maximum(ei[None, :-1], eo[:-1, None])
    hi = np.minimum(ei[None, 1:], eo[1:, None])
    return np.maximum(hi - lo, 0.0)


def volume_average(points, values, new_points, new_vol):
    """Conservative volume-averaged regridding of cell properties.

    points, new_points : 3-tuples of node vectors.
    values : (nx, ny, nz) cell values on the input grid.
    new_vol : cell volumes of the output grid (3-D array).

    Implemented as three dense 1-D overlap matmuls (TPU/MXU-friendly and
    trivially vectorizable) instead of the reference's scalar loops
    (emg3d/maps.py:452-574); produces identical results.
    """
    wx = _overlap_weights(points[0], new_points[0])
    wy = _overlap_weights(points[1], new_points[1])
    wz = _overlap_weights(points[2], new_points[2])
    out = np.einsum('Xx,Yy,Zz,xyz->XYZ', wx, wy, wz, values, optimize=True)
    return out / np.asarray(new_vol)


def edges2cellaverages(ex, ey, ez, vol):
    """Adjoint of edge interpolation: edge fields to cell centers × V/4.

    For each cell, the 4 edges of each direction are summed and weighted
    by the cell volume / 4.  Used by the adjoint-state gradient.
    Reference parity: emg3d/maps.py:578-631.
    """
    def sum4(f, axes):
        # Sum the 2x2 transverse edge values around each cell.
        s = f
        for ax in axes:
            s = np.take(s, range(0, s.shape[ax]-1), axis=ax) + \
                np.take(s, range(1, s.shape[ax]), axis=ax)
        return s

    vol4 = np.asarray(vol) / 4.0
    gx = sum4(np.asarray(ex), (1, 2)) * vol4
    gy = sum4(np.asarray(ey), (0, 2)) * vol4
    gz = sum4(np.asarray(ez), (0, 1)) * vol4
    return gx, gy, gz
