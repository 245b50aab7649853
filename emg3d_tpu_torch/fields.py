"""Electromagnetic fields on staggered Yee grids (host-side numpy).

Counterpart of ``emg3d_tpu/fields.py``: :class:`Field`,
:class:`SourceField` and :func:`get_source_field` in all four source
formats, the receivers (:func:`get_receiver`,
:func:`get_receiver_response`) and :func:`get_h_field`.  The classes are plain host containers of three C-ordered
component arrays ``fx (nx, ny+1, nz+1)``, ``fy (nx+1, ny, nz+1)``,
``fz (nx+1, ny+1, nz)``; the solver copies them to the device as torch
tensors (:mod:`emg3d_tpu_torch.convert`) and back.  They are not JAX
pytrees.  Receivers and the H-field are host-side numpy, interpolated
by the port's own :func:`.maps.interp3d`.

A source from :func:`get_source_field` keeps only its nonzero edges
(:attr:`SourceField.record`: per component the flat edge indices and
their values): it builds its dense host arrays on first access, and the
solver places it on the device from those edges, so the few values are
all that cross.
"""
import warnings

import numpy as np
from scipy.constants import mu_0
from scipy.special import cosdg, sindg

from . import maps, utils
from .dtypes import complex_dtype, real_dtype

__all__ = ['Field', 'SourceField', 'get_source_field', 'get_receiver',
           'get_receiver_response', 'get_h_field']


class Field:
    """Electric (or magnetic) field with x/y/z edge components.

    Parameters
    ----------
    fx, fy, fz : ndarray
        The three field components (C-order, indexed [ix, iy, iz]).
    frequency : float or None
        Signed frequency: ``f > 0`` frequency domain (s = -2iπf),
        ``f < 0`` Laplace domain (s = f, real fields).

    Reference parity: emg3d/fields.py:34-365.
    """

    def __init__(self, fx, fy, fz, frequency=None):
        self.fx = fx
        self.fy = fy
        self.fz = fz
        self._frequency = frequency

    # -- constructors ----------------------------------------------------

    @classmethod
    def zeros(cls, grid, frequency=None, dtype=None):
        """Zero field on ``grid`` (electric edge layout)."""
        if dtype is None:
            dtype = _default_dtype(frequency)
        return cls(np.zeros(grid.shape_edges_x, dtype),
                   np.zeros(grid.shape_edges_y, dtype),
                   np.zeros(grid.shape_edges_z, dtype),
                   frequency=frequency)

    @classmethod
    def from_flat(cls, grid, flat, frequency=None):
        """Build from the reference's flat F-ordered 1-D layout."""
        flat = np.asarray(flat)
        nx_ = grid.n_edges_x
        nz_ = grid.n_edges_z
        fx = flat[:nx_].reshape(grid.shape_edges_x, order='F')
        fy = flat[nx_:-nz_].reshape(grid.shape_edges_y, order='F')
        fz = flat[-nz_:].reshape(grid.shape_edges_z, order='F')
        return cls(np.ascontiguousarray(fx), np.ascontiguousarray(fy),
                   np.ascontiguousarray(fz), frequency=frequency)

    # -- basic info ------------------------------------------------------

    @property
    def shape(self):
        return (self.fx.shape, self.fy.shape, self.fz.shape)

    @property
    def dtype(self):
        return self.fx.dtype

    @property
    def size(self):
        return self.fx.size + self.fy.size + self.fz.size

    @property
    def field(self):
        """Flat 1-D array in the reference's F-ordered layout."""
        return np.concatenate([np.asarray(self.fx).ravel(order='F'),
                               np.asarray(self.fy).ravel(order='F'),
                               np.asarray(self.fz).ravel(order='F')])

    @property
    def freq(self):
        """Unsigned frequency (Hz)."""
        return None if self._frequency is None else abs(self._frequency)

    @property
    def sval(self):
        """Laplace parameter s: -2iπf (f-domain) or f (Laplace domain)."""
        return _sval(self._frequency)

    @property
    def smu0(self):
        """s·μ0."""
        sval = self.sval
        return None if sval is None else sval * mu_0

    @property
    def is_electric(self):
        """Electric fields have fx.shape[0] < fy.shape[0]."""
        return self.shape[0][0] < self.shape[1][0]

    # -- copies ----------------------------------------------------------

    def copy(self):
        return Field(np.array(self.fx), np.array(self.fy), np.array(self.fz),
                     frequency=self._frequency)

    def ensure_pec(self):
        """Return field with tangential boundary edges zeroed (PEC)."""
        fx, fy, fz = (np.array(f) for f in (self.fx, self.fy, self.fz))
        fx[:, [0, -1], :] = 0
        fx[:, :, [0, -1]] = 0
        fy[[0, -1], :, :] = 0
        fy[:, :, [0, -1]] = 0
        fz[[0, -1], :, :] = 0
        fz[:, [0, -1], :] = 0
        # The field's own class, as the JAX package's apply_pec builds it
        # (a SourceField stays a SourceField).
        out = type(self).__new__(type(self))
        Field.__init__(out, fx, fy, fz, frequency=self._frequency)
        return out

    def astype(self, dtype):
        return Field(self.fx.astype(dtype), self.fy.astype(dtype),
                     self.fz.astype(dtype), frequency=self._frequency)

    def norm(self):
        """l2-norm over all components."""
        return _norm((self.fx, self.fy, self.fz))

    # -- arithmetic ------------------------------------------------------

    def _binop(self, other, op):
        if isinstance(other, Field):
            return Field(op(self.fx, other.fx), op(self.fy, other.fy),
                         op(self.fz, other.fz), frequency=self._frequency)
        return Field(op(self.fx, other), op(self.fy, other),
                     op(self.fz, other), frequency=self._frequency)

    def __add__(self, other):
        return self._binop(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._binop(other, lambda a, b: a - b)

    def __mul__(self, other):
        return self._binop(other, lambda a, b: a * b)

    def __rmul__(self, other):
        return self._binop(other, lambda a, b: b * a)

    def __truediv__(self, other):
        return self._binop(other, lambda a, b: a / b)

    def __neg__(self):
        return Field(-self.fx, -self.fy, -self.fz,
                     frequency=self._frequency)

    # -- em helpers ------------------------------------------------------

    def amp(self):
        """Amplitude of the field (flat layout)."""
        return utils.EMArray(self.field).amp()

    def pha(self, deg=False, unwrap=True, lag=True):
        """Phase of the field (flat layout)."""
        return utils.EMArray(self.field).pha(deg, unwrap, lag)

    # -- serialization ---------------------------------------------------

    def to_dict(self, copy=False):
        return {'field': self.field,
                'freq': self._frequency,
                'vnEx': self.fx.shape, 'vnEy': self.fy.shape,
                'vnEz': self.fz.shape,
                '__class__': self.__class__.__name__}

    @classmethod
    def from_dict(cls, inp):
        try:
            flat = np.asarray(inp['field'])
            vnEx = tuple(np.asarray(inp['vnEx'], dtype=int))
            vnEy = tuple(np.asarray(inp['vnEy'], dtype=int))
            vnEz = tuple(np.asarray(inp['vnEz'], dtype=int))
        except KeyError as e:
            raise KeyError(f"Variable {e} missing in `inp`.") from e
        nEx = int(np.prod(vnEx))
        nEz = int(np.prod(vnEz))
        fx = np.ascontiguousarray(flat[:nEx].reshape(vnEx, order='F'))
        fy = np.ascontiguousarray(flat[nEx:-nEz].reshape(vnEy, order='F'))
        fz = np.ascontiguousarray(flat[-nEz:].reshape(vnEz, order='F'))
        freq = inp.get('freq', None)
        if freq is not None:
            freq = None if str(freq) == 'None' else float(freq)
        return cls(fx, fy, fz, frequency=freq)

    def __repr__(self):
        return (f"{self.__class__.__name__}: {self.shape[0]} "
                f"{self.shape[1]} {self.shape[2]}; freq={self._frequency}")


def _sval(frequency):
    """The Laplace parameter of a signed ``frequency`` (None for None)."""
    if frequency is None:
        return None
    if frequency < 0:
        return np.float64(frequency)
    return np.complex128(-2j * np.pi * frequency)


def _default_dtype(frequency):
    """A zero field's dtype: complex, but real in the Laplace domain."""
    if frequency is None or frequency > 0:
        return complex_dtype()
    return real_dtype()


def _norm(comps):
    """l2-norm over the component arrays ``comps`` (an iterable)."""
    return np.sqrt(sum(np.sum(np.abs(np.asarray(f))**2) for f in comps))


def _component(i):
    """Property of a :class:`SourceField`'s component ``i``: its dense
    array, built from the record on first access."""
    def get(self):
        return self._dense()[i]

    def put(self, value):
        self._dense()[i] = value
    return property(get, put)


class SourceField(Field):
    """Source field s·μ0·Js; frequency is mandatory.

    A source from :func:`get_source_field` holds its :attr:`record`, the
    few edges it touches, and no dense arrays: ``fx``, ``fy`` and ``fz``
    (and all that reads them) build those on first access, by writing
    the record's values into an array of its zero, and drop the record,
    since the caller may write into them.  ``shape``, ``dtype``,
    ``frequency``, ``sval``, ``smu0`` and :meth:`norm` build nothing to
    keep.  A source made from arrays has no record.

    Reference parity: emg3d/fields.py:368-443.
    """

    _record = None
    fx, fy, fz = _component(0), _component(1), _component(2)

    def __init__(self, fx, fy, fz, frequency=None, src=None, strength=None,
                 moment=None):
        if frequency is None:
            raise ValueError("SourceField requires a frequency.")
        super().__init__(fx, fy, fz, frequency=frequency)
        self.src = src
        self.strength = strength
        self.moment = moment

    @classmethod
    def _recorded(cls, shapes, record, frequency, src, strength, moment):
        """A source of edge ``shapes`` held as its ``record``."""
        if frequency is None:
            raise ValueError("SourceField requires a frequency.")
        out = cls.__new__(cls)
        out._shapes = tuple(tuple(sh) for sh in shapes)
        out._record = record
        out._frequency = frequency
        out.src, out.strength, out.moment = src, strength, moment
        return out

    @property
    def record(self):
        """The nonzero edges, or None once the dense arrays exist: per
        component ``(idx, vals, zero)``, the ascending flat (C-order)
        indices of the edges the source touches, their values, and the
        one-element array of the value everywhere else (a zero, whose
        sign is that of ``0 · s·μ0·moment``)."""
        return self._record

    def _dense(self):
        if self._record is not None:
            self._comps = list(_record_arrays(self._shapes, self._record))
            self._record = None
        return self.__dict__.setdefault('_comps', [None, None, None])

    @property
    def shape(self):
        if self._record is not None:
            return self._shapes
        return super().shape

    @property
    def dtype(self):
        if self._record is not None:
            return self._record[0][1].dtype
        return super().dtype

    def norm(self):
        """l2-norm over all components (of the dense arrays, built for
        it and not kept where the source holds its record)."""
        if self._record is not None:
            return _norm(_record_arrays(self._shapes, self._record))
        return super().norm()

    def _record_norm(self):
        """The l2-norm from the record's values alone (within 1e-15 of
        :meth:`norm`, which sums the dense arrays in another order)."""
        return float(np.sqrt(sum(np.sum(np.abs(v)**2)
                                 for _, v, _ in self._record)))

    @classmethod
    def zeros(cls, grid, frequency=None, dtype=None):
        base = Field.zeros(grid, frequency=frequency, dtype=dtype)
        return cls(base.fx, base.fy, base.fz, frequency=frequency)

    @property
    def vector(self):
        """The source vector Js (without s·μ0)."""
        return self.field / self.smu0

    @property
    def vx(self):
        return np.asarray(self.fx) / self.smu0

    @property
    def vy(self):
        return np.asarray(self.fy) / self.smu0

    @property
    def vz(self):
        return np.asarray(self.fz) / self.smu0


# ----------------------------------------------------------------------
# Source construction (host-side; reference: fields.py:446-631, 914-1010)
# ----------------------------------------------------------------------

def get_source_field(grid, src, freq, strength=0, electric=True, length=1.0,
                     decimals=6):
    """Return the source field s·μ0·Js for a dipole/loop/polyline source.

    Source formats (reference parity, emg3d/fields.py:446-631):

    - Finite dipole ``[x0, x1, y0, y1, z0, z1]``
    - Point dipole ``[x, y, z, azimuth, dip]`` (-> finite dipole of
      ``length``; with ``electric=False`` -> square loop ⊥ to dipole)
    - Polyline ``[[x...], [y...], [z...]]`` (recursion over segments)

    The source is distributed to cell edges with the adjoint of trilinear
    interpolation of each in-cell segment's center of gravity.  The
    result holds the edges it touches (:attr:`SourceField.record`); its
    dense arrays, built on access, are those of the reference's dense
    construction to the bit.
    """
    if not np.allclose(np.size(src[0]), [np.size(c) for c in src]):
        raise ValueError("All source coordinates must have the same "
                         f"dimension. Provided source: {src}.")

    src = np.asarray(src, dtype=np.float64)
    strength = np.asarray(strength)
    shapes = (grid.shape_edges_x, grid.shape_edges_y, grid.shape_edges_z)

    if src.shape == (5,):  # Point dipole.
        if not electric:   # Magnetic -> square loop perpendicular to it.
            src = _square_loop_from_point_dipole(src, length)
        else:              # Electric -> finite dipole.
            src = _finite_dipole_from_point_dipole(src, length)

    if src.ndim > 1 and src.shape[0] == 3:  # Polyline: recurse segments.
        sx, sy, sz = src
        seg_len = np.sqrt(np.sum((src[:, :-1] - src[:, 1:])**2, axis=0))
        if strength == 0:
            seg_len = seg_len / seg_len.sum()
        else:
            seg_len = seg_len * strength

        # The segments' records summed as the dense fields would be,
        # from the zero field SourceField.zeros makes.
        dtype = _default_dtype(freq)
        record = ((np.zeros(0, np.int64), np.zeros(0, dtype),
                   np.zeros(1, dtype)),) * 3
        moment = np.zeros(3, dtype=seg_len.dtype)
        for i in range(sx.size - 1):
            seg = (sx[i], sx[i+1], sy[i], sy[i+1], sz[i], sz[i+1])
            segf = get_source_field(grid, seg, freq, seg_len[i])
            record = tuple(_record_add(r, q)
                           for r, q in zip(record, segf.record))
            moment = moment + segf.moment
        if not electric:
            record = tuple((i, -v, -z) for i, v, z in record)
        return SourceField._recorded(shapes, record, freq, src, strength,
                                     moment)

    if src.shape != (6,):
        raise ValueError(
            "Source is wrong defined. It must be either\n- a point, "
            "[x, y, z, azimuth, dip],\n- a finite dipole, "
            "[x1, x2, y1, y2, z1, z2], or\n- an arbitrarily shaped "
            f"dipole, [[x-coo], [y-coo], [z-coo]].\nProvided source: {src}.")

    dvec = src[1::2] - src[::2]
    if np.allclose(dvec, 0, atol=1e-15):
        raise ValueError("Provided finite dipole has no length; use "
                         "the format [x, y, z, azimuth, dip] instead.")

    if strength == 0:  # Normalized to 1 A m.
        moment = dvec / np.linalg.norm(dvec)
    else:
        moment = strength * dvec

    if freq is None:
        raise ValueError("SourceField requires a frequency.")
    smu0 = _sval(freq) * mu_0
    record = []
    for xyz, shape in enumerate(shapes):
        idx, s = _finite_source_xyz(grid, src, shape, xyz, decimals)
        scale = moment[xyz] * smu0
        record.append((idx, s * scale, np.zeros(1) * scale))

    return SourceField._recorded(shapes, tuple(record), freq, src, strength,
                                 moment)


def _record_arrays(shapes, record):
    """The dense component arrays a record defines (one at a time)."""
    for shape, (idx, vals, zero) in zip(shapes, record):
        out = np.full(shape, zero[0], dtype=vals.dtype)
        out.reshape(-1)[idx] = vals
        yield out


def _record_add(a, b):
    """The record of the sum of two components' dense arrays: at every
    edge either touches, the two values (a zero where one has none)
    added as the dense arrays' elements are."""
    def at(idx, own):
        i, vals, zero = own
        out = np.full(idx.size, zero[0], dtype=vals.dtype)
        out[np.searchsorted(idx, i)] = vals
        return out
    idx = np.union1d(a[0], b[0])
    return idx, at(idx, a) + at(idx, b), a[2] + b[2]


def _finite_source_xyz(grid, src, shape, xyz, decimals):
    """A finite dipole's xyz-component on the edges of ``shape``: the
    ascending flat indices of the edges it touches and their float64
    weights.

    Vectorized: the segment is split at every node-plane crossing into
    sub-segments (each inside exactly one cell); all sub-segment
    midpoints are then scattered with trilinear-adjoint weights, summed
    per edge in the order four ``np.add.at`` calls into a dense array
    would sum them.  Behavior matches the reference's per-cell
    center-of-gravity distribution (emg3d/fields.py:914-1010) by
    construction — same sub-segments, same weights — without its
    triple loop over the bounding box of cells.
    """
    nodes = [np.round(grid.nodes_x, decimals),
             np.round(grid.nodes_y, decimals),
             np.round(grid.nodes_z, decimals)]
    src = np.round(src, decimals)
    p0, p1 = src[::2], src[1::2]

    for ax in range(3):
        lo, hi = min(p0[ax], p1[ax]), max(p0[ax], p1[ax])
        if lo < nodes[ax][0] or hi > nodes[ax][-1]:
            raise ValueError(f"Provided source outside grid: {src}.")

    d = p1 - p0

    # Breakpoints of the line parameter t in [0, 1]: segment ends plus
    # every node-plane crossing of the non-degenerate axes.
    ts = [np.array([0.0, 1.0])]
    for ax in range(3):
        if d[ax] != 0:
            t = (nodes[ax] - p0[ax]) / d[ax]
            ts.append(t[(t > 0) & (t < 1)])
    t = np.unique(np.concatenate(ts))
    dt = np.diff(t)                      # sub-segment length fractions
    mid = p0 + (t[:-1] + dt / 2)[:, None] * d   # (nseg, 3) midpoints

    # Cell of each midpoint and normalized in-cell offsets.
    idx, ofs = [], []
    for ax in range(3):
        i = np.clip(np.searchsorted(nodes[ax], mid[:, ax], 'right') - 1,
                    0, len(nodes[ax]) - 2)
        idx.append(i)
        ofs.append((mid[:, ax] - nodes[ax][i]) / np.asarray(grid.h[ax])[i])
    ix, iy, iz = idx
    rx, ry, rz = ofs

    # Trilinear-adjoint scatter in the plane transverse to the edge
    # direction; the along-edge index takes the full weight.
    if xyz == 0:
        ra, rb = ry, rz
        at = lambda da, db: (ix, iy + da, iz + db)
    elif xyz == 1:
        ra, rb = rx, rz
        at = lambda da, db: (ix + da, iy, iz + db)
    else:
        ra, rb = rx, ry
        at = lambda da, db: (ix + da, iy + db, iz)
    flat = np.concatenate([np.ravel_multi_index(at(da, db), shape)
                           for da, db in ((0, 0), (1, 0), (0, 1), (1, 1))])
    w = np.concatenate([(1 - ra) * (1 - rb) * dt, ra * (1 - rb) * dt,
                        (1 - ra) * rb * dt, ra * rb * dt])
    edges, inv = np.unique(flat, return_inverse=True)
    s = np.zeros(edges.size)
    np.add.at(s, inv, w)

    # Near the renormalizing threshold, or past it, the dense array's
    # own (pairwise) sum decides, as it always has.
    if abs(abs(s.sum()) - 1) > 1e-6 - 1e-12:
        dense = np.zeros(shape)
        np.add.at(dense.reshape(-1), flat, w)
        sum_s = abs(dense.sum())
        if abs(sum_s - 1) > 1e-6:
            msg = f"Normalizing Source: {sum_s:.10f}."
            print(f"* WARNING :: {msg}")
            warnings.warn(msg, UserWarning)
            dense /= sum_s
        s = dense.reshape(-1)[edges]
    return edges, s


def _rotation(azm, dip):
    """Rotation factors (x, y, z) for azimuth/dip in degrees, z up."""
    return np.array([cosdg(azm)*cosdg(dip), sindg(azm)*cosdg(dip),
                     sindg(dip)])


def _finite_dipole_from_point_dipole(src, length):
    """Finite dipole of ``length`` from point dipole [x,y,z,azm,dip]."""
    factors = _rotation(*src[3:]) * length / 2
    return np.ravel(src[:3] + np.stack([-factors, factors]), 'F')


def _square_loop_from_point_dipole(src, length):
    """Square loop of side ``length`` perpendicular to a point dipole."""
    half_diag = np.sqrt(2) * length / 2
    rot_hor = _rotation(src[3] + 90, 0) * half_diag
    rot_ver = _rotation(src[3], src[4] + 90) * half_diag
    points = src[:3] + np.stack(
        [rot_hor, rot_ver, -rot_hor, -rot_ver, rot_hor])
    return points.T


# ----------------------------------------------------------------------
# Receivers & H-field (host-side; reference: fields.py:634-911)
# ----------------------------------------------------------------------

def get_receiver(grid, values, coordinates, method='cubic',
                 extrapolate=False):
    """Interpolate field/model values at receiver coordinates.

    One boundary layer is stripped to avoid boundary effects; points
    outside the (stripped) grid give NaN unless ``extrapolate=True``.
    Reference parity: emg3d/fields.py:634-730.
    """
    if isinstance(values, Field):
        fx = get_receiver(grid, values.fx, coordinates, method, extrapolate)
        fy = get_receiver(grid, values.fy, coordinates, method, extrapolate)
        fz = get_receiver(grid, values.fz, coordinates, method, extrapolate)
        return fx, fy, fz

    if len(coordinates) != 3:
        raise ValueError("Coordinates needs to be in the form (x, y, z).\n"
                         f"Length of provided coord.: {len(coordinates)}.")

    values = np.asarray(values)
    points = tuple()
    for i, coord in enumerate(['x', 'y', 'z']):
        if values.shape[i] == grid.shape_nodes[i]:
            points += (getattr(grid, 'nodes_' + coord)[1:-1],)
        else:
            points += (getattr(grid, 'cell_centers_' + coord)[1:-1],)

    xi = np.stack(np.broadcast_arrays(*[np.asarray(c, dtype=float)
                                        for c in coordinates]), axis=-1)
    if extrapolate:
        out = maps.interp3d(points, values[1:-1, 1:-1, 1:-1], xi, method,
                            fill_value=None, mode='nearest')
    else:
        out = maps.interp3d(points, values[1:-1, 1:-1, 1:-1], xi, method,
                            fill_value=np.nan, mode='constant')

    if values.size == grid.n_cells:
        return out
    return utils.EMArray(out)


def get_receiver_response(grid, field, rec):
    """Full response of an arbitrarily rotated point receiver.

    Weights fx, fy, fz by (cos a cos d, sin a cos d, sin d).
    Reference parity: emg3d/fields.py:733-817.
    """
    if len(rec) != 5:
        raise ValueError(
            "`rec` needs to be in the form (x, y, z, azimuth, dip).\n"
            f"Length of provided `rec`: {len(rec)}.")

    if not isinstance(field, Field):
        raise ValueError("`field` must be a `Field`-instance, not a\n"
                         "particular field such as `field.fx`.")

    if field.is_electric:
        points = ((grid.cell_centers_x, grid.nodes_y, grid.nodes_z),
                  (grid.nodes_x, grid.cell_centers_y, grid.nodes_z),
                  (grid.nodes_x, grid.nodes_y, grid.cell_centers_z))
    else:
        points = ((grid.nodes_x, grid.cell_centers_y, grid.cell_centers_z),
                  (grid.cell_centers_x, grid.nodes_y, grid.cell_centers_z),
                  (grid.cell_centers_x, grid.cell_centers_y, grid.nodes_z))
    points = tuple(tuple(p[1:-1] for p in pp) for pp in points)

    n = max(np.atleast_1d(x).size for x in rec)
    resp = np.zeros(n, dtype=np.asarray(field.fx).dtype)
    xi = np.stack(np.broadcast_arrays(
        *[np.asarray(c, dtype=float) for c in rec[:3]]), axis=-1)

    factors = _rotation(*rec[3:])
    for i, ff in enumerate((field.fx, field.fy, field.fz)):
        if np.any(abs(factors[i]) > 1e-10):
            resp = resp + factors[i] * maps.interp3d(
                points[i], np.asarray(ff)[1:-1, 1:-1, 1:-1], xi,
                'cubic', fill_value=np.nan, mode='constant')
    return utils.EMArray(resp)


def get_h_field(grid, model, field):
    """Magnetic field H from electric field E via Faraday's law.

    Reference parity: emg3d/fields.py:820-911.
    """
    from . import models as _models

    fx = np.asarray(field.fx)
    fy = np.asarray(field.fy)
    fz = np.asarray(field.fz)
    hx_ = grid.h[0][:, None, None]
    hy_ = grid.h[1][None, :, None]
    hz_ = grid.h[2][None, None, :]

    e3d_hx = (np.diff(fz, axis=1) / grid.h[1][None, :, None] -
              np.diff(fy, axis=2) / grid.h[2][None, None, :])
    e3d_hy = (np.diff(fx, axis=2) / grid.h[2][None, None, :] -
              np.diff(fz, axis=0) / grid.h[0][:, None, None])
    e3d_hz = (np.diff(fy, axis=0) / grid.h[0][:, None, None] -
              np.diff(fx, axis=1) / grid.h[1][None, :, None])

    if model.mu_r is not None:
        vmodel = _models.VolumeModel(grid, model, field)
        zeta = np.asarray(vmodel.zeta)

        ixm = np.r_[0, np.arange(grid.shape_cells[0])]
        ixp = np.r_[np.arange(grid.shape_cells[0]), grid.shape_cells[0]-1]
        iym = np.r_[0, np.arange(grid.shape_cells[1])]
        iyp = np.r_[np.arange(grid.shape_cells[1]), grid.shape_cells[1]-1]
        izm = np.r_[0, np.arange(grid.shape_cells[2])]
        izp = np.r_[np.arange(grid.shape_cells[2]), grid.shape_cells[2]-1]

        zeta_x = (zeta[ixm, :, :] + zeta[ixp, :, :]) / 2.
        zeta_y = (zeta[:, iym, :] + zeta[:, iyp, :]) / 2.
        zeta_z = (zeta[:, :, izm] + zeta[:, :, izp]) / 2.

        dx = (np.r_[0., grid.h[0]] + np.r_[grid.h[0], 0.]) / 2.
        dy = (np.r_[0., grid.h[1]] + np.r_[grid.h[1], 0.]) / 2.
        dz = (np.r_[0., grid.h[2]] + np.r_[grid.h[2], 0.]) / 2.

        e3d_hx = e3d_hx * zeta_x / (dx[:, None, None] * hy_ * hz_)
        e3d_hy = e3d_hy * zeta_y / (hx_ * dy[None, :, None] * hz_)
        e3d_hz = e3d_hz * zeta_z / (hx_ * hy_ * dz[None, None, :])

    smu0 = field.smu0
    return Field(-e3d_hx / smu0, -e3d_hy / smu0, -e3d_hz / smu0,
                 frequency=field._frequency)
