"""Surveys: sources, receivers, frequencies, and observed data.

Copy of ``emg3d_tpu/surveys.py`` (numpy only), the counterpart of the
reference's survey layer (emg3d/surveys.py).  The reference stores data in an
``xarray.Dataset`` (hard requirement there); here a minimal in-house
:class:`DataView` (dict of named (nsrc, nrec, nfreq) numpy arrays with
attribute access) provides the same surface without the dependency —
xarray is unnecessary for the compute path and absent on the target
systems.
"""
from copy import deepcopy
from dataclasses import dataclass, field

import numpy as np

__all__ = ['Survey', 'Dipole', 'PointDipole']

class DataView(dict):
    """dict of named data arrays with attribute access (xarray-lite)."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value


class Survey:
    """A CSEM survey: sources x receivers x frequencies with data.

    Parameters (reference parity: emg3d/surveys.py:36-214)
    ----------
    name : str
    sources, receivers : tuple, list, or dict
        Tuples of coordinates ``(x, y, z, azm, dip[, electric])``
        (scalars broadcast; auto-named Tx000.../Rx000...), lists of
        :class:`Dipole`, or dicts of de-serialized dipoles.
    frequencies : array_like
    data : ndarray (nsrc, nrec, nfreq), optional
        Observed data; NaN where absent.
    fixed : bool
        Streamer-type layout: receiver positions per source (offsets).
    noise_floor, relative_error, std : optional
        Noise description; see ``standard_deviation``.
    """

    def __init__(self, name, sources, receivers, frequencies, data=None,
                 fixed=0, **kwargs):
        self.name = name
        self.fixed = fixed

        self._sources = self._dipole_info_to_dict(sources, 'source')
        self._receivers = self._dipole_info_to_dict(receivers, 'receiver')
        self._frequencies = np.array(frequencies, dtype=np.float64,
                                     ndmin=1)

        # Data container.
        nsrc = len(self._sources)
        nrec = len(self._receivers)
        nfreq = self._frequencies.size
        if data is None:
            data = np.full((nsrc, nrec, nfreq), np.nan + 1j*np.nan,
                           dtype=np.complex128)
        else:
            data = np.atleast_3d(np.asarray(data)).astype(np.complex128)
            if data.shape != (nsrc, nrec, nfreq):
                raise ValueError(
                    f"Shape of data {data.shape} does not match survey "
                    f"({nsrc}, {nrec}, {nfreq}).")
        self._data = DataView(observed=data)
        self._attrs = {}

        self.noise_floor = kwargs.pop('noise_floor', None)
        self.relative_error = kwargs.pop('relative_error', None)
        self.standard_deviation = kwargs.pop('std', None)

        if kwargs:
            raise TypeError(f"Unexpected **kwargs: {list(kwargs.keys())}")

    def __repr__(self):
        return (f"{self.__class__.__name__}: {self.name}\n\n"
                f"{self.shape[0]} sources; {self.shape[1]} receivers; "
                f"{self.shape[2]} frequencies")

    # -- data -----------------------------------------------------------

    @property
    def data(self):
        """DataView with at least the `observed` array."""
        return self._data

    @property
    def shape(self):
        return self.data.observed.shape

    @property
    def size(self):
        """Number of actual (non-NaN) data points."""
        return int(np.count_nonzero(~np.isnan(self.data.observed)))

    @property
    def observed(self):
        return self.data.observed

    @observed.setter
    def observed(self, observed):
        self._data['observed'] = np.asarray(observed).reshape(self.shape)

    # -- noise description (reference parity: surveys.py:553-707) -------

    @property
    def standard_deviation(self):
        if 'std' in self._data:
            return self._data['std']
        if self.noise_floor is not None or self.relative_error is not None:
            std = np.zeros(self.shape)
            if self.noise_floor is not None:
                std = std + np.asarray(self.noise_floor)**2
            if self.relative_error is not None:
                std = std + np.abs(
                    np.asarray(self.relative_error) *
                    self.data.observed)**2
            return np.sqrt(std)
        return None

    @standard_deviation.setter
    def standard_deviation(self, std):
        if std is None:
            self._data.pop('std', None)
        else:
            std = np.asarray(std) * np.ones(self.shape)
            if np.any(std <= 0.0):
                raise ValueError(
                    "All values of `std` must be bigger than zero.")
            self._data['std'] = std

    @property
    def noise_floor(self):
        return self._attrs.get('noise_floor')

    @noise_floor.setter
    def noise_floor(self, noise_floor):
        self._check_noise(noise_floor, 'noise_floor')
        self._attrs['noise_floor'] = noise_floor

    @property
    def relative_error(self):
        return self._attrs.get('relative_error')

    @relative_error.setter
    def relative_error(self, relative_error):
        self._check_noise(relative_error, 'relative_error')
        self._attrs['relative_error'] = relative_error

    def _check_noise(self, value, name):
        if value is None:
            return
        if np.any(np.asarray(value) <= 0.0):
            raise ValueError(
                f"All values of `{name}` must be bigger than zero.")
        try:
            _ = np.ones(self.shape) * np.asarray(value)
        except ValueError as e:
            raise ValueError(
                f"Shape of `{name}` is not broadcastable to data.\n"
                f"Shape of `{name}`: {np.shape(value)}; "
                f"`data`: {self.shape}.") from e

    # -- geometry -------------------------------------------------------

    @property
    def sources(self):
        return self._sources

    @property
    def receivers(self):
        return self._receivers

    @property
    def frequencies(self):
        return self._frequencies

    @property
    def src_coords(self):
        return tuple(np.array(
            [[s.xco, s.yco, s.zco, s.azm, s.dip]
             for s in self.sources.values()]).T)

    @property
    def rec_coords(self):
        if self.fixed:
            coords = {}
            for src in self.sources.keys():
                coords[src] = tuple(np.array(
                    [[self.receivers[off][src].xco,
                      self.receivers[off][src].yco,
                      self.receivers[off][src].zco,
                      self.receivers[off][src].azm,
                      self.receivers[off][src].dip]
                     for off in self.receivers.keys()]).T)
            return coords
        return tuple(np.array(
            [[r.xco, r.yco, r.zco, r.azm, r.dip]
             for r in self.receivers.values()]).T)

    @property
    def rec_types(self):
        if self.fixed:
            return {src: tuple(self.receivers[off][src].electric
                               for off in list(self.receivers))
                    for src in self.sources.keys()}
        return tuple(r.electric for r in self.receivers.values())

    # -- selection ------------------------------------------------------

    def select(self, sources=None, receivers=None, frequencies=None):
        """Return a sub-survey with selected src/rec/freq.

        Reference parity: emg3d/surveys.py:375-446.
        """
        survey = self.to_dict()
        isrc, irec, ifreq = slice(None), slice(None), slice(None)

        noise_floor = np.atleast_3d(self.noise_floor) \
            if self.noise_floor is not None else None
        relative_error = np.atleast_3d(self.relative_error) \
            if self.relative_error is not None else None

        def _sub(arr, idx, axis):
            if arr is None or arr.shape[axis] <= 1:
                return arr
            return np.take(arr, idx, axis=axis)

        if sources is not None:
            if isinstance(sources, str):
                sources = [sources]
            isrc = [list(self.sources).index(s) for s in sources]
            survey['sources'] = {s: survey['sources'][s] for s in sources}
            noise_floor = _sub(noise_floor, isrc, 0)
            relative_error = _sub(relative_error, isrc, 0)

        if receivers is not None:
            if isinstance(receivers, str):
                receivers = [receivers]
            irec = [list(self.receivers).index(r) for r in receivers]
            survey['receivers'] = {
                r: survey['receivers'][r] for r in receivers}
            noise_floor = _sub(noise_floor, irec, 1)
            relative_error = _sub(relative_error, irec, 1)

        if frequencies is not None:
            ifreq = np.isin(self.frequencies, frequencies)
            survey['frequencies'] = self.frequencies[ifreq]
            noise_floor = _sub(noise_floor, np.where(ifreq)[0], 2)
            relative_error = _sub(relative_error, np.where(ifreq)[0], 2)

        for key in survey['data'].keys():
            data = self.data[key][isrc, :, :][:, irec, :][:, :, ifreq]
            survey['data'][key] = data
        survey['noise_floor'] = noise_floor
        survey['relative_error'] = relative_error
        return Survey.from_dict(survey)

    # -- serialization --------------------------------------------------

    def copy(self):
        return Survey.from_dict(self.to_dict(copy=True))

    def to_dict(self, copy=False):
        if self.fixed:
            receivers = {k: {k2: v2.to_dict() for k2, v2 in v.items()}
                         for k, v in self.receivers.items()}
        else:
            receivers = {k: v.to_dict() for k, v in
                         self.receivers.items()}
        out = {
            'name': self.name,
            'sources': {k: v.to_dict() for k, v in self.sources.items()},
            'receivers': receivers,
            'frequencies': self.frequencies,
            'fixed': int(self.fixed),
            'data': {k: np.asarray(v) for k, v in self._data.items()},
            'noise_floor': self.noise_floor,
            'relative_error': self.relative_error,
            '__class__': self.__class__.__name__,
        }
        if copy:
            return deepcopy(out)
        return out

    @classmethod
    def from_dict(cls, inp):
        try:
            data = inp.get('data', None)
            observed = None
            if data is not None and 'observed' in data:
                observed = np.asarray(data['observed'])
            nf = inp.get('noise_floor', None)
            re_ = inp.get('relative_error', None)
            if isinstance(nf, str):
                nf = None
            if isinstance(re_, str):
                re_ = None
            out = cls(name=str(inp['name']), sources=inp['sources'],
                      receivers=inp['receivers'],
                      frequencies=inp['frequencies'], data=observed,
                      fixed=bool(inp.get('fixed', 0)),
                      noise_floor=nf, relative_error=re_)
            if data is not None:
                for k, v in data.items():
                    if k != 'observed':
                        out._data[k] = np.asarray(v)
            return out
        except KeyError as e:
            raise KeyError(f"Variable {e} missing in `inp`.") from e

    def to_file(self, fname, name='survey', **kwargs):
        """Save survey to file (h5/npz/json via emg3d_tpu_torch.io)."""
        from . import io
        kwargs[name] = self
        kwargs['collect_classes'] = False
        io.save(fname, **kwargs)

    @classmethod
    def from_file(cls, fname, name='survey', **kwargs):
        from . import io
        return io.load(fname, **kwargs)[name]

    # -- dipole parsing (reference parity: surveys.py:709-821) ----------

    def _dipole_info_to_dict(self, inp, name):
        """Normalize sources/receivers input to the survey dict layout.

        Accepted forms: a flat list of Dipoles, a tuple of coordinate
        arrays (broadcast columns, optional trailing electric/magnetic
        flags), or an (optionally nested) dict of Dipoles /
        serialized dipole dicts.  Fixed surveys group receivers by
        offset: the flat order is offset-major over the sources.
        """
        grouped = self.fixed and name == 'receiver'

        if isinstance(inp, dict):
            def thaw(v):
                return v if isinstance(v, Dipole) \
                    else Dipole.from_dict(v)

            if grouped:
                return {off: {src: thaw(d) for src, d in by_src.items()}
                        for off, by_src in inp.items()}
            return {key: thaw(v) for key, v in inp.items()}

        if isinstance(inp, tuple):
            dipoles = self._dipoles_from_coordinates(inp, name)
        elif isinstance(inp, list):
            dipoles = inp
        else:
            raise TypeError(f"Input format of <{name}s> not "
                            f"recognized: {type(inp)}.")

        if grouped:
            return self._group_by_offset(dipoles)
        out = {d.name: d for d in dipoles}
        if len(out) != len(dipoles):
            raise ValueError(
                f"There are duplicate {name} names.\n"
                f"Provided {name}s: {len(dipoles)}; "
                f"unique names: {len(out)}.")
        return out

    @staticmethod
    def _dipoles_from_coordinates(inp, name):
        """Tuple of coordinate arrays -> flat list of auto-named
        Dipoles.  Scalars broadcast over the longest entry; a trailing
        boolean entry provides per-dipole electric/magnetic flags."""
        has_flags = isinstance(np.asarray(inp[-1]).ravel()[0],
                               (bool, np.bool_))
        coords, flags = (inp[:-1], inp[-1]) if has_flags \
            else (inp, True)

        nd = max(np.size(v) for v in inp)
        cols = np.vstack([np.broadcast_to(
            np.asarray(v, dtype=np.float64).ravel(), (nd,))
            for v in coords])
        electric = np.broadcast_to(np.asarray(flags).ravel(), (nd,))

        prefix = 'Tx' if name == 'source' else 'Rx'
        width = len(str(nd - 1))
        return [Dipole(f"{prefix}{i:0{width}d}", cols[:, i],
                       bool(electric[i])) for i in range(nd)]

    def _group_by_offset(self, dipoles):
        """Fixed-survey receivers: the i-th block of len(sources)
        entries holds offset i's receiver for each source, in the
        sources' order."""
        ns = len(self.sources)
        nd = len(dipoles)
        if nd % ns:
            raise ValueError(
                "For fixed surveys, the number of receivers\n"
                "must be a multiple of number of sources.\n"
                f"Provided: #src: {ns}; #rec: {nd}.")
        width = len(str(nd // ns - 1))
        src_names = list(self.sources)
        return {f"Off{j:0{width}d}":
                {src: dipoles[j * ns + i]
                 for i, src in enumerate(src_names)}
                for j in range(nd // ns)}


@dataclass(order=True, unsafe_hash=True)
class PointDipole:
    """Infinitesimal point dipole.

    Reference parity: emg3d/surveys.py:825-861.
    """
    name: str
    xco: float
    yco: float
    zco: float
    azm: float
    dip: float
    electric: bool


class Dipole(PointDipole):
    """Point or finite-length dipole.

    coordinates: ``(x, y, z, azimuth, dip)`` (point) or
    ``(x0, x1, y0, y1, z0, z1)`` (finite length).

    Reference parity: emg3d/surveys.py:864-1051.
    """

    def __init__(self, name, coordinates, electric=True, **kwargs):
        self._strength = float(kwargs.pop('strength', 0.0))
        if kwargs:
            raise TypeError(f"Unexpected **kwargs: {list(kwargs.keys())}")

        coordinates = np.asarray(coordinates, dtype=np.float64).ravel()

        try:
            if coordinates.size == 5:
                self.is_finite = False
                xco, yco, zco = coordinates[:3]
                azm, dip = coordinates[3:]
            elif coordinates.size == 6:
                if np.allclose(coordinates[::2], coordinates[1::2]):
                    raise ValueError(
                        "The two electrode positions of a finite dipole "
                        f"must differ. Provided: {coordinates}.")
                self.is_finite = True
                self.electrode1 = tuple(coordinates[::2])
                self.electrode2 = tuple(coordinates[1::2])
                center = tuple((coordinates[1::2] + coordinates[::2]) / 2)
                dx, dy, dz = coordinates[1::2] - coordinates[::2]
                length = np.linalg.norm([dx, dy, dz])
                azm = np.rad2deg(np.arctan2(dy, dx))
                dip = np.rad2deg(np.pi / 2 - np.arccos(dz / length))
                self.length = length
                xco, yco, zco = center
            else:
                raise ValueError(
                    "Dipole coordinates are wrong defined. They must be\n"
                    "defined either as a point, (x, y, z, azimuth, dip),\n"
                    "or as two poles, (x0, x1, y0, y1, z0, z1), all "
                    "floats.\nIn the latter, pole0 != pole1.\n"
                    f"Provided coordinates: {coordinates}.")
        except (ValueError, IndexError) as e:
            if 'wrong defined' in str(e) or 'must differ' in str(e):
                raise
            raise ValueError(
                "Dipole coordinates are wrong defined. They must be\n"
                "defined either as a point, (x, y, z, azimuth, dip),\n"
                "or as two poles, (x0, x1, y0, y1, z0, z1), all floats."
                f"\nProvided coordinates: {coordinates}.") from e

        if not self.is_finite:
            self.length = 1.0
            rot = np.array([
                np.cos(np.deg2rad(azm)) * np.cos(np.deg2rad(dip)),
                np.sin(np.deg2rad(azm)) * np.cos(np.deg2rad(dip)),
                np.sin(np.deg2rad(dip))]) / 2
            self.electrode1 = tuple(np.array([xco, yco, zco]) - rot)
            self.electrode2 = tuple(np.array([xco, yco, zco]) + rot)

        super().__init__(name, float(xco), float(yco), float(zco),
                         float(azm), float(dip), bool(electric))

    @property
    def strength(self):
        return self._strength

    @property
    def coordinates(self):
        """(x, y, z, azm, dip) for points; electrode pairs if finite."""
        if self.is_finite:
            e1, e2 = self.electrode1, self.electrode2
            return np.array([e1[0], e2[0], e1[1], e2[1], e1[2], e2[2]])
        return np.array([self.xco, self.yco, self.zco, self.azm,
                         self.dip])

    def __repr__(self):
        return (f"Dipole({self.name}, "
                f"{{{self.xco:,.1f}m; {self.yco:,.1f}m; "
                f"{self.zco:,.1f}m}}, θ={self.azm:.1f}°, "
                f"φ={self.dip:.1f}°, l={self.length:,.1f}m)")

    def copy(self):
        return Dipole.from_dict(self.to_dict(copy=True))

    def to_dict(self, copy=False):
        out = {
            'name': self.name,
            'coordinates': self.coordinates,
            'electric': self.electric,
            'strength': self._strength,
            '__class__': self.__class__.__name__,
        }
        if copy:
            return deepcopy(out)
        return out

    @classmethod
    def from_dict(cls, inp):
        try:
            kwargs = {k: v for k, v in inp.items() if k != '__class__'}
            return cls(**kwargs)
        except KeyError as e:
            raise KeyError(f"Variable {e} missing in `inp`.") from e
