"""Resistivity/conductivity models with tri-axial electrical anisotropy.

Copy of ``emg3d_tpu/models.py`` (numpy/scipy only), the counterpart
of the reference's model layer (emg3d/models.py).  ``Model`` is
host-side (numpy): validation, mapping, regridding.  ``VolumeModel``
produces the volume-scaled solver parameters η and ζ on the host;
``DeviceVolumeModel`` computes the same η and ζ on a torch device from
one copy of the model's properties (the single solve's set-up).

Anisotropy cases (reference parity, models.py:115-128):
0 = isotropic, 1 = HTI (x ≠ y = z ... property_x/property_y),
2 = VTI (property_x/property_z), 3 = tri-axial.
"""
import numpy as np
import torch
from scipy.constants import epsilon_0

from . import maps as _maps
from . import trace
from .dtypes import REAL_OF

__all__ = ['Model', 'VolumeModel', 'DeviceVolumeModel']


class Model:
    """A model of electrical properties on a tensor mesh.

    Parameters
    ----------
    grid : TensorMesh
    property_x, property_y, property_z : float or ndarray, optional
        Material property in x/y/z (interpretation set by ``mapping``).
    mu_r : None, float or ndarray
        Relative magnetic permeability (isotropic).
    epsilon_r : None, float or ndarray
        Relative electric permittivity (isotropic).
    mapping : str
        One of {'Conductivity', 'LgConductivity', 'LnConductivity',
        'Resistivity', 'LgResistivity', 'LnResistivity'}.

    Reference parity: emg3d/models.py:31-551.
    """

    def __init__(self, grid, property_x=1., property_y=None, property_z=None,
                 mu_r=None, epsilon_r=None, mapping='Resistivity', **kwargs):
        if kwargs:
            raise TypeError(f"Unexpected **kwargs: {list(kwargs.keys())}")

        self.grid = grid
        self.shape_cells = tuple(grid.shape_cells)
        self.n_cells = grid.n_cells

        if mapping not in _maps.MAPLIST:
            raise ValueError(
                f"Unknown mapping: {mapping}; "
                f"use one of: {tuple(_maps.MAPLIST.keys())}.")
        self.map = _maps.MAPLIST[mapping]()

        # Check case.
        if property_y is None and property_z is None:
            self.case = 0      # Isotropic.
        elif property_z is None:
            self.case = 1      # HTI.
        elif property_y is None:
            self.case = 2      # VTI.
        else:
            self.case = 3      # Tri-axial.

        self._property_x = self._check_parameter(property_x, 'property_x')
        self._property_y = (self._check_parameter(property_y, 'property_y')
                            if self.case in [1, 3] else None)
        self._property_z = (self._check_parameter(property_z, 'property_z')
                            if self.case in [2, 3] else None)
        self._mu_r = self._check_parameter(mu_r, 'mu_r', none_ok=True)
        self._epsilon_r = self._check_parameter(epsilon_r, 'epsilon_r',
                                                none_ok=True)

    def _check_parameter(self, var, name, none_ok=False):
        """Validate a property: positive, finite, broadcastable shape."""
        if var is None:
            if none_ok:
                return None
            raise ValueError(f"{name} cannot be None.")

        var = np.asarray(var, dtype=np.float64)
        if var.size == 1:
            var = np.full(self.shape_cells, var.item())
        elif var.size == self.n_cells:
            var = var.reshape(self.shape_cells, order='F') \
                if var.ndim == 1 else var.reshape(self.shape_cells)
        else:
            raise ValueError(
                f"Shape of {name} must be (), ({self.n_cells},), or "
                f"{self.shape_cells}; provided: {var.shape}.")

        # Mapped (log) spaces may be negative; linear spaces must be > 0.
        if self.map.name in ['Conductivity', 'Resistivity'] or \
                name in ['mu_r', 'epsilon_r']:
            if not np.all(var > 0) or not np.all(np.isfinite(var)):
                raise ValueError(
                    f"`{name}` must be all bigger than zero and finite.")
        else:
            if not np.all(np.isfinite(var)):
                raise ValueError(f"`{name}` must be finite.")
        return var

    # -- properties ------------------------------------------------------

    @property
    def property_x(self):
        return self._property_x

    @property_x.setter
    def property_x(self, value):
        self._property_x = self._check_parameter(value, 'property_x')

    @property
    def property_y(self):
        return (self._property_y if self.case in [1, 3]
                else self._property_x)

    @property_y.setter
    def property_y(self, value):
        if self.case not in [1, 3]:
            raise ValueError(
                "Model was initiated without `property_y`.")
        self._property_y = self._check_parameter(value, 'property_y')

    @property
    def property_z(self):
        return (self._property_z if self.case in [2, 3]
                else self._property_x)

    @property_z.setter
    def property_z(self, value):
        if self.case not in [2, 3]:
            raise ValueError(
                "Model was initiated without `property_z`.")
        self._property_z = self._check_parameter(value, 'property_z')

    @property
    def mu_r(self):
        return self._mu_r

    @property
    def epsilon_r(self):
        return self._epsilon_r

    # -- operators -------------------------------------------------------

    def _operator(self, other, op):
        if not self._consistent(other):
            raise ValueError("Models must be consistent (case, mapping, "
                             "shape, mu_r/epsilon_r) for arithmetic.")
        kw = {}
        kw['property_x'] = op(self._property_x, other._property_x)
        if self.case in [1, 3]:
            kw['property_y'] = op(self._property_y, other._property_y)
        if self.case in [2, 3]:
            kw['property_z'] = op(self._property_z, other._property_z)
        if self._mu_r is not None:
            kw['mu_r'] = self._mu_r
        if self._epsilon_r is not None:
            kw['epsilon_r'] = self._epsilon_r
        return Model(self.grid, mapping=self.map.name, **kw)

    def _consistent(self, other):
        if not isinstance(other, Model):
            return False
        same = (self.case == other.case and
                self.map.name == other.map.name and
                self.shape_cells == other.shape_cells)
        same = same and ((self._mu_r is None) == (other._mu_r is None))
        same = same and ((self._epsilon_r is None) ==
                         (other._epsilon_r is None))
        return same

    def __add__(self, other):
        return self._operator(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._operator(other, lambda a, b: a - b)

    def __eq__(self, other):
        if not isinstance(other, Model):
            return NotImplemented
        if not self._consistent(other):
            return False
        eq = np.allclose(self.property_x, other.property_x)
        eq = eq and np.allclose(self.property_y, other.property_y)
        eq = eq and np.allclose(self.property_z, other.property_z)
        if self._mu_r is not None:
            eq = eq and np.allclose(self._mu_r, other._mu_r)
        if self._epsilon_r is not None:
            eq = eq and np.allclose(self._epsilon_r, other._epsilon_r)
        return eq

    def copy(self):
        return Model.from_dict(self.to_dict(copy=True))

    # -- regridding ------------------------------------------------------

    def interpolate2grid(self, grid, new_grid, **grid2grid_opts):
        """Volume-average (conservative) regrid onto ``new_grid``.

        Reference parity: emg3d/models.py:364-433.
        """
        # Log-space averaging for linear (non-log) maps; mapped (log)
        # properties are averaged linearly in mapped space.
        opts = {'method': 'volume', 'extrapolate': True,
                'log': not self.map.name.startswith('L')}
        opts.update(grid2grid_opts)

        def ensure_vnc(prop):
            return (prop * np.ones(self.shape_cells)
                    if np.asarray(prop).size == 1 else prop)

        kw = {}
        kw['property_x'] = _maps.grid2grid(
            grid, self.property_x, new_grid, **opts)
        if self.case in [1, 3]:
            kw['property_y'] = _maps.grid2grid(
                grid, self.property_y, new_grid, **opts)
        if self.case in [2, 3]:
            kw['property_z'] = _maps.grid2grid(
                grid, self.property_z, new_grid, **opts)
        if self._mu_r is not None:
            kw['mu_r'] = _maps.grid2grid(grid, self._mu_r, new_grid, **opts)
        if self._epsilon_r is not None:
            kw['epsilon_r'] = _maps.grid2grid(
                grid, self._epsilon_r, new_grid, **opts)
        return Model(new_grid, mapping=self.map.name, **kw)

    # -- serialization ---------------------------------------------------

    def to_dict(self, copy=False):
        out = {
            'property_x': self.property_x,
            'property_y': self._property_y,
            'property_z': self._property_z,
            'mu_r': self._mu_r,
            'epsilon_r': self._epsilon_r,
            'vnC': self.shape_cells,
            'mapping': self.map.name,
            'grid': self.grid.to_dict() if self.grid is not None else None,
            '__class__': self.__class__.__name__,
        }
        if copy:
            import copy as _copy
            out = _copy.deepcopy(out)
        return out

    @classmethod
    def from_dict(cls, inp):
        from .meshes import TensorMesh
        try:
            grid_inp = inp.get('grid', None)
            if isinstance(grid_inp, TensorMesh):
                grid = grid_inp
            elif grid_inp is not None and not isinstance(grid_inp, str):
                grid = TensorMesh.from_dict(grid_inp)
            else:
                # Rebuild a unit-width placeholder mesh from vnC.
                vnC = tuple(np.asarray(inp['vnC'], dtype=int))
                grid = TensorMesh([np.ones(n) for n in vnC])
            return cls(grid,
                       property_x=inp['property_x'],
                       property_y=inp.get('property_y'),
                       property_z=inp.get('property_z'),
                       mu_r=inp.get('mu_r'),
                       epsilon_r=inp.get('epsilon_r'),
                       mapping=str(inp.get('mapping', 'Resistivity')))
        except KeyError as e:
            raise KeyError(f"Variable {e} missing in `inp`.") from e

    def __repr__(self):
        return (f"Model [{self.map.description}]; "
                f"{['isotropic', 'HTI', 'VTI', 'tri-axial'][self.case]}"
                f"; {self.shape_cells}")


class VolumeModel:
    """Volume-scaled frequency-dependent solver parameters η and ζ.

    η_v = s·μ0·V·(σ_v − s·ε0·εr),   ζ = V/μr

    Reference parity: emg3d/models.py:554-658.
    """

    def __init__(self, grid, model, sfield):
        self.case = model.case
        vol = np.asarray(grid.cell_volumes)

        self._eta_x = self._calculate_eta('property_x', vol, model, sfield)
        self._eta_y = (self._calculate_eta('property_y', vol, model, sfield)
                       if model.case in [1, 3] else None)
        self._eta_z = (self._calculate_eta('property_z', vol, model, sfield)
                       if model.case in [2, 3] else None)

        if model.mu_r is None:
            self._zeta = vol.copy()
        else:
            self._zeta = vol / model.mu_r

    @property
    def eta_x(self):
        return self._eta_x

    @property
    def eta_y(self):
        return self._eta_y if self.case in [1, 3] else self._eta_x

    @property
    def eta_z(self):
        return self._eta_z if self.case in [2, 3] else self._eta_x

    @property
    def zeta(self):
        return self._zeta

    @staticmethod
    def _calculate_eta(name, vol, model, field):
        cond = model.map.backward(getattr(model, name))
        if model.epsilon_r is None:
            return field.smu0 * vol * cond
        eps_term = field.sval * epsilon_0 * model.epsilon_r
        return field.smu0 * vol * (cond - eps_term)


# Each map's ``backward`` in torch: the same expressions as maps.py.
_BACKWARD = {
    'Conductivity': lambda x: x,
    'Resistivity': lambda x: 1.0 / x,
    'LgConductivity': lambda x: torch.pow(10.0, x),
    'LgResistivity': lambda x: torch.pow(10.0, -x),
    'LnConductivity': torch.exp,
    'LnResistivity': lambda x: torch.exp(-x),
}


class DeviceVolumeModel:
    """:class:`VolumeModel`'s η and ζ, computed on a torch ``device``.

    The model's property arrays, and μr and εr where given, are copied
    to ``device`` once as float64; the map's ``backward``, the cell
    volumes (from the widths, in :attr:`.TensorMesh.cell_volumes`'
    order) and η, ζ are computed there by VolumeModel's expressions in
    float64/complex128, then rounded once to the complex ``dtype`` (ζ
    to its real dtype); a Laplace-domain η is promoted to complex with
    an imaginary part of exact zeros.  ``eta_y``/``eta_z`` are
    ``eta_x`` where the model has no own property for them.  Nothing
    else stays on the device.
    """

    def __init__(self, grid, model, sfield, device,
                 dtype=torch.complex128):
        self.case = model.case

        def put(a):
            t = torch.tensor(np.ascontiguousarray(a), dtype=torch.float64,
                             device=device)
            trace.count('copy.h2d_bytes', trace.nbytes((t,)))
            return t

        hx, hy, hz = (put(np.asarray(h, dtype=np.float64)) for h in grid.h)
        vol = (hx[:, None, None] * hy[None, :, None]) * hz[None, None, :]
        backward = _BACKWARD[model.map.name]
        # Python scalars: a numpy scalar would take the tensor as an array.
        smu0 = sfield.smu0
        smu0 = complex(smu0) if np.iscomplexobj(smu0) else float(smu0)
        svol = smu0 * vol
        eps_term = None
        if model.epsilon_r is not None:
            seps = sfield.sval * epsilon_0
            seps = complex(seps) if np.iscomplexobj(seps) else float(seps)
            eps_term = seps * put(model.epsilon_r)

        def eta(name):
            cond = backward(put(getattr(model, name)))
            if eps_term is not None:
                cond = cond - eps_term
            return (svol * cond).to(dtype).contiguous()

        self._eta_x = eta('property_x')
        self._eta_y = eta('property_y') if model.case in [1, 3] else None
        self._eta_z = eta('property_z') if model.case in [2, 3] else None
        zeta = vol if model.mu_r is None else vol / put(model.mu_r)
        self._zeta = zeta.to(REAL_OF[dtype]).contiguous()

    eta_x = VolumeModel.eta_x
    eta_y = VolumeModel.eta_y
    eta_z = VolumeModel.eta_z
    zeta = VolumeModel.zeta
