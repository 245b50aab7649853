"""Tensor meshes (staggered Yee grids) — host-side geometry.

Copy of ``emg3d_tpu/meshes.py`` (numpy only), the counterpart of the
reference's mesh layer (emg3d/meshes.py:66-275).  The mesh is pure host-side
numpy metadata: cell widths and origin plus derived node/center/edge
bookkeeping.  Device code (the solver) only ever consumes plain arrays
drawn from here (``h``, volumes, transfer-operator matrices), so the mesh
itself is deliberately *not* a pytree.

Key differences from the reference:

- No ``discretize`` dependency or fallback split: one class provides the
  full (relevant) attribute surface of both.
- Arrays derived lazily and cached; the object is immutable by convention.
"""
import numpy as np

__all__ = [
    'TensorMesh', 'construct_mesh', 'origin_and_widths', 'good_mg_cell_nr',
    'skin_depth', 'wavelength', 'cell_width', 'check_mesh',
]


class TensorMesh:
    """A 3-D tensor-product (rectilinear) mesh.

    Parameters
    ----------
    h : sequence of three ndarrays
        Cell widths ``[hx, hy, hz]``.
    origin : array_like of 3 floats
        Coordinates of the bottom-south-west corner (x0, y0, z0).

    Reference parity: emg3d/meshes.py:66-275 (_TensorMesh/TensorMesh).
    """

    def __init__(self, h, origin=(0., 0., 0.)):
        self.h = [np.asarray(hh, dtype=np.float64).ravel() for hh in h]
        if len(self.h) != 3 or any(len(hh) < 1 for hh in self.h):
            raise ValueError("h must contain three width-arrays.")
        if any(np.any(hh <= 0) for hh in self.h):
            raise ValueError("All cell widths must be positive.")
        self.origin = np.asarray(origin, dtype=np.float64).ravel()
        if self.origin.size != 3:
            raise ValueError("origin must have three entries.")

        # Cell counts.
        self.shape_cells = tuple(int(len(hh)) for hh in self.h)
        self.shape_nodes = tuple(n + 1 for n in self.shape_cells)
        nx, ny, nz = self.shape_cells

        # Edge counts (x-edges: (nx, ny+1, nz+1), etc.).
        self.shape_edges_x = (nx, ny + 1, nz + 1)
        self.shape_edges_y = (nx + 1, ny, nz + 1)
        self.shape_edges_z = (nx + 1, ny + 1, nz)
        self.n_cells = nx * ny * nz
        self.n_nodes = (nx + 1) * (ny + 1) * (nz + 1)
        self.n_edges_x = int(np.prod(self.shape_edges_x))
        self.n_edges_y = int(np.prod(self.shape_edges_y))
        self.n_edges_z = int(np.prod(self.shape_edges_z))
        self.n_edges = self.n_edges_x + self.n_edges_y + self.n_edges_z

        self._cache = {}

    # -- Node / center vectors ------------------------------------------

    @property
    def nodes_x(self):
        return self._cached('nodes_x', lambda: np.r_[0., np.cumsum(self.h[0])]
                            + self.origin[0])

    @property
    def nodes_y(self):
        return self._cached('nodes_y', lambda: np.r_[0., np.cumsum(self.h[1])]
                            + self.origin[1])

    @property
    def nodes_z(self):
        return self._cached('nodes_z', lambda: np.r_[0., np.cumsum(self.h[2])]
                            + self.origin[2])

    @property
    def cell_centers_x(self):
        return self._cached(
            'cell_centers_x', lambda: (self.nodes_x[:-1] + self.nodes_x[1:])/2)

    @property
    def cell_centers_y(self):
        return self._cached(
            'cell_centers_y', lambda: (self.nodes_y[:-1] + self.nodes_y[1:])/2)

    @property
    def cell_centers_z(self):
        return self._cached(
            'cell_centers_z', lambda: (self.nodes_z[:-1] + self.nodes_z[1:])/2)

    @property
    def cell_volumes(self):
        """Cell volumes, shape (nx, ny, nz) (C-order 3-D array)."""
        def _vol():
            hx, hy, hz = self.h
            return (hx[:, None, None] * hy[None, :, None] * hz[None, None, :])
        return self._cached('cell_volumes', _vol)

    def _cached(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    # -- Short aliases (reference/discretize style) ---------------------

    @property
    def vnC(self):
        return self.shape_cells

    @property
    def nC(self):
        return self.n_cells

    @property
    def vnN(self):
        return self.shape_nodes

    @property
    def vnEx(self):
        return self.shape_edges_x

    @property
    def vnEy(self):
        return self.shape_edges_y

    @property
    def vnEz(self):
        return self.shape_edges_z

    @property
    def nEx(self):
        return self.n_edges_x

    @property
    def nEy(self):
        return self.n_edges_y

    @property
    def nEz(self):
        return self.n_edges_z

    @property
    def nE(self):
        return self.n_edges

    # -- Housekeeping ----------------------------------------------------

    def __eq__(self, other):
        if not isinstance(other, TensorMesh):
            return NotImplemented
        return (self.shape_cells == other.shape_cells and
                np.allclose(self.origin, other.origin) and
                all(np.allclose(a, b) for a, b in zip(self.h, other.h)))

    def __hash__(self):
        return hash((self.shape_cells,
                     tuple(self.origin),
                     tuple(tuple(hh) for hh in self.h)))

    def __repr__(self):
        nx, ny, nz = self.shape_cells
        return (f"TensorMesh: {nx:,} x {ny:,} x {nz:,} "
                f"({self.n_cells:,} cells)")

    def copy(self):
        return TensorMesh.from_dict(self.to_dict())

    def to_dict(self, copy=False):
        out = {
            'hx': np.array(self.h[0]), 'hy': np.array(self.h[1]),
            'hz': np.array(self.h[2]), 'origin': np.array(self.origin),
            '__class__': self.__class__.__name__,
        }
        return out

    @classmethod
    def from_dict(cls, inp):
        inp = {k: v for k, v in inp.items() if k != '__class__'}
        try:
            return cls(h=[inp['hx'], inp['hy'], inp['hz']],
                       origin=inp['origin'])
        except KeyError as e:
            raise KeyError(f"Variable {e} missing in `inp`.") from e


# ----------------------------------------------------------------------
# Automatic mesh construction helpers
# (reference parity: emg3d/meshes.py:867-1042).
# ----------------------------------------------------------------------

def good_mg_cell_nr(max_nr=1024, max_prime=5, min_div=3):
    """Cell numbers p·2^n (p prime ≤ max_prime, n ≥ min_div) good for MG.

    Reference parity: emg3d/meshes.py:867-920.
    """
    if max_prime not in [2, 3, 5, 7, 11, 13]:
        raise ValueError(f"max_prime must be a prime <= 13; "
                         f"provided: {max_prime}.")
    primes = np.array([p for p in [2, 3, 5, 7, 11, 13] if p <= max_prime])
    numbers = []
    for p in primes:
        n = min_div
        while p * 2**n <= max_nr:
            numbers.append(p * 2**n)
            n += 1
    return np.unique(numbers)


def skin_depth(frequency, conductivity, mu_r=1.0):
    """Skin depth δ = 1/sqrt(π f μ σ)  [m].

    For Laplace-domain (negative) frequency s=f the factor πf is replaced
    by |f|/2.  Reference parity: emg3d/meshes.py:923-976.
    """
    mu = mu_r * 4e-7 * np.pi
    if frequency < 0:  # Laplace domain.
        return 1 / np.sqrt(-frequency / 2 * mu * conductivity)
    return 1 / np.sqrt(np.pi * frequency * mu * conductivity)


def wavelength(sdepth):
    """Wavelength λ = 2π δ [m].  Reference: emg3d/meshes.py:979-1004."""
    return 2 * np.pi * sdepth


def cell_width(sdepth, pps=3, limits=None):
    """Minimum cell width Δ = δ/pps, clipped to limits.

    Reference parity: emg3d/meshes.py:1007-1042 (min_cell_width).
    """
    dmin = sdepth / pps
    if limits is None:
        return dmin
    limits = np.atleast_1d(np.asarray(limits, dtype=float))
    if limits.size == 1:
        return float(limits[0])
    return float(np.clip(dmin, limits[0], limits[1]))


# Backwards-compatible alias matching the reference name.
min_cell_width = cell_width


def check_mesh(mesh):
    """Warn if the mesh is not good for multigrid (non 2^n-divisible)."""
    import warnings
    good = good_mg_cell_nr()
    for i, n in enumerate(mesh.shape_cells):
        if n not in good:
            warnings.warn(
                f"Mesh dimension {i} has {n} cells, which is not an "
                "optimal number for multigrid (p*2^n; p in {2,3,5,7}).",
                UserWarning)
            break


def origin_and_widths(frequency, properties, center, domain=None,
                      vector=None, seasurface=None, **kwargs):
    """Compute origin and cell widths for one direction.

    Frequency- and property-aware 1-D gridding with the reference's
    search semantics (emg3d/meshes.py:578-864): the survey domain (DS)
    fills with minimum-width cells grown geometrically from the center
    (stretching ``sa``), buffers (to the computation domain DC) grow
    from the DS edge widths (stretching ``ca`` ≥ sa), and the search
    returns the FIRST feasible grid scanning cell counts ascending and
    both stretchings in 0.01 steps — i.e., the cell-count-minimizing,
    least-stretched grid.  Leftover cells extend the buffers
    symmetrically (extra one to the right).

    ``verb=1`` prints the per-direction info block, ``verb=-1`` returns
    it: skin depths, DS/DC extents, final extent, width extrema, cell
    split and stretching summary.

    Returns ``(origin, widths)`` — plus ``info`` if verb<0 — or Nones
    if no grid within ``cell_numbers`` satisfies the constraints (when
    raise_error=False).
    """
    from . import maps as _maps

    distance = kwargs.pop('distance', None)
    stretching = kwargs.pop('stretching', (1.0, 1.5))
    min_width_limits = kwargs.pop('min_width_limits', None)
    min_width_pps = kwargs.pop('min_width_pps', 3)
    lambda_factor = kwargs.pop('lambda_factor', 1.0)
    max_buffer = kwargs.pop('max_buffer', 100000.0)
    lambda_from_center = kwargs.pop('lambda_from_center', False)
    mapping = kwargs.pop('mapping', 'Resistivity')
    cell_numbers = kwargs.pop('cell_numbers', None)
    raise_error = kwargs.pop('raise_error', True)
    verb = kwargs.pop('verb', 0)
    if kwargs:
        raise TypeError(f"Unexpected **kwargs: {list(kwargs.keys())}")

    # Properties -> conductivities -> (center, negative, positive) skin
    # depths; a short property list repeats its last entries.
    properties = np.atleast_1d(np.asarray(properties, dtype=float))
    pmap = (getattr(_maps, 'Map' + mapping)()
            if isinstance(mapping, str) else mapping)
    cond = pmap.backward(properties)
    trip = [cond[0], cond[min(cond.size - 1, 1)],
            cond[min(cond.size - 1, 2)]]
    skind = np.array([skin_depth(frequency, c) for c in trip])
    dmin = cell_width(skind[0], min_width_pps, min_width_limits)

    # Survey domain DS.  Priority: domain > vector > distance.
    if domain is None and vector is None and distance is None:
        raise ValueError("At least one of `domain`, `distance`, and "
                         "`vector` must be provided.")
    if domain is None:
        if vector is None:
            domain = np.array([center - abs(distance[0]),
                               center + abs(distance[1])])
        else:
            domain = np.array([np.min(vector), np.max(vector)],
                              dtype=float)
    else:
        domain = np.asarray(domain, dtype=np.float64).copy()
        if vector is not None and (domain[0] < np.min(vector) or
                                   domain[1] > np.max(vector)):
            raise ValueError("Provided vector MUST at least include "
                             "all of the survey domain.")

    if seasurface is not None:
        if seasurface <= center:
            raise ValueError(
                "The `seasurface` but be bigger then `center`.")
        if abs(seasurface - center) < dmin:
            center = seasurface

    # Computation domain DC: one (scaled) wavelength beyond DS so the
    # signal decays over two wavelengths there and back.
    wlength = lambda_factor * wavelength(skind[1:])
    if lambda_from_center:
        in_domain = abs(domain - center)
        d_buff = np.max([np.zeros(2), (2 * wlength - in_domain) / 2],
                        axis=0)
        comp_domain = np.array([domain[0] - d_buff[0],
                                domain[1] + d_buff[1]])
        comp_domain[0] = max(comp_domain[0], center - max_buffer)
        comp_domain[1] = min(comp_domain[1], center + max_buffer)
    else:
        dbuffer = np.minimum(wlength, max_buffer)
        comp_domain = np.array([domain[0] - dbuffer[0],
                                domain[1] + dbuffer[1]])

    if cell_numbers is None:
        cell_numbers = good_mg_cell_nr()
    stretching = np.atleast_1d(stretching)

    # --- Search: first (nx, sa, ca) that covers DC wins.
    found = None
    for nx in np.unique(cell_numbers):
        for sa in np.arange(1.0, stretching[0] + 0.005, 0.01):
            ds = _survey_part(dmin, sa, center, domain, vector,
                              seasurface, nx)
            if ds is None:
                continue
            hx_ds, asurv = ds
            nx_remain = nx - hx_ds.size
            if nx_remain <= 0:
                continue
            for ca in np.arange(sa, stretching[-1] + 0.005, 0.01):
                full = _buffer_part(hx_ds, asurv, comp_domain, ca,
                                    nx_remain)
                if full is not None:
                    found = (nx, sa, ca, hx_ds, *full)
                    break
            if found:
                break
        if found:
            break

    if found is None:
        msg = "No suitable grid found; relax your criteria."
        if raise_error:
            raise RuntimeError(msg)
        x0, hx, info = None, None, msg
    else:
        nx, sa, ca, hxo, hx, x0, nx_remain2 = found
        info = _gridding_info(skind, cond, domain, comp_domain, x0, hx,
                              hxo, nx, nx_remain2, sa, ca, stretching)

    if verb > 0:
        print(info)
    if verb < 0:
        return x0, hx, info
    return x0, hx


def _survey_part(dmin, sa, center, domain, vector, seasurface, nx):
    """DS cells: grown from the center with stretching sa (or fixed).

    Returns (widths, [left_edge, right_edge]) of the ACTUAL survey
    part (it covers the requested domain with one cell of overshoot on
    each side), incl. the seasurface node-pinning rescales; None if a
    fixed vector already exceeds the cell budget semantics upstream.
    """
    if vector is None:
        grow = dmin * sa**np.arange(nx)
        right = grow.copy()
        if seasurface is not None and seasurface > center:
            # Rescale the leading right-side cells so a node lands
            # exactly on the seasurface.
            nodes = np.r_[center, center + np.cumsum(right)]
            ii = np.argmin(abs(nodes - seasurface))
            if ii > 0:
                right[:ii] *= abs(seasurface - center) / \
                    np.sum(right[:ii])
        nl = np.sum((center - np.cumsum(grow)) > domain[0]) + 1
        nr = np.sum((center + np.cumsum(right)) < domain[1]) + 1
        hx = np.r_[grow[:nl][::-1], right[:nr]]
        asurv = [center - np.sum(grow[:nl]),
                 center + np.sum(right[:nr])]
    else:
        asurv = [vector[0], vector[-1]]
        hx = np.diff(vector)

    # Extend (rescaled) up to a seasurface above the actual domain.
    if seasurface is not None and seasurface > asurv[-1]:
        ext = hx[-1] * sa**np.arange(nx)
        ii = np.argmax(np.cumsum(ext) > (seasurface - asurv[-1]))
        ext = ext[:ii]
        if ext.size:
            ext *= abs(seasurface - asurv[-1]) / np.sum(ext)
        asurv[1] += np.sum(ext)
        hx = np.r_[hx, ext]
    return hx, asurv


def _buffer_part(hx_ds, asurv, comp_domain, ca, nx_remain):
    """Buffer cells from the DS edges to the computation domain.

    Returns (hx_full, origin, n_leftover) or None if ``nx_remain``
    cells cannot reach the computation domain at stretching ``ca``.
    Leftover cells continue the stretched series, split evenly with
    the odd one going right.
    """
    grow_l = hx_ds[0] * ca**np.arange(1, nx_remain + 1)
    grow_r = hx_ds[-1] * ca**np.arange(1, nx_remain + 1)
    nl = np.sum((asurv[0] - np.cumsum(grow_l)) > comp_domain[0]) + 1
    nr = np.sum((asurv[1] + np.cumsum(grow_r)) < comp_domain[1]) + 1
    n_left = nx_remain - nl - nr
    if n_left < 0:
        return None
    nl += int(np.floor(n_left / 2))
    nr += int(np.ceil(n_left / 2))
    hx = np.r_[grow_l[:nl][::-1], hx_ds, grow_r[:nr]]
    x0 = float(asurv[0] - np.sum(grow_l[:nl]))
    return hx, x0, n_left


def _gridding_info(skind, cond, domain, comp_domain, x0, hx, hxo, nx,
                   nx_remain2, sa, ca, stretching):
    """The per-direction info block (reference format)."""
    sa_adj = np.max([hxo[1:] / hxo[:-1], hxo[:-1] / hxo[1:]])
    sa_limit = min(1.5, stretching[0] + 0.25)
    prec = int(np.ceil(max(0, -np.log10(min(hx)) + 1)))

    info = f"Skin depth     [m] : {skind[0]:.{prec}f}"
    if cond.size > 1:
        info += f" / {skind[1]:.{prec}f}"
    if cond.size > 2:
        info += f" / {skind[2]:.{prec}f}"
    info += "  [corr. to `properties`]\n"
    info += (
        f"Survey dom. DS [m] : "
        f"{domain[0]:.{prec}f} - {domain[1]:.{prec}f}\n"
        f"Comp. dom. DC  [m] : {comp_domain[0]:.{prec}f} - "
        f"{comp_domain[1]:.{prec}f}\n"
        f"Final extent   [m] : {x0:.{prec}f} - "
        f"{x0 + np.sum(hx):.{prec}f}\n"
        f"Cell widths    [m] : {min(hxo):.{prec}f} / "
        f"{max(hxo):.{prec}f} / {max(hx):.{prec}f}  "
        f"[min(DS) / max(DS) / max(DC)]\n"
        f"Number of cells    : {nx} ({hxo.size} / "
        f"{nx - hxo.size - nx_remain2} / {nx_remain2})  "
        f"[Total (DS/DC/remain)]\n"
        f"Max stretching     : {sa:.3f} ({sa_adj:.3f}) / {ca:.3f}"
        "  [DS (seasurface) / DC]")
    if sa_adj > sa_limit:
        info += (f"\nNote: Stretching in DS >> {sa}.\nThe reason "
                 "is usually the interplay of center/domain/"
                 "seasurface.")
    return info


#: Reference-named alias (emg3d/meshes.py:578).
get_origin_widths = origin_and_widths


def construct_mesh(frequency, properties, center, domain=None, vector=None,
                   seasurface=None, **kwargs):
    """Construct a frequency/property-aware 3-D tensor mesh.

    Per-direction gridding via :func:`origin_and_widths`; parameters
    follow the reference's ``construct_mesh`` (emg3d/meshes.py:278-575):

    - ``properties``: scalar (same everywhere), or 2 (center, rest),
      3 (center, z-down, rest), 4 (center, xy, z-down, z-up) or
      7 (center, x-, x+, y-, y+, z-, z+) values;
    - ``domain``/``vector``/``distance`` and ``stretching``/
      ``min_width_limits``/``min_width_pps`` accept per-direction
      3-sequences (None entries fall back to the shared value);
    - the per-direction gridding info is collected on the returned
      mesh as ``mesh.construct_mesh_info`` (printed when verb>0).
    """
    verb = kwargs.get('verb', 0)
    distance = kwargs.pop('distance', None)

    kwargs['frequency'] = frequency
    kwargs['verb'] = -1
    kwargs['raise_error'] = False
    params = [{'center': center[0]}, {'center': center[1]},
              {'center': center[2], 'seasurface': seasurface}]

    # Properties per direction: (center, negative-side, positive-side).
    if isinstance(properties, (int, float)):
        properties = np.array([properties])
    if len(properties) == 3:
        trips = [[properties[0], properties[2], properties[2]]] * 2 + \
            [[properties[0], properties[1], properties[2]]]
    elif len(properties) == 4:
        trips = [[properties[0], properties[1], properties[1]]] * 2 + \
            [[properties[0], properties[2], properties[3]]]
    elif len(properties) == 7:
        trips = [[properties[0], properties[1], properties[2]],
                 [properties[0], properties[3], properties[4]],
                 [properties[0], properties[5], properties[6]]]
    else:
        trips = None
        kwargs['properties'] = properties
    if trips is not None:
        for p, t in zip(params, trips):
            p['properties'] = t

    # Optionally direction-specific arguments: a 3-sequence dispatches
    # per direction (None entries keep the shared/default value).
    def dispatch(name, value, scalar_ok=False):
        if value is None:
            return
        if scalar_ok and isinstance(value, (int, float)):
            kwargs[name] = np.array([value])
            return
        if len(value) == 3 and not isinstance(value, np.ndarray):
            for p, v in zip(params, value):
                if v is not None:
                    p[name] = v
        else:
            kwargs[name] = value

    dispatch('domain', domain)
    dispatch('vector', vector)
    dispatch('distance', distance)
    for name in ['stretching', 'min_width_limits', 'min_width_pps']:
        dispatch(name, kwargs.pop(name, None), scalar_ok=True)

    outs = [origin_and_widths(**kwargs, **p) for p in params]
    if any(o[0] is None for o in outs):
        raise RuntimeError("No suitable grid found; relax your "
                           "criteria.")

    mesh = TensorMesh([o[1] for o in outs],
                      origin=np.array([o[0] for o in outs]))
    info = "".join(
        f"\n         == GRIDDING IN {ax} ==\n{o[2]}\n"
        for ax, o in zip("XYZ", outs))
    mesh.construct_mesh_info = info
    if verb > 0:
        print(info)
    return mesh
