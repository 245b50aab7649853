"""Simulation: multi-source multi-frequency forward modelling.

The port of ``emg3d_tpu/simulations.py`` (the counterpart of the
reference's simulation layer, emg3d/simulations.py).  Differences from
the reference:

- The reference fans src×freq solves out to a ProcessPoolExecutor
  (pickling whole problems); here the (source, frequency) pairs that
  share a grid are solved together by :func:`.solver.solve_batched` on
  the card (one batched solve advances all lanes), and pairs that
  cannot be batched (``sslsolver='gcrotmk'``, single pairs, other
  grids) are solved from ``max_workers`` host threads.
- Survey data lives in the in-house DataView (no xarray).
- The solves run on CUDA unless ``solver_opts={'device': 'cpu'}``.
"""
import itertools
from copy import deepcopy

import numpy as np

from . import fields, meshes, models, optimize, solver, trace

__all__ = ['Simulation', 'expand_grid_model', 'estimate_gridding_opts']

class Simulation:
    """Forward modelling of an entire survey on a model.

    Parameters (reference parity: emg3d/simulations.py:46-264)
    ----------
    name : str
    survey : Survey
    grid : TensorMesh
    model : Model
    max_workers : int
        Host threads dispatching the solves that cannot be batched
        (threads overlap one solve's blocking norm fetches with another's
        device work).  Batchable groups ignore it: each advances as one
        batched solve.
    gridding : str
        'same', 'single', 'frequency', 'source', 'both', 'input', 'dict'.
    gridding_opts, solver_opts : dict, optional
        ``solver_opts['device']`` is where the solves run (default
        ``'cuda'``; ``'cpu'`` solves on the CPU).
    verb : int
    """

    _gridding_descr = {
        'same': 'Same grid as for model',
        'single': 'A single grid for all sources and frequencies',
        'frequency': 'Frequency-dependent grids',
        'source': 'Source-dependent grids',
        'both': 'Frequency- and source-dependent grids',
        'input': 'A single, provided grid all sources/frequencies',
        'dict': 'Provided dict of frequency-/source-dependent grids',
    }

    def __init__(self, name, survey, grid, model, max_workers=4,
                 gridding='single', **kwargs):
        self.name = name
        self.survey = survey
        self.max_workers = max_workers
        self.gridding = gridding

        gridding_opts = kwargs.pop('gridding_opts', {})
        if gridding_opts is None:
            gridding_opts = {}
        gridding_opts = dict(gridding_opts).copy() \
            if isinstance(gridding_opts, dict) else gridding_opts
        solver_opts = kwargs.pop('solver_opts', {})
        self.verb = kwargs.pop('verb', 0)

        self.solver_opts = {'sslsolver': True, 'semicoarsening': True,
                            'linerelaxation': True, 'verb': 2,
                            **solver_opts, 'return_info': True, 'log': -1}

        self._input_nCz = kwargs.pop('_input_nCz', grid.shape_cells[2])

        if kwargs:
            raise TypeError(f"Unexpected **kwargs: {list(kwargs.keys())}")

        if self.survey.fixed:
            raise NotImplementedError(
                "Simulation currently only implemented for "
                "`survey.fixed=False`.")

        self._dict_grid = self._dict_initiate
        self._dict_model = self._dict_initiate
        self._dict_sfield = self._dict_initiate
        self._dict_efield = self._dict_initiate
        self._dict_hfield = self._dict_initiate
        self._dict_efield_info = self._dict_initiate
        self._gradient = None
        self._misfit = None

        self._shared = {}      # {(kind, *share_key): grid or model}
        if self.gridding == 'dict':
            self._dict_grid = gridding_opts
        elif self.gridding == 'input':
            self._input_grid = gridding_opts
        elif self.gridding == 'same':
            if gridding_opts:
                raise TypeError(
                    "`gridding_opts` is not permitted if "
                    "`gridding='same'`")
        else:
            expand = gridding_opts.pop('expand', None)
            if expand is not None:
                try:
                    interface = gridding_opts['seasurface']
                except KeyError as e:
                    raise KeyError(
                        "`gridding_opts['seasurface']` is required if "
                        "`gridding_opts['expand']` is provided.") from e
                grid, model = expand_grid_model(grid, model, expand,
                                                interface)
            self.gridding_opts = estimate_gridding_opts(
                gridding_opts, grid, model, survey, self._input_nCz)

        self.grid = grid
        self.model = model

        if 'synthetic' not in self.survey.data.keys():
            self.survey._data['synthetic'] = \
                self.survey.data.observed * np.nan

    def __repr__(self):
        return (f"*{self.__class__.__name__}* «{self.name}» "
                f"of Survey «{self.survey.name}»\n\n"
                f"- Survey: {self.survey.shape[0]} sources; "
                f"{self.survey.shape[1]} receivers; "
                f"{self.survey.shape[2]} frequencies\n"
                f"- {self.model.__repr__()}\n"
                f"- Gridding: {self._gridding_descr[self.gridding]}")

    # -- per-pair resources --------------------------------------------

    @property
    def _dict_initiate(self):
        return {src: {float(freq): None
                      for freq in self.survey.frequencies}
                for src in self.survey.sources.keys()}

    @property
    def _srcfreq(self):
        if getattr(self, '__srcfreq', None) is None:
            self.__srcfreq = list(itertools.product(
                self.survey.sources.keys(),
                [float(f) for f in self.survey.frequencies]))
        return self.__srcfreq

    # Per-pair grids/models are shared at the granularity the gridding
    # mode implies; one cache dict keyed by that granularity replaces
    # the reference's per-mode cache attributes.

    def _share_key(self, source, freq):
        """Resource-sharing granularity of the gridding mode."""
        return {
            'frequency': ('freq', freq),
            'source': ('src', source),
            'both': ('pair', source, freq),
        }.get(self.gridding, ('all',))

    def _build_grid(self, source, freq):
        if self.gridding == 'same':
            return self.grid
        if self.gridding == 'input':
            return self._input_grid
        opts = dict(self.gridding_opts)
        if self.gridding in ('frequency', 'both'):
            opts['frequency'] = freq
        if self.gridding in ('source', 'both'):
            opts['center'] = \
                self.survey.sources[source].coordinates[:3]
        return meshes.construct_mesh(**opts)

    def get_grid(self, source, frequency):
        """Computational grid for (source, frequency)."""
        freq = float(frequency)
        if self._dict_grid[source][freq] is None:
            key = ('grid', *self._share_key(source, freq))
            if key not in self._shared:
                with trace.span('survey.grid'):
                    self._shared[key] = self._build_grid(source, freq)
            self._dict_grid[source][freq] = self._shared[key]
        return self._dict_grid[source][freq]

    def get_model(self, source, frequency):
        """Model on the computational grid of (source, frequency)."""
        freq = float(frequency)
        if self._dict_model[source][freq] is None:
            key = ('model', *self._share_key(source, freq))
            if key not in self._shared:
                cgrid = self.get_grid(source, freq)
                with trace.span('survey.grid'):
                    self._shared[key] = self.model \
                        if self.gridding == 'same' else \
                        self.model.interpolate2grid(self.grid, cgrid)
            self._dict_model[source][freq] = self._shared[key]
        return self._dict_model[source][freq]

    def get_sfield(self, source, frequency):
        """Source field for (source, frequency)."""
        freq = float(frequency)
        if self._dict_sfield[source][freq] is None:
            src = self.survey.sources[source]
            strength = getattr(src, 'strength', 0)
            grid = self.get_grid(source, frequency)
            with trace.span('survey.sfield'):
                sfield = fields.get_source_field(
                    grid=grid,
                    src=src.coordinates,
                    freq=frequency,
                    strength=strength,
                    electric=src.electric)
            self._dict_sfield[source][freq] = sfield
        return self._dict_sfield[source][freq]

    def get_efield(self, source, frequency, **kwargs):
        """Electric field for (source, frequency); solves on demand."""
        freq = float(frequency)
        call_from_hfield = kwargs.pop('call_from_hfield', False)
        if kwargs:
            raise TypeError(f"Unexpected **kwargs: {list(kwargs.keys())}")

        if self._dict_efield[source][freq] is None:
            solver_input = {
                **self.solver_opts,
                'grid': self.get_grid(source, freq),
                'model': self.get_model(source, freq),
                'sfield': self.get_sfield(source, freq),
            }
            trace.count('survey.pairs', 1)
            trace.count('survey.unbatched', 1)
            efield, info = solver.solve(**solver_input)
            self._dict_efield[source][freq] = efield
            self._dict_efield_info[source][freq] = info

            if not call_from_hfield:
                self._dict_hfield[source][freq] = None
                self._store_responses(source, frequency)

        return self._dict_efield[source][freq]

    def get_hfield(self, source, frequency, **kwargs):
        """Magnetic field for (source, frequency)."""
        freq = float(frequency)
        if self._dict_hfield[source][freq] is None:
            self._dict_hfield[source][freq] = fields.get_h_field(
                self.get_grid(source, freq),
                self.get_model(source, freq),
                self.get_efield(source, freq, call_from_hfield=True,
                                **kwargs))
            self._store_responses(source, freq)
        return self._dict_hfield[source][freq]

    def get_efield_info(self, source, frequency):
        return self._dict_efield_info[source][float(frequency)]

    def _freq_index(self, freq):
        return int(np.argmin(np.abs(self.survey.frequencies -
                                    float(freq))))

    def _src_index(self, source):
        return list(self.survey.sources).index(source)

    def _store_responses(self, source, frequency):
        """Store receiver responses into data.synthetic."""
        freq = float(frequency)
        rec_coords = self.survey.rec_coords
        rec_types = self.survey.rec_types
        isrc = self._src_index(source)
        ifreq = self._freq_index(freq)

        if rec_types.count(True):
            erec = np.nonzero(rec_types)[0]
            efield = self.get_efield(source, freq)
            with trace.span('survey.responses'):
                resp = fields.get_receiver_response(
                    grid=self.get_grid(source, freq), field=efield,
                    rec=tuple(np.array(rec_coords)[:, erec]))
                self.data.synthetic[isrc, erec, ifreq] = resp

        if rec_types.count(False):
            mrec = np.nonzero(np.logical_not(rec_types))[0]
            hfield = self.get_hfield(source, freq)
            with trace.span('survey.responses'):
                resp = fields.get_receiver_response(
                    grid=self.get_grid(source, freq), field=hfield,
                    rec=tuple(np.array(rec_coords)[:, mrec]))
                self.data.synthetic[isrc, mrec, ifreq] = resp

    # -- computation ----------------------------------------------------

    def compute(self, observed=False, **kwargs):
        """Compute electric fields for all (source, frequency) pairs.

        observed=True copies the synthetic data to observed (forward
        modelling), adding Gaussian noise scaled by the standard
        deviation (if set), NaN-ing data below the noise floor and
        below ``min_offset``.
        Reference parity: emg3d/simulations.py:821-913.

        (Source, frequency) pairs sharing a grid run as one batched
        solve (:func:`.solver.solve_batched`), the on-device replacement
        of the reference's process pool.
        """
        with trace.span('survey.compute'):
            self._compute_batched()
            # Pairs the batched path could not group (gcrotmk, singleton
            # groups, mismatched grids) are independent solves: dispatch
            # them from `max_workers` host threads so one solve's blocking
            # norm fetches overlap another's device work — the analog of
            # the reference's process-pool fan-out (reference
            # simulations.py:862-867).
            pending = [(s, f) for s, f in self._srcfreq
                       if self._dict_efield[s][float(f)] is None]
            if len(pending) > 1 and int(self.max_workers) > 1:
                from concurrent.futures import ThreadPoolExecutor
                nw = min(int(self.max_workers), len(pending))
                with ThreadPoolExecutor(nw) as pool:
                    list(pool.map(lambda sf: self.get_efield(*sf), pending))
            for src, freq in self._srcfreq:
                self.get_efield(src, freq)

            self.print_solver_info('efield', verb=self.verb)

            if observed:
                self.data['observed'] = self.data['synthetic'].copy()

                if self.survey.standard_deviation is not None:
                    std = np.asarray(self.survey.standard_deviation)
                    random = np.random.randn(
                        int(np.prod(self.survey.shape)) * 2)
                    noise_re = std * random[::2].reshape(self.survey.shape)
                    noise_im = std * random[1::2].reshape(self.survey.shape)
                    self.data['observed'] += noise_re + 1j * noise_im

                if self.survey.noise_floor is not None:
                    min_amp = (np.abs(self.data.synthetic) <
                               self.survey.noise_floor)
                    self.data['observed'][min_amp] = np.nan + 1j * np.nan

                offsets = np.linalg.norm(
                    np.array(self.survey.rec_coords[:3])[:, None, :] -
                    np.array(self.survey.src_coords[:3])[:, :, None],
                    axis=0)
                min_off = offsets < kwargs.get('min_offset', 0.0)
                self.data['observed'][min_off] = np.nan + 1j * np.nan

    def _compute_batched(self):
        """Batched multi-(source, frequency) solves sharing a grid.

        Fills ``_dict_efield`` for groups of >=2 uncomputed (source,
        frequency) pairs on the same (grid, model): mixed frequencies
        batch too (the solver stacks η per lane).  Plain multigrid,
        bicgstab and cgs all batch; gcrotmk falls back to per-pair
        solves.
        """
        ssl = self.solver_opts.get('sslsolver', True)
        if ssl is True:
            ssl = 'bicgstab'
        if ssl not in (False, 'bicgstab', 'cgs'):
            return

        groups = {}
        for src, freq in self._srcfreq:
            if self._dict_efield[src][freq] is not None:
                continue
            grid = self.get_grid(src, freq)
            model = self.get_model(src, freq)
            groups.setdefault((id(grid), id(model)),
                              []).append((src, freq))

        for pairs in groups.values():
            if len(pairs) < 2:
                continue
            src0, freq0 = pairs[0]
            grid = self.get_grid(src0, freq0)
            model = self.get_model(src0, freq0)
            sfields = [self.get_sfield(src, freq) for src, freq in pairs]
            opts = {k: v for k, v in self.solver_opts.items()
                    if k not in ['sslsolver', 'return_info', 'log']}
            trace.count('survey.pairs', len(pairs))
            trace.count('survey.batches', 1)
            efields, info = solver.solve_batched(grid, model, sfields,
                                                 sslsolver=ssl, **opts)
            for i, (src, freq) in enumerate(pairs):
                self._dict_efield[src][freq] = efields[i]
                sinfo = dict(info)
                sinfo['abs_error'] = float(info['abs_error'][i])
                sinfo['rel_error'] = float(info['rel_error'][i])
                sinfo['ref_error'] = float(info['ref_error'][i])
                self._dict_efield_info[src][freq] = sinfo
                self._dict_hfield[src][freq] = None
                self._store_responses(src, freq)

    @property
    def data(self):
        return self.survey.data

    # -- optimization ---------------------------------------------------

    @property
    def gradient(self):
        """Adjoint-state gradient of the misfit (model-grid shaped)."""
        if self._gradient is None:
            self._gradient = optimize.gradient(self)
        return self._gradient[:, :, :self._input_nCz]

    @property
    def misfit(self):
        """Weighted l2 data misfit."""
        if self._misfit is None:
            self._misfit = optimize.misfit(self)
        return self._misfit

    # -- back-propagation (adjoint solves) ------------------------------

    def _bcompute(self):
        """Back-propagated (adjoint) fields for all (src, freq) pairs.

        Like the forward :meth:`_compute_batched`, groups of sources
        sharing (grid, frequency) are solved device-batched (the
        receivers-as-sources adjoint systems share the operator), the
        on-device replacement of the reference's process-pool fan-out
        (emg3d/simulations.py:1145-1169).
        """
        if not hasattr(self, '_dict_bfield'):
            self._dict_bfield = self._dict_initiate
            self._dict_bfield_info = self._dict_initiate

        self._bcompute_batched()
        for src, freq in self._srcfreq:
            if self._dict_bfield[src][freq] is not None:
                continue
            solver_input = {
                **self.solver_opts,
                'grid': self.get_grid(src, freq),
                'model': self.get_model(src, freq),
                'sfield': self._get_rfield(src, freq),
            }
            bfield, info = solver.solve(**solver_input)
            self._dict_bfield[src][freq] = bfield
            self._dict_bfield_info[src][freq] = info

        self.print_solver_info('bfield', verb=self.verb)

    def _bcompute_batched(self):
        """Batched adjoint solves for (src, freq) pairs on one grid."""
        ssl = self.solver_opts.get('sslsolver', True)
        if ssl is True:
            ssl = 'bicgstab'
        if ssl not in (False, 'bicgstab', 'cgs'):
            return

        groups = {}
        for src, freq in self._srcfreq:
            if self._dict_bfield[src][freq] is not None:
                continue
            grid = self.get_grid(src, freq)
            model = self.get_model(src, freq)
            groups.setdefault((id(grid), id(model)),
                              []).append((src, freq))

        for pairs in groups.values():
            if len(pairs) < 2:
                continue
            src0, freq0 = pairs[0]
            grid = self.get_grid(src0, freq0)
            model = self.get_model(src0, freq0)
            rfields = [self._get_rfield(src, freq) for src, freq in pairs]
            opts = {k: v for k, v in self.solver_opts.items()
                    if k not in ['sslsolver', 'return_info', 'log']}
            bfields, info = solver.solve_batched(grid, model, rfields,
                                                 sslsolver=ssl, **opts)
            for i, (src, freq) in enumerate(pairs):
                self._dict_bfield[src][freq] = bfields[i]
                sinfo = dict(info)
                sinfo['abs_error'] = float(info['abs_error'][i])
                sinfo['rel_error'] = float(info['rel_error'][i])
                sinfo['ref_error'] = float(info['ref_error'][i])
                self._dict_bfield_info[src][freq] = sinfo

    def _get_rfield(self, source, frequency):
        """Receivers-as-sources residual field (adjoint source).

        Strength per receiver: conj(weight·residual)/smu0, with an
        additional /smu0 for magnetic receivers.
        Reference parity: emg3d/simulations.py:1171-1212.
        """
        freq = float(frequency)
        grid = self.get_grid(source, frequency)
        rfield = fields.SourceField.zeros(grid, frequency=frequency)
        isrc = self._src_index(source)
        ifreq = self._freq_index(freq)

        for irec, (name, rec) in enumerate(
                self.survey.receivers.items()):
            residual = self.data.residual[isrc, irec, ifreq]
            if np.isnan(residual):
                continue
            strength = residual.conj()
            strength *= np.conj(self.data.weights[isrc, irec, ifreq])
            strength /= rfield.smu0
            if not rec.electric:
                strength /= rfield.smu0

            if strength != 0:
                seg = fields.get_source_field(
                    grid=grid, src=rec.coordinates, freq=frequency,
                    strength=strength, electric=rec.electric)
                rfield = fields.SourceField(
                    rfield.fx + seg.fx, rfield.fy + seg.fy,
                    rfield.fz + seg.fz, frequency=frequency)
        return rfield

    # -- housekeeping ---------------------------------------------------

    def clean(self, what='computed'):
        """Clean part of the database.

        what : 'computed' | 'keepresults' | 'all'
        """
        if what not in ['computed', 'keepresults', 'all']:
            raise TypeError(f"Unrecognized `what`: {what}")

        if what in ['keepresults', 'all']:
            for name in ['_dict_grid', '_dict_model', '_dict_sfield']:
                setattr(self, name, self._dict_initiate)

        if what in ['computed', 'keepresults', 'all']:
            for name in ['_dict_efield', '_dict_efield_info',
                         '_dict_hfield']:
                setattr(self, name, self._dict_initiate)
            for name in ['_dict_bfield', '_dict_bfield_info']:
                if hasattr(self, name):
                    delattr(self, name)

        if what in ['computed', 'all']:
            for key in ['residual', 'weights']:
                self.data.pop(key, None)
            self.data['synthetic'] = self.data.observed * np.nan
            self._gradient = None
            self._misfit = None

    def copy(self, what='computed'):
        return self.from_dict(self.to_dict(what, True))

    def to_dict(self, what='computed', copy=False):
        if what not in ['computed', 'results', 'all', 'plain']:
            raise TypeError(f"Unrecognized `what`: {what}")

        out = {'name': self.name, '__class__': self.__class__.__name__}
        out['survey'] = self.survey.to_dict()
        out['grid'] = self.grid.to_dict()
        out['model'] = self.model.to_dict()
        out['max_workers'] = self.max_workers
        out['gridding'] = self.gridding
        out['solver_opts'] = {k: v for k, v in self.solver_opts.items()
                              if k not in ['return_info', 'log']}

        if what == 'plain':
            for key in ['synthetic', 'residual', 'weights']:
                out['survey']['data'].pop(key, None)

        if self.gridding == 'input':
            out['gridding_opts'] = self._input_grid
        elif self.gridding == 'dict':
            out['gridding_opts'] = self._dict_grid
        elif self.gridding != 'same':
            gopts = dict(self.gridding_opts)
            if 'mapping' in gopts and not isinstance(
                    gopts['mapping'], str):
                gopts['mapping'] = gopts['mapping'].name
            out['gridding_opts'] = gopts

        out['_input_nCz'] = self._input_nCz

        if what in ['computed', 'all']:
            for name in ['_dict_efield', '_dict_efield_info',
                         '_dict_hfield', '_dict_bfield',
                         '_dict_bfield_info']:
                if hasattr(self, name):
                    out[name] = _serialize_dict_of_fields(
                        getattr(self, name))
            if what == 'all':
                out['_dict_grid'] = _serialize_dict_of_fields(
                    self._dict_grid)
                out['_dict_model'] = _serialize_dict_of_fields(
                    self._dict_model)
                out['_dict_sfield'] = _serialize_dict_of_fields(
                    self._dict_sfield)

        if what in ['computed', 'results', 'all']:
            out['gradient'] = self._gradient
            out['misfit'] = self._misfit

        if copy:
            return deepcopy(out)
        return out

    @classmethod
    def from_dict(cls, inp):
        from .meshes import TensorMesh
        from .surveys import Survey
        inp = {k: v for k, v in inp.items() if k != '__class__'}

        survey = inp.pop('survey')
        if not isinstance(survey, Survey):
            survey = Survey.from_dict(survey)
        grid = inp.pop('grid')
        if not isinstance(grid, TensorMesh):
            grid = TensorMesh.from_dict(grid)
        model = inp.pop('model')
        if not isinstance(model, models.Model):
            model = models.Model.from_dict(model)

        gridding = str(inp.pop('gridding'))
        gridding_opts = inp.pop('gridding_opts', {})
        if gridding == 'same':
            gridding_opts = {}

        sim = cls(name=str(inp.pop('name')), survey=survey, grid=grid,
                  model=model,
                  max_workers=int(inp.pop('max_workers', 4)),
                  gridding=gridding,
                  gridding_opts=gridding_opts if gridding != 'same'
                  else {},
                  solver_opts=dict(inp.pop('solver_opts', {})),
                  _input_nCz=int(inp.pop('_input_nCz',
                                         grid.shape_cells[2])))

        for name in ['_dict_efield', '_dict_efield_info', '_dict_hfield',
                     '_dict_bfield', '_dict_bfield_info']:
            if name in inp and inp[name] is not None:
                setattr(sim, name, _deserialize_dict_of_fields(
                    inp.pop(name), survey))
        grad = inp.pop('gradient', None)
        if grad is not None and not isinstance(grad, str):
            sim._gradient = np.asarray(grad)
        mis = inp.pop('misfit', None)
        if mis is not None and not isinstance(mis, str):
            sim._misfit = float(mis)
        return sim

    def to_file(self, fname, what='computed', name='simulation',
                **kwargs):
        from . import io
        kwargs[name] = self.to_dict(what=what)
        kwargs['collect_classes'] = False
        io.save(fname, **kwargs)

    @classmethod
    def from_file(cls, fname, name='simulation', **kwargs):
        from . import io
        out = io.load(fname, **kwargs)[name]
        if isinstance(out, dict):
            return cls.from_dict(out)
        return out

    # -- info printing --------------------------------------------------

    def print_grid_info(self, verb=1, return_info=False):
        out = ""
        seen = set()
        for src, freq in self._srcfreq:
            grid = self.get_grid(src, freq)
            key = id(grid)
            if key in seen:
                continue
            seen.add(key)
            out += f"= {grid!r} =\n"
        if return_info:
            return out
        elif out:
            print(out)

    def print_solver_info(self, field='efield', verb=1,
                          return_info=False):
        info = getattr(self, f"_dict_{field}_info", {})
        out = ""
        if verb > -1:
            for src, freq in self._srcfreq:
                cinfo = info.get(src, {}).get(freq)
                if cinfo is not None and (verb > 0 or
                                          cinfo['exit'] != 0):
                    if not out:
                        out += "\n"
                        if verb > 0:
                            out += f"    - SOLVER INFO <{field}> -\n\n"
                    out += f"= Source {src}; Frequency {freq} Hz ="
                    out += f" {cinfo['exit_message']}\n"
        if return_info:
            return out
        elif out:
            print(out)


def _serialize_dict_of_fields(dct):
    """dict[src][freq] of Fields/dicts -> plain dicts for io."""
    out = {}
    for src, sub in dct.items():
        out[src] = {}
        for freq, val in sub.items():
            if val is None:
                out[src][freq] = None
            elif hasattr(val, 'to_dict'):
                out[src][freq] = val.to_dict()
            else:
                out[src][freq] = val
    return out


def _deserialize_dict_of_fields(dct, survey):
    out = {}
    for src, sub in dct.items():
        out[src] = {}
        for freq, val in sub.items():
            f = float(freq)
            if val is None or (isinstance(val, str)):
                out[src][f] = None
            elif isinstance(val, dict) and \
                    val.get('__class__') in ('Field', 'SourceField'):
                out[src][f] = fields.Field.from_dict(val)
            else:
                out[src][f] = val
    return out


# ----------------------------------------------------------------------
# Helper functions
# ----------------------------------------------------------------------

def expand_grid_model(grid, model, expand, interface):
    """Expand grid+model vertically: water up to ``interface``, then air.

    Appends at most two layers on top of the grid: one from the
    current grid top up to ``interface`` with property ``expand[0]``
    (unless the top is already within 5 cm of it), and a 100 m layer
    of ``expand[1]`` (air) unless the top already clears the interface
    by more than 1 mm.  mu_r/epsilon_r continue with 1 in the added
    layers.  Matches the reference's behavior
    (emg3d/simulations.py:1216-1299).
    """
    ztop = grid.nodes_z[-1]
    added = []               # (thickness, property value), bottom->top
    if ztop < interface - 0.05:
        added.append((interface - ztop, expand[0]))
    if ztop <= interface + 0.001:
        added.append((100.0, expand[1]))
    if not added:
        return grid, model

    grid = meshes.TensorMesh(
        [grid.h[0], grid.h[1], np.r_[grid.h[2], [t for t, _ in added]]],
        origin=grid.origin)

    def stacked(name, values):
        if getattr(model, '_' + name) is None:
            return None
        cur = np.asarray(getattr(model, name))
        layers = [np.full(cur.shape[:2] + (1,), float(v)) for v in values]
        return np.concatenate([cur, *layers], axis=2)

    ones = [1.0] * len(added)
    model = models.Model(
        grid,
        stacked('property_x', [v for _, v in added]),
        stacked('property_y', [v for _, v in added]),
        stacked('property_z', [v for _, v in added]),
        mu_r=stacked('mu_r', ones),
        epsilon_r=stacked('epsilon_r', ones),
        mapping=model.map.name)
    return grid, model


def estimate_gridding_opts(gridding_opts, grid, model, survey,
                           input_nCz=None):
    """Estimate construct_mesh parameters from survey and model.

    Reference parity: emg3d/simulations.py:1302-1552 — frequency =
    log-mean of survey frequencies; center = mean source position;
    properties = most-resistive outer-layer values per direction (via
    mapping round-trip); domain from src/rec extents with 10% padding
    and x:y <= 3, z >= hdist/2 ratios; `vector` may be a string of axis
    letters to take grid vectors.
    """
    gridding_opts = dict(gridding_opts)
    gopts = {}

    # Passed-through keys.
    for key in ['seasurface', 'max_buffer', 'lambda_factor',
                'lambda_from_center', 'verb', 'cell_numbers',
                'min_width_limits', 'min_width_pps', 'stretching']:
        if key in gridding_opts:
            gopts[key] = gridding_opts.pop(key)

    # Mapping.
    mapping = gridding_opts.pop('mapping', model.map)
    gopts['mapping'] = mapping if isinstance(mapping, str) \
        else mapping.name

    # Frequency: log-average.
    freq = gridding_opts.pop('frequency', None)
    if freq is None:
        freqs = np.abs(survey.frequencies)
        freq = 10**np.mean(np.log10(freqs))
        if np.any(np.asarray(survey.frequencies) < 0):
            freq = -freq
    gopts['frequency'] = freq

    # Center: mean source position.
    center = gridding_opts.pop('center', None)
    if center is None:
        src = np.array(survey.src_coords[:3])
        center = tuple(np.mean(src, axis=1))
    gopts['center'] = center

    # Vector: string of axes -> grid vectors.
    vector = gridding_opts.pop('vector', None)
    if isinstance(vector, str):
        vector = (grid.nodes_x if 'x' in vector.lower() else None,
                  grid.nodes_y if 'y' in vector.lower() else None,
                  grid.nodes_z if 'z' in vector.lower() else None)
    gopts['vector'] = vector

    # Properties: most resistive values of the outermost layers.
    properties = gridding_opts.pop('properties', None)
    if properties is None:
        m = model.map

        def most_resistive(prop, sls):
            """Return the most resistive (lowest σ) value of the slices.
            """
            cond = m.backward(np.asarray(prop))
            vals = [np.min(cond[sl]) for sl in sls]
            return m.forward(min(vals))

        px = np.asarray(model.property_x) * np.ones(grid.shape_cells)
        pz = np.asarray(model.property_z) * np.ones(grid.shape_cells)
        xneg = most_resistive(px, [np.s_[0, :, :]])
        xpos = most_resistive(px, [np.s_[-1, :, :]])
        yneg = most_resistive(px, [np.s_[:, 0, :]])
        ypos = most_resistive(px, [np.s_[:, -1, :]])
        zneg = most_resistive(pz, [np.s_[:, :, 0]])
        zpos = most_resistive(pz, [np.s_[:, :, -1]])
        # Center property: at the source center.
        ci = [np.argmin(np.abs(getattr(grid, 'cell_centers_' + c) -
                               center[i]))
              for i, c in enumerate('xyz')]
        pcenter = float(np.asarray(px)[ci[0], ci[1], ci[2]])
        properties = [pcenter, xneg, xpos, yneg, ypos, zneg, zpos]
    gopts['properties'] = properties

    # Domain from survey extent.
    domain = gridding_opts.pop('domain', None)
    if domain is None:
        src = np.array(survey.src_coords[:3])
        rec_coords = survey.rec_coords
        rec = np.array(rec_coords[:3])
        pts = np.concatenate([src, rec], axis=1)

        def get_dim(px):
            lo, hi = px.min(), px.max()
            diff = max(hi - lo, 1.0)
            return [lo - 0.1 * diff, hi + 0.1 * diff]

        xdom = get_dim(pts[0])
        ydom = get_dim(pts[1])
        # Ratio: x/y dimension at least a third of the other.
        dx = xdom[1] - xdom[0]
        dy = ydom[1] - ydom[0]
        if dx < dy / 3:
            add = (dy / 3 - dx) / 2
            xdom = [xdom[0] - add, xdom[1] + add]
        if dy < dx / 3:
            add = (dx / 3 - dy) / 2
            ydom = [ydom[0] - add, ydom[1] + add]
        # z: extent of src/rec; at least hdist/2 (hdist = max hor. dim,
        # capped at 5 km), 1/10 up, 9/10 down.
        hdist = min(10000.0, max(xdom[1] - xdom[0],
                                 ydom[1] - ydom[0])) / 2
        zlo, zhi = pts[2].min(), pts[2].max()
        if (zhi - zlo) < hdist:
            zlo = zlo - 9 / 10 * (hdist - (zhi - zlo))
            zhi = zhi + 1 / 10 * (hdist - (zhi - zlo))
        zdom = [zlo, min(zhi, 0.0) if zhi <= 0 else zhi]
        domain = (xdom, ydom, zdom)
    gopts['domain'] = domain

    if gridding_opts:
        raise TypeError(
            f"Unexpected gridding_opts: {list(gridding_opts.keys())}")

    return gopts
