"""CLI driver: stage-wise execution of a configured simulation.

Copy of ``emg3d_tpu/cli/run.py``.  Capability parity with the
reference's emg3d/cli/run.py: forward / misfit / gradient tasks, data
selection, dry-run, console+file logging, output dict with
configuration/data/misfit/n_observations/gradient and the optional
stored simulation.  The staging, logging format and helper
decomposition are the JAX package's.
"""
import json
import logging
import os
import time

import numpy as np

from .. import io, simulations, utils
from .. import __version__
from . import parser

__all__ = ['simulation']

_LOG = logging.getLogger('emg3d_tpu_torch')


def simulation(args_dict):
    """Execute one CLI task (forward / misfit / gradient)."""
    clock = utils.Time()
    cfg, term = parser.parse_config_file(args_dict)
    _require_files(cfg)

    task = term['function']
    dry = bool(term.get('dry_run', False))
    _wire_logging(cfg['files']['log'], term['verbosity'])

    _LOG.info(f"emg3d_tpu_torch v{__version__} | task={task} | "
              f"started {time.asctime()}")
    _LOG.debug("--- resolved configuration (%s) ---\n%s",
               term['config_file'],
               json.dumps(cfg, sort_keys=True, indent=4, default=str))

    sim, data_selection = _build_simulation(cfg)
    _LOG.info("--- simulation ---\n%s\n", sim)
    _LOG.debug("--- meshes ---\n%s", sim.print_grid_info(return_info=True))

    results = {'configuration': {'data': data_selection}}
    _run_task(sim, task, dry, results,
              min_offset=cfg['simulation_options'].pop('min_offset', 0.0))

    if cfg['files']['store_simulation'] and not dry:
        results['simulation'] = sim.to_dict(what='computed')
    _LOG.info("--- writing %s ---", cfg['files']['output'])
    io.save(cfg['files']['output'], **results)

    _LOG.info(f"emg3d_tpu_torch task={task} finished {time.asctime()} "
              f"(elapsed {clock.runtime})")


def _build_simulation(cfg):
    """Load survey/model files, apply the data selection, build the sim."""
    _LOG.info("--- loading inputs ---")
    survey = io.load(cfg['files']['survey'])['survey']
    mdata = io.load(cfg['files']['model'])
    model = mdata['model']
    grid = mdata.get('mesh', mdata.get('grid', getattr(model, 'grid', None)))
    if grid is None:
        raise ValueError("Model file must contain a 'mesh'/'grid'.")

    selection = cfg.get('data', {}) or {}
    if selection:
        survey = survey.select(sources=selection.get('sources'),
                               receivers=selection.get('receivers'),
                               frequencies=selection.get('frequencies'))

    sim = simulations.Simulation(survey=survey, grid=grid, model=model,
                                 verb=-1, **cfg['simulation_options'])
    return sim, selection


def _run_task(sim, task, dry, results, min_offset=0.0):
    """Fill `results` for the requested task, honouring dry runs."""
    _LOG.info("--- forward solves ---")
    if dry:
        results['data'] = np.zeros(sim.survey.shape, dtype=complex)
    elif task == 'forward':
        sim.compute(observed=True, min_offset=min_offset)
        results['data'] = sim.data.observed
        _LOG.debug(sim.print_solver_info('efield', 1, True))
    else:
        sim.compute()
        results['data'] = sim.data.synthetic
        _LOG.debug(sim.print_solver_info('efield', 1, True))

    if task in ('misfit', 'gradient'):
        results['misfit'] = 0.0 if dry else sim.misfit
        results['n_observations'] = sim.survey.size

    if task == 'gradient':
        _LOG.info("--- adjoint solves ---")
        results['gradient'] = (np.zeros(sim.grid.shape_cells) if dry
                               else sim.gradient)
        if not dry:
            _LOG.debug(sim.print_solver_info('bfield', 1, True))


def _require_files(cfg):
    """Fail fast on missing inputs; create the output directory."""
    missing = [cfg['files'][k] for k in ('survey', 'model')
               if not os.path.isfile(cfg['files'][k])]
    if missing:
        raise FileNotFoundError(f"Input file not found: {missing[0]}")
    os.makedirs(os.path.dirname(cfg['files']['output']) or '.',
                exist_ok=True)


def _wire_logging(logfile, verbosity):
    """Route package + warning logs to a file (DEBUG) and the console."""
    console_level = (logging.WARNING, logging.INFO,
                     logging.DEBUG)[min(max(verbosity + 1, 0), 2)]
    to_file = logging.FileHandler(logfile, mode='w')
    to_file.setLevel(logging.DEBUG)
    to_console = logging.StreamHandler()
    to_console.setLevel(console_level)
    for handler in (to_file, to_console):
        handler.setFormatter(logging.Formatter('%(message)s'))

    for name in ('emg3d_tpu_torch', 'py.warnings'):
        log = logging.getLogger(name)
        log.handlers.clear()
        log.setLevel(logging.DEBUG)
        log.addHandler(to_file)
        log.addHandler(to_console)
    logging.captureWarnings(True)
