"""Inversion building blocks: misfit and adjoint-state gradient.

The port of ``emg3d_tpu/optimize.py`` (numpy, with the port's
``maps``): functional parity with the reference's emg3d/optimize.py
(same quantities, limitations and data side effects); structured around
two small helpers instead of the reference's inline flow:

- :func:`_weighted_residual` — the (residual, weights) pair, computing
  forward fields on demand and recording both into the survey data.
- :func:`_pair_gradient` — one (source, frequency) contribution to the
  model-grid gradient.

The forward and adjoint solves run through :class:`.Simulation`, on the
card unless its ``solver_opts`` say otherwise.
"""
import numpy as np

from . import maps

__all__ = ['misfit', 'gradient']


def _weighted_residual(simulation):
    """(residual, weights) of the survey, stored into the data views.

    Runs ``simulation.compute()`` first if any forward field is still
    missing.  Weights are 1/σ² from the survey's standard deviation;
    its absence is an error because the misfit is σ-weighted by
    definition.
    """
    std = simulation.survey.standard_deviation
    if std is None:
        raise ValueError(
            "The misfit requires the survey's standard_deviation: set "
            "noise_floor and/or relative_error (> 0), or assign "
            "standard_deviation directly (shaped like the data).")

    fields = simulation._dict_efield
    if any(fields[src][freq] is None
           for src, freq in simulation._srcfreq):
        simulation.compute()

    data = simulation.data
    data['residual'] = data.synthetic - data.observed
    if 'weights' not in data.keys():
        data['weights'] = np.asarray(std) ** -2.0
    return data['residual'], data['weights']


def misfit(simulation):
    r"""Weighted least-squares data misfit φ = ½ Σ |W (d_syn − d_obs)|².

    NaN observations (missing receivers) drop out of the sum.  Stores
    ``residual`` and ``weights`` in the survey data as side effects.
    Reference parity: emg3d/optimize.py:36-112.
    """
    residual, weights = _weighted_residual(simulation)
    return np.nansum(weights * np.abs(np.asarray(residual)) ** 2) / 2


def _pair_gradient(simulation, src, freq):
    """One (src, freq) pair's gradient on the *model* grid.

    g_edges = −Re(λ̄ ∘ E ∘ sμ0) on the pair's computational grid, cell-
    averaged (× V/4), then cubic-interpolated back to the model grid.
    """
    lam = simulation._dict_bfield[src][freq]
    ef = simulation._dict_efield[src][freq]
    cgrid = simulation._dict_grid[src][freq]

    edge = {
        ax: -np.real(np.asarray(getattr(lam, 'f' + ax)) *
                     np.asarray(getattr(ef, 'f' + ax)) * ef.smu0)
        for ax in 'xyz'
    }
    cell = maps.edges2cellaverages(edge['x'], edge['y'], edge['z'],
                                   np.asarray(cgrid.cell_volumes))
    return maps.grid2grid(cgrid, -sum(cell), simulation.grid,
                          method='cubic')


def gradient(simulation):
    r"""Adjoint-state gradient of the misfit ([PlMu08] Eq. 10).

    Same limitations as the reference: isotropic conductivity-class
    models without ε_r or μ_r.  Triggers the misfit (hence forward
    fields) and the back-propagated adjoint fields, accumulates each
    pair's model-grid contribution, then applies the property map's
    derivative chain.  Reference parity: emg3d/optimize.py:115-217.
    """
    model = simulation.model
    if model.case != 0:
        raise NotImplementedError(
            "Gradient only implemented for isotropic models.")
    for name, value in (('el. permittivity', model.epsilon_r),
                        ('magn. permeability', model.mu_r)):
        if value is not None and not np.allclose(value, 1.0):
            raise NotImplementedError(
                f"Gradient not implemented for {name}.")

    _ = simulation.misfit          # ensures forward fields + residual
    simulation._bcompute()         # adjoint (back-propagated) fields

    total = sum(_pair_gradient(simulation, src, freq)
                for src, freq in simulation._srcfreq)
    simulation.model.map.derivative_chain(total, model.property_x)
    return total
