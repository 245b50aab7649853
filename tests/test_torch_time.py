"""Port vs JAX package: the time domain (``Fourier``) and a time-domain
Simulation.

- ``Fourier``'s frequencies (required, computed, extrapolated,
  interpolated) equal the JAX package's exactly, for DLF and FFTLog,
  every_x_freq and freq_inp.
- The cases of tests/test_time.py as one parametrised test: each
  transform of the analytic pair F(ω) = 1/(a + iω) within 1e-12 of the
  JAX package's, and within that file's tolerance of the exact answer.
- A time-domain survey at 8³: the 4 frequencies of a ``Fourier`` as one
  batched Simulation in both packages; frequency responses and their
  ``freq2time`` within rel 1e-7.
"""
import pytest

pytest.importorskip('jax')

import numpy as np  # noqa: E402
import torch  # noqa: E402

import emg3d_tpu as jt  # noqa: E402
from emg3d_tpu import time as jtime  # noqa: E402

import emg3d_tpu_torch as pt  # noqa: E402
from emg3d_tpu_torch import time as ptime  # noqa: E402

torch.set_num_threads(1)

A = 2.0
TIME = np.logspace(-1.5, 0.8, 12)


def F_omega(w):
    return 1.0 / (A + 1j * w)


FREQ_CASES = {
    'dlf': dict(fmin=1e-2, fmax=10.0),
    'every3': dict(fmin=1e-2, fmax=10.0, every_x_freq=3),
    'freq_inp': dict(fmin=1e-2, fmax=10.0,
                     freq_inp=np.logspace(-2, 1, 11)),
    'fftlog': dict(fmin=1e-4, fmax=1e3, ft='fftlog',
                   ftarg={'pts_per_dec': 30, 'add_dec': [-4, 3]}),
    'tdem': dict(fmin=0.01, fmax=10, signal=-1, every_x_freq=2),
}


@pytest.mark.parametrize('case', sorted(FREQ_CASES))
def test_fourier_frequencies_equal(case):
    kw = FREQ_CASES[case]
    t = np.logspace(-1, 1, 21) if case == 'tdem' else TIME
    fj, fp = jtime.Fourier(t, **kw), ptime.Fourier(t, **kw)
    for name in ('freq_req', 'freq_coarse', 'freq_compute',
                 'freq_extrapolate', 'freq_interpolate'):
        assert np.array_equal(getattr(fp, name), getattr(fj, name)), name
    assert repr(fp) == repr(fj)
    if case == 'tdem':                      # chip_smoke's phase 11
        assert fp.freq_compute.size == 19


def _kernel(mod, kind):
    t = np.logspace(-2, 1.2, 20)
    if kind == 'dlf_sin':
        g = mod.dlf_transform(lambda w: w / (A**2 + w**2), t, kind='sin')
        return g, np.pi / 2 * np.exp(-A * t)
    if kind == 'dlf_cos':
        g = mod.dlf_transform(lambda w: 1 / (A**2 + w**2), t, kind='cos')
        return g, np.pi / (2 * A) * np.exp(-A * t)
    freq = np.logspace(-5, 4, 400) / (2 * np.pi)
    w = 2 * np.pi * freq
    t = np.logspace(-1.5, 1, 8)
    g = mod.fftlog_transform(freq, w / (A**2 + w**2), t, kind='sin')
    return g, np.pi / 2 * np.exp(-A * t)


def _fourier(mod, ft, signal, band=(1e-4, 1e3), **ftarg):
    ff = mod.Fourier(TIME, fmin=band[0], fmax=band[1], signal=signal,
                     ft=ft, ftarg=ftarg or None)
    resp = ff.freq2time(F_omega(2 * np.pi * ff.freq_compute))
    exact = (np.exp(-A * TIME), (1 - np.exp(-A * TIME)) / A,
             np.exp(-A * TIME) / A)[signal]
    return resp, exact


# The cases of tests/test_time.py: (what, tolerance against the exact
# answer there).
CASES = {
    'dlf_sin': (lambda m: _kernel(m, 'dlf_sin'), 1e-7),
    'dlf_cos': (lambda m: _kernel(m, 'dlf_cos'), 1e-5),
    'fftlog_sin': (lambda m: _kernel(m, 'fftlog_sin'), 1e-3),
    'impulse_dlf': (lambda m: _fourier(m, 'dlf', 0), 1e-4),
    'switch_on_dlf': (lambda m: _fourier(m, 'dlf', 1), 1e-4),
    'switch_off_dlf': (lambda m: _fourier(m, 'dlf', -1), 1e-3),
    'impulse_fftlog': (lambda m: _fourier(m, 'fftlog', 0, pts_per_dec=30,
                                          add_dec=[-4, 3]), 1e-2),
    'band_limited': (lambda m: _fourier(m, 'dlf', 0, band=(5e-3, 50.)),
                     5e-2),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_transforms_match_jax(case):
    fn, tol = CASES[case]
    (gj, exact), (gp, _) = fn(jtime), fn(ptime)
    scale = np.abs(exact).max()
    assert np.max(np.abs(gp - gj)) / scale < 1e-12
    assert np.max(np.abs(gp - exact)) / scale < tol


def test_filter_cache_and_exports():
    b1, w1 = ptime.design_dlf_filter('sin')
    b2, w2 = ptime.design_dlf_filter('sin')
    assert b1 is b2 and w1 is w2
    bj, wj = jtime.design_dlf_filter('sin')
    assert np.array_equal(b1, bj) and np.max(np.abs(w1 - wj)) < 1e-12 * \
        np.abs(wj).max()
    assert pt.Fourier is ptime.Fourier is pt.utils.Fourier
    with pytest.raises(ValueError, match='mutually exclusive'):
        ptime.Fourier(TIME, 1e-2, 10.0, every_x_freq=2,
                      freq_inp=np.ones(3))


def _tdem(pkg, fourier):
    """x-directed dipole at the origin of an 8³ fullspace (800 m cells,
    1 Ω·m), 4 x-directed receivers 1-2 km along x, the frequencies of
    ``fourier``: one batched solve of 4 lanes."""
    grid = pkg.TensorMesh([np.full(8, 800.)] * 3, origin=(-3200.,) * 3)
    model = pkg.Model(grid, property_x=1.0, mapping='Resistivity')
    survey = pkg.Survey('tdem', (0., 0., 0., 0., 0.),
                        (np.linspace(1000., 2000., 4), 0., 0., 0., 0.),
                        fourier.freq_compute)
    opts = dict(sslsolver=False, semicoarsening=False,
                linerelaxation=False, tol=1e-10, verb=0)
    if pkg is pt:
        opts['device'] = 'cpu'
    sim = pkg.Simulation('tdem', survey, grid, model, gridding='same',
                         solver_opts=opts, verb=0)
    sim.compute()
    data = np.asarray(sim.data.synthetic)[0]          # (nrec, nfreq)
    return data, np.stack([fourier.freq2time(d) for d in data])


def test_time_domain_simulation_matches_jax():
    t = np.logspace(-1, 1, 5)
    fj = jtime.Fourier(t, fmin=0.01, fmax=10, signal=-1, every_x_freq=8)
    fp = ptime.Fourier(t, fmin=0.01, fmax=10, signal=-1, every_x_freq=8)
    assert fp.freq_compute.size == 4
    (dj, tj), (dp, tp) = _tdem(jt, fj), _tdem(pt, fp)
    assert np.isfinite(dp).all() and np.isfinite(tp).all()
    assert np.max(np.abs(dp - dj)) / np.max(np.abs(dj)) < 1e-7
    assert np.max(np.abs(tp - tj)) / np.max(np.abs(tj)) < 1e-7
