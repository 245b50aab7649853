"""Time-domain CSEM via frequency-domain solves + Fourier transform.

Copy of ``emg3d_tpu/time.py`` (numpy and scipy only), the counterpart
of the reference's ``utils.Fourier`` (emg3d/utils.py:189-600), which
delegates all transform machinery to empymod.  This module is fully
self-contained:

- **FFTLog** (Hamilton 2000): sine/cosine transforms on log-spaced
  samples via the analytic-kernel FFT method (sin/cos are the
  J_{±1/2} Hankel kernels).  Purely algorithmic — no filter tables.
- **DLF**: digital linear filter with an **in-house designed** filter:
  the sine/cosine filter weights are computed once by regularized
  least-squares collocation on analytic transform pairs (the direct
  matrix inversion design method of Kong 2007 / Key 2012), instead of
  shipping third-party coefficient tables.

The interpolation of computed -> required frequencies follows the
reference exactly: zeros above fmax, PCHIP below fmin anchored at
1e-100 Hz with the lowest computed real part, log-cubic spline within
[fmin, fmax].  A time-domain survey computes ``Fourier.freq_compute``
as the survey's frequencies (one batched solve with
``Simulation(gridding='same')``) and transforms each receiver's
spectrum with ``Fourier.freq2time``.
"""
import numpy as np
from scipy import interpolate as sint
from scipy.special import loggamma

__all__ = ['Fourier', 'fftlog_transform', 'design_dlf_filter',
           'dlf_transform', 'dlf_required_freqs']


# ----------------------------------------------------------------------
# FFTLog-style sine/cosine transform (Mellin-contour formulation)
# ----------------------------------------------------------------------
#
# g(t) = ∫_0^∞ f(ω) K(ωt) dω is a Mellin convolution; by Parseval,
# g(t) = t^{c-1}/(2π) ∫ e^{iηln t} F(c+iη) M_K(1-c-iη) dη, where F is
# the (FFT-approximated) Mellin transform of f on its log grid and
# M_K(z) = Γ(z)·sin/cos(πz/2) analytically.  The symmetric contour
# c = 1/2 avoids the Γ-poles; kernel products are evaluated in
# log-space to dodge the Γ-decay/cosh-growth overflow.

def _logsin(w):
    """Stable log(sin(w)) for complex w; -inf at the zeros of sin."""
    iw = 1j * w
    pos = np.imag(w) <= 0
    e1 = np.exp(np.where(pos, -2 * iw, 0))
    e2 = np.exp(np.where(pos, 0, 2 * iw))
    with np.errstate(divide='ignore', invalid='ignore'):
        return np.where(pos,
                        iw + np.log1p(-e1) - np.log(2j),
                        -iw + np.log1p(-e2) - np.log(-2j))


def _logcos(w):
    """Stable log(cos(w)) for complex w; -inf at the zeros of cos."""
    iw = 1j * w
    pos = np.imag(w) <= 0
    e1 = np.exp(np.where(pos, -2 * iw, 0))
    e2 = np.exp(np.where(pos, 0, 2 * iw))
    with np.errstate(divide='ignore', invalid='ignore'):
        return np.where(pos,
                        iw + np.log1p(e1) - np.log(2),
                        -iw + np.log1p(e2) - np.log(2))


def fftlog_transform(freq, fvals, time, kind='sin', c=0.5, pad=4):
    """g(t) = ∫_0^∞ f(ω) sin/cos(ωt) dω on log-spaced samples.

    freq : log-spaced frequencies (Hz); fvals : real samples of f at
    ω = 2πf;  time : output times.
    """
    w = 2 * np.pi * np.asarray(freq, dtype=np.float64)
    fv = np.asarray(fvals, dtype=np.float64)
    N = w.size
    dln = np.log(w[-1] / w[0]) / (N - 1)
    u0 = np.log(w[0])
    M = pad * N

    a = np.zeros(M)
    a[:N] = fv * w ** c
    eta = 2 * np.pi * np.fft.fftfreq(M, d=dln)
    F = dln * np.exp(1j * eta * u0) * np.conj(np.fft.fft(a))
    z = 1 - c - 1j * eta
    if kind == 'sin':
        MK = np.exp(loggamma(z) + _logsin(np.pi * z / 2))
    else:
        MK = np.exp(loggamma(z) + _logcos(np.pi * z / 2))
    deta = 2 * np.pi / (M * dln)

    time = np.atleast_1d(np.asarray(time, dtype=np.float64))
    out = np.empty(time.size)
    FM = F * MK
    for i, tt in enumerate(time):
        s = np.sum(np.exp(1j * eta * np.log(tt)) * FM)
        out[i] = np.real(tt ** (c - 1) * s * deta / (2 * np.pi))
    return out


# ----------------------------------------------------------------------
# In-house DLF filter design (direct matrix inversion method)
# ----------------------------------------------------------------------

_DLF_CACHE = {}


def design_dlf_filter(kind='sin', n=201, spd=12.5):
    """Design a sine/cosine DLF filter by least-squares collocation.

    The filter evaluates g(t) ≈ Σ_j f(b_j / t) W_j / t on the
    log-spaced base b_j = exp(j Δ), Δ = ln(10)/spd.  Weights W are fit
    (with Tikhonov regularization) against analytic transform pairs:

      sin:  ∫ ω/(1+ω²) sin(ωt) dω = (π/2) e^{-t}
            ∫ ω e^{-ω²} sin(ωt) dω = (√π/4) t e^{-t²/4}
      cos:  ∫ 1/(1+ω²) cos(ωt) dω = (π/2) e^{-t}
            ∫ e^{-ω²} cos(ωt) dω = (√π/2) e^{-t²/4}

    Returns (base, weights).
    """
    key = (kind, n, spd)
    if key in _DLF_CACHE:
        return _DLF_CACHE[key]

    dlt = np.log(10) / spd
    j = np.arange(n) - n // 2
    base = np.exp(j * dlt)

    # Collocation times spanning several decades.
    nt = 4 * n
    t = np.logspace(-4, 4, nt)

    if kind == 'sin':
        pairs = [
            (lambda w: w / (1 + w**2),
             lambda tt: np.pi / 2 * np.exp(-tt)),
            (lambda w: w * np.exp(-w**2),
             lambda tt: np.sqrt(np.pi) / 4 * tt * np.exp(-tt**2 / 4)),
        ]
    else:
        pairs = [
            (lambda w: 1 / (1 + w**2),
             lambda tt: np.pi / 2 * np.exp(-tt)),
            (lambda w: np.exp(-w**2),
             lambda tt: np.sqrt(np.pi) / 2 * np.exp(-tt**2 / 4)),
        ]

    rows = []
    rhs = []
    for ffun, gfun in pairs:
        A = ffun(base[None, :] / t[:, None])
        y = gfun(t) * t
        # Normalize rows to balance the pairs.
        scale = np.max(np.abs(y)) or 1.0
        rows.append(A / scale)
        rhs.append(y / scale)
    A = np.concatenate(rows, axis=0)
    y = np.concatenate(rhs)

    # Tikhonov-regularized least squares (smooth weights).
    lam = 1e-8 * np.linalg.norm(A, ord='fro')**2 / n
    AtA = A.T @ A + lam * np.eye(n)
    W = np.linalg.solve(AtA, A.T @ y)

    _DLF_CACHE[key] = (base, W)
    return base, W


def dlf_transform(fvals_at, time, kind='sin', n=201, spd=12.5):
    """g(t) = Σ_j f(b_j/t) W_j / t with the in-house filter.

    ``fvals_at(w)`` is a callable returning f at angular frequencies.
    """
    base, W = design_dlf_filter(kind, n, spd)
    time = np.atleast_1d(np.asarray(time, dtype=np.float64))
    out = np.empty(time.size)
    for i, t in enumerate(time):
        out[i] = np.dot(fvals_at(base / t), W) / t
    return out


def dlf_required_freqs(time, n=201, spd=12.5):
    """All angular frequencies the standard DLF evaluates for ``time``.

    Lagged-convolution style: a single log-lattice covering
    [b_min/t_max, b_max/t_min] with the filter's spacing.
    """
    base, _ = design_dlf_filter('sin', n, spd)
    time = np.asarray(time, dtype=np.float64)
    dlt = np.log(base[1] / base[0])
    wmin = base[0] / time.max()
    wmax = base[-1] / time.min()
    nf = int(np.ceil(np.log(wmax / wmin) / dlt)) + 1
    return wmin * np.exp(np.arange(nf) * dlt)


# ----------------------------------------------------------------------
# Fourier: the user-facing time-domain driver
# ----------------------------------------------------------------------

class Fourier:
    """Time-domain computation via frequency domain + Fourier transform.

    Parameters (reference parity: emg3d/utils.py:189-600)
    ----------
    time : ndarray
        Desired times (s).
    fmin, fmax : float
        Frequency band to actually compute; outside it the spectrum is
        interpolated/zeroed (see module docstring).
    signal : {0, 1, -1}
        Impulse (0), switch-on (1), or switch-off (-1) response.
    ft : {'sin', 'cos', 'dlf', 'fftlog'}
        Transform method ('dlf'/'sin' use the in-house sine filter).
    ftarg : dict
        'n'/'spd' for dlf; 'pts_per_dec' for fftlog (default 10).
    freq_inp : array, optional
        Frequencies to use for computation (mutually exclusive with
        every_x_freq).
    every_x_freq : int, optional
        Use every x-th of the required frequencies for computation.
    """

    def __init__(self, time, fmin, fmax, signal=0, ft='dlf', ftarg=None,
                 **kwargs):
        self._time = np.asarray(time, dtype=np.float64)
        self._fmin = fmin
        self._fmax = fmax
        self._signal = signal
        if ft == 'sin':
            ft = 'dlf'
        self._ft = ft
        self._ftarg = {} if ftarg is None else dict(ftarg)

        self._freq_inp = kwargs.pop('freq_inp', None)
        self._every_x_freq = kwargs.pop('every_x_freq', None)
        self.verb = kwargs.pop('verb', 3)
        if kwargs:
            raise TypeError(f"Unexpected **kwargs: {list(kwargs.keys())}")

        if self._freq_inp is not None and self._every_x_freq is not None:
            raise ValueError(
                "`freq_inp` and `every_x_freq` are mutually exclusive.")

        self._compute_required_freqs()

    def __repr__(self):
        return (f"Fourier: {self._ft}; {self.time.min()}-"
                f"{self.time.max()} s; {self.fmin}-{self.fmax} Hz")

    # -- properties ------------------------------------------------------

    @property
    def time(self):
        return self._time

    @property
    def fmin(self):
        return self._fmin

    @fmin.setter
    def fmin(self, fmin):
        self._fmin = fmin

    @property
    def fmax(self):
        return self._fmax

    @fmax.setter
    def fmax(self, fmax):
        self._fmax = fmax

    @property
    def signal(self):
        return self._signal

    @property
    def ft(self):
        return self._ft

    @property
    def ftarg(self):
        return self._ftarg

    @property
    def freq_req(self):
        """Frequencies required for the Fourier transform."""
        return self._freq_req

    @property
    def freq_inp(self):
        return self._freq_inp

    @property
    def every_x_freq(self):
        return self._every_x_freq

    @property
    def freq_coarse(self):
        """The frequencies actually computed (subset of freq_req)."""
        if self._freq_inp is not None:
            return np.asarray(self._freq_inp, dtype=np.float64)
        if self._every_x_freq is not None:
            return self.freq_req[::int(self._every_x_freq)]
        return self.freq_req

    @property
    def freq_compute(self):
        """freq_coarse limited to [fmin, fmax] — the solver's work."""
        fc = self.freq_coarse
        return fc[(fc >= self.fmin) & (fc <= self.fmax)]

    @property
    def freq_extrapolate(self):
        fc = self.freq_req
        return fc[fc < self.fmin]

    @property
    def freq_interpolate(self):
        fc = self.freq_req
        return fc[fc > self.fmax]

    # -- machinery -------------------------------------------------------

    def _compute_required_freqs(self):
        if self._ft == 'fftlog':
            ppd = self._ftarg.get('pts_per_dec', 10)
            add = self._ftarg.get('add_dec', [-2, 1])
            tmin, tmax = self.time.min(), self.time.max()
            lmin = np.log10(1 / (2 * np.pi * tmax)) + add[0]
            lmax = np.log10(1 / (2 * np.pi * tmin)) + add[1]
            nf = int(np.ceil((lmax - lmin) * ppd)) + 1
            self._freq_req = np.logspace(lmin, lmax, nf)
        else:
            n = self._ftarg.get('n', 201)
            spd = self._ftarg.get('spd', 12.5)
            w = dlf_required_freqs(self.time, n=n, spd=spd)
            self._freq_req = w / (2 * np.pi)

    def interpolate(self, fdata):
        """Interpolate computed (freq_compute) data to freq_req.

        Reference parity: emg3d/utils.py:469-518.
        """
        freq_compute = self.freq_compute
        fdata = np.asarray(fdata)

        out = np.zeros(self.freq_req.size, dtype=complex)

        # In-band: cubic spline on log-f.
        band = ((self.freq_req >= self.fmin) &
                (self.freq_req <= self.fmax))
        if freq_compute.size > 3:
            re = sint.InterpolatedUnivariateSpline(
                np.log(freq_compute), fdata.real, k=3)
            im = sint.InterpolatedUnivariateSpline(
                np.log(freq_compute), fdata.imag, k=3)
            out[band] = re(np.log(self.freq_req[band])) + \
                1j * im(np.log(self.freq_req[band]))
        else:
            re = np.interp(np.log(self.freq_req[band]),
                           np.log(freq_compute), fdata.real)
            im = np.interp(np.log(self.freq_req[band]),
                           np.log(freq_compute), fdata.imag)
            out[band] = re + 1j * im

        # Below fmin: PCHIP anchored at 1e-100 Hz with real-part value.
        below = self.freq_req < self.fmin
        if np.any(below):
            anchor_f = 1e-100
            xs = np.r_[np.log(anchor_f), np.log(freq_compute)]
            re_ = sint.pchip_interpolate(
                xs, np.r_[fdata.real[0], fdata.real],
                np.log(self.freq_req[below]))
            im_ = sint.pchip_interpolate(
                xs, np.r_[0.0, fdata.imag],
                np.log(self.freq_req[below]))
            out[below] = re_ + 1j * im_

        # Above fmax: zero (already).
        return out

    def freq2time(self, fdata, off=None):
        """Transform a frequency spectrum (at freq_compute) to time.

        Returns the time-domain response at ``self.time``.
        """
        full = self.interpolate(fdata)
        w_req = 2 * np.pi * self.freq_req

        if self.signal == 0:
            kernel = -2 / np.pi * full.imag
            kind = 'sin'
        elif self.signal == 1:
            kernel = 2 / np.pi * full.real / w_req
            kind = 'sin'
        else:  # -1 switch-off: DC - switch-on.
            kernel = 2 / np.pi * full.real / w_req
            kind = 'sin'

        if self._ft == 'fftlog':
            resp = fftlog_transform(self.freq_req, kernel, self.time,
                                    kind=kind)
        else:
            n = self._ftarg.get('n', 201)
            spd = self._ftarg.get('spd', 12.5)
            lnw = np.log(w_req)

            def at(wq):
                wq = np.clip(wq, w_req[0], w_req[-1])
                return np.interp(np.log(wq), lnw, kernel)

            itp_re = sint.InterpolatedUnivariateSpline(
                lnw, kernel, k=3, ext=3)

            def at_spline(wq):
                wq = np.clip(wq, w_req[0], w_req[-1])
                return itp_re(np.log(wq))

            resp = dlf_transform(at_spline, self.time, kind=kind,
                                 n=n, spd=spd)
            # dlf returns ∫ kernel(w) sin(wt) dw without the 2/pi --
            # the 2/pi is already inside `kernel`.

        if self.signal == -1:
            dc = float(np.real(full[0]))
            resp = dc - resp
        return resp
