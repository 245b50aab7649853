"""Cross-cutting utilities: EMArray, Time, Report.

Counterpart of ``emg3d_tpu/utils.py``.  ``Report`` lists the torch and
CUDA versions and devices instead of JAX's.  The time-domain
``Fourier`` machinery lives in :mod:`emg3d_tpu_torch.time`.
"""
import warnings
from datetime import datetime, timezone
from timeit import default_timer

import numpy as np

__all__ = ['EMArray', 'Time', 'Report']


class EMArray(np.ndarray):
    """ndarray subclass with amplitude (amp) and phase (pha) methods."""

    def __new__(cls, data):
        return np.asarray(data).view(cls)

    def amp(self):
        """Amplitude of the electromagnetic field."""
        return np.abs(self.view())

    def pha(self, deg=False, unwrap=True, lag=True):
        """Phase of the electromagnetic field.

        deg : degrees instead of radians; unwrap : unwrap phase;
        lag : lag (True) or lead (False) convention.
        """
        if lag:
            pha = np.angle(self.view())
        else:
            pha = np.angle(np.conj(self.view()))
        if unwrap and self.size > 1:
            pha = EMArray(np.unwrap(pha))
        if deg:
            pha = pha * (180 / np.pi)
        return pha


class Time:
    """Wall-clock timer."""

    def __init__(self):
        self._t0 = default_timer()
        self._now = datetime.now(timezone.utc)

    @property
    def t0(self):
        return self._t0

    @property
    def now(self):
        return datetime.now(timezone.utc).strftime('%H:%M:%S')

    @property
    def runtime(self):
        """Elapsed time as H:MM:SS string."""
        return str(np.timedelta64(int(self.elapsed), 's')).replace(
            ' seconds', 's')

    @property
    def elapsed(self):
        return default_timer() - self._t0


class Report:
    """Version/environment report (torch, CUDA and the visible cards)."""

    def __init__(self, add_pckg=None, ncol=3, text_width=80, sort=False):
        import sys
        import scipy
        import torch
        cuda = torch.cuda.is_available()
        devices = ([torch.cuda.get_device_name(i)
                    for i in range(torch.cuda.device_count())]
                   if cuda else ['cpu'])
        self.lines = [
            f"date    : {datetime.now().isoformat(timespec='seconds')}",
            f"python  : {sys.version.split()[0]}",
            f"numpy   : {np.__version__}",
            f"scipy   : {scipy.__version__}",
            f"torch   : {torch.__version__}",
            f"cuda    : {torch.version.cuda}",
            f"devices : {devices}",
        ]
        try:
            from . import __version__
            self.lines.insert(0, f"emg3d_tpu_torch : {__version__}")
        except ImportError:
            pass

    def __repr__(self):
        bar = '-' * 60
        return '\n'.join([bar] + self.lines + [bar])

    def _repr_html_(self):
        rows = ''.join(f"<tr><td>{ln}</td></tr>" for ln in self.lines)
        return f"<table>{rows}</table>"


def _process_warning(msg):
    warnings.warn(msg, UserWarning)


# Reference-parity alias: the reference exposes the time-domain driver
# as utils.Fourier (emg3d/utils.py:189); ours lives in .time.
from .time import Fourier  # noqa: E402,F401
