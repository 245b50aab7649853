"""The plain reference that decides ``correct``.

What the solver is to satisfy, worked out again from the inputs the
benchmark makes: the volume-scaled parameters η and ζ of the model at a
frequency, the source vector of a dipole, and the residual s − A e of a
field.  Plain NumPy and PyTorch (and SciPy's constants); nothing of the
program under test is imported or called.
"""
from .system import (eta_zeta, source_field, residual_norms,
                     relative_residuals)

__all__ = ['eta_zeta', 'source_field', 'residual_norms',
           'relative_residuals']
