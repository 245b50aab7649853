"""Precision policy: the solve's precision follows its source field.

Counterpart of ``emg3d_tpu/dtypes.py``, which follows JAX's global x64
flag.  The port has no such flag: host arrays default to
float64/complex128 numpy and device tensors to float64/complex128 torch
(:data:`REAL`, :data:`COMPLEX`), the precision the JAX package's CPU
tests pin; the H100 has fp64 in hardware.  A complex64 (or float32)
source field asks for a solve in complex64/float32 on the device, the
precision of the JAX package's production path and of its Pallas
kernels, as its ``_SolveContext`` derives the precision from the
source (``emg3d_tpu/solver.py:1349-1363``): :func:`precision`.
"""
import numpy as np
import torch

REAL = torch.float64
COMPLEX = torch.complex128
# The real dtype of each complex dtype a solve runs in.
REAL_OF = {torch.complex128: torch.float64, torch.complex64: torch.float32}


def real_dtype():
    """Host (numpy) real dtype."""
    return np.dtype(np.float64)


def complex_dtype(real=None):
    """Complex numpy dtype matching ``real`` (default float64)."""
    if real is None:
        real = real_dtype()
    return np.result_type(real, np.complex64)


def precision(dtype):
    """The device (real, complex) torch dtypes of a solve whose source
    field has the numpy ``dtype``: (float32, complex64) for complex64
    and float32 sources, else (float64, complex128)."""
    if np.dtype(dtype) in (np.dtype(np.complex64), np.dtype(np.float32)):
        return torch.float32, torch.complex64
    return REAL, COMPLEX


def complex_size(dtype):
    """Bytes of one element of a solve's complex ``dtype`` (complex128:
    16, complex64: 8); any other dtype raises."""
    if dtype not in REAL_OF:
        raise ValueError(f"the solve runs in complex128 or complex64; got "
                         f"{dtype}")
    return 16 if dtype == torch.complex128 else 8
