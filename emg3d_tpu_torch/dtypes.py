"""Precision policy: complex128/float64 throughout.

Counterpart of ``emg3d_tpu/dtypes.py``, which follows JAX's global x64
flag.  The port has no such flag: host arrays are float64/complex128
numpy and device tensors float64/complex128 torch, always.  The H100
has fp64 in hardware, and this is the precision the JAX package's CPU
tests pin.
"""
import numpy as np
import torch

REAL = torch.float64
COMPLEX = torch.complex128


def real_dtype():
    """Host (numpy) real dtype."""
    return np.dtype(np.float64)


def complex_dtype(real=None):
    """Complex numpy dtype matching ``real`` (default float64)."""
    if real is None:
        real = real_dtype()
    return np.result_type(real, np.complex64)

