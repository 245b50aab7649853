"""Precision policy: the x64 switch, and the source field's dtype.

Counterpart of ``emg3d_tpu/dtypes.py``, which follows JAX's global x64
flag.  The port has its own switch (:func:`set_x64`, :func:`x64`), a
plain process-wide value as JAX's flag is:

- **on** (the default): host arrays default to float64/complex128 numpy
  and device tensors to float64/complex128 torch (:data:`REAL`,
  :data:`COMPLEX`), the precision the JAX package's CPU tests pin; the
  H100 has fp64 in hardware.  A complex64 (or float32) source field
  still asks for a solve in complex64/float32 (:func:`precision`), as
  the JAX package's ``_SolveContext`` keeps a complex64 source with x64
  on (``emg3d_tpu/solver.py:1349-1366``).
- **off**: :func:`real_dtype`/:func:`complex_dtype` are float32 and
  complex64 (default fields, as ``Field.zeros``), and every solve runs
  in complex64/float32 whatever its source's dtype: the JAX package's
  ``jnp.asarray`` of the source then canonicalizes a complex128 source
  to complex64.  Sources, data and gradients stay complex128/float64
  where numpy promotes them so, as in the JAX package.

This is the one difference between the packages: JAX's flag is off
unless a program turns it on, the port's switch is on unless a program
turns it off.  A solve reads the switch once, when it starts.

A complex64 solve may also *store* some of its field-independent
streams in bfloat16 (:data:`BF16`), as the JAX package's Pallas path
does (``pack_params(pdtype=)``, ``pack_fields(sdtype=)``,
``line_factors(fdtype=)``): values are computed in float32, rounded to
bfloat16 once when stored, and upcast exactly where a kernel loads them.
torch has no complex bfloat16, so a complex bfloat16 tensor is a
``torch.bfloat16`` tensor with a trailing (re, im) axis of 2
(:func:`to_storage`), the layout of one ``__nv_bfloat162`` per complex
number in CUDA.  The rounding is round-to-nearest-even in torch
(``Tensor.to``), in CUDA (``__float22bfloat162_rn``) and in JAX
(``astype``), so the same float32 values give the same bfloat16 bits.
"""
import contextlib

import numpy as np
import torch

REAL = torch.float64
COMPLEX = torch.complex128
# The real dtype of each complex dtype a solve runs in.
REAL_OF = {torch.complex128: torch.float64, torch.complex64: torch.float32}
# The reduced storage dtype of a complex64 solve's streams.
BF16 = torch.bfloat16


_X64 = True


def set_x64(enabled):
    """Turns the x64 switch on or off (process-wide)."""
    global _X64
    _X64 = bool(enabled)


def x64_enabled():
    """Whether the x64 switch is on."""
    return _X64


@contextlib.contextmanager
def x64(enabled):
    """The x64 switch set to ``enabled`` inside the block, and restored
    to its old value on exit (also on an exception)."""
    old = _X64
    set_x64(enabled)
    try:
        yield
    finally:
        set_x64(old)


def real_dtype():
    """Host (numpy) real dtype: float64, or float32 with x64 off."""
    return np.dtype(np.float64 if _X64 else np.float32)


def complex_dtype(real=None):
    """Complex numpy dtype matching ``real`` (default
    :func:`real_dtype`)."""
    if real is None:
        real = real_dtype()
    return np.result_type(real, np.complex64)


def precision(dtype):
    """The device (real, complex) torch dtypes of a solve whose source
    field has the numpy ``dtype``: (float32, complex64) with x64 off or
    for complex64 and float32 sources, else (float64, complex128)."""
    if not _X64 or np.dtype(dtype) in (np.dtype(np.complex64),
                                       np.dtype(np.float32)):
        return torch.float32, torch.complex64
    return REAL, COMPLEX


def complex_size(dtype):
    """Bytes of one element of a solve's complex ``dtype`` (complex128:
    16, complex64: 8); any other dtype raises."""
    if dtype not in REAL_OF:
        raise ValueError(f"the solve runs in complex128 or complex64; got "
                         f"{dtype}")
    return 16 if dtype == torch.complex128 else 8


def check_storage(dtype, storage):
    """Raises unless ``storage`` is None, or :data:`BF16` for a complex64
    (or float32) ``dtype``: bfloat16 storage is for complex64 solves."""
    if storage not in (None, BF16):
        raise ValueError(f"storage {storage}: None or {BF16}")
    if storage is not None and dtype not in (torch.complex64, torch.float32):
        raise ValueError(f"bfloat16 storage is for complex64 solves; got "
                         f"{dtype}")


def storage_of(t):
    """The storage dtype of a stream tensor: :data:`BF16` for a
    bfloat16 one, else None (stored in the solve's own precision)."""
    return BF16 if t.dtype == BF16 else None


def to_storage(t, storage):
    """``t`` (complex64 or float32) stored in ``storage``: for
    :data:`BF16` a new contiguous bfloat16 tensor, complex ``t`` with a
    trailing (re, im) axis of 2; for None ``t`` itself."""
    if storage is None:
        return t
    if storage != BF16:
        raise ValueError(f"storage {storage}: None or {BF16}")
    if t.dtype not in (torch.complex64, torch.float32):
        raise ValueError(f"bfloat16 storage holds complex64/float32 "
                         f"values; got {t.dtype}")
    src = torch.view_as_real(t) if t.is_complex() else t
    return src.to(BF16, memory_format=torch.contiguous_format)


def from_storage(t, complex_=False):
    """The values of a stored tensor, exactly: a bfloat16 ``t`` as
    float32, or as complex64 where ``complex_`` (its trailing (re, im)
    axis folded); any other tensor as it is."""
    if t.dtype != BF16:
        return t
    f = t.float()
    return torch.view_as_complex(f) if complex_ else f


def round_to(t, storage):
    """``t`` rounded through ``storage`` and back, in its own dtype: what
    a kernel computes with after loading the stored ``t``."""
    if storage is None:
        return t
    return from_storage(to_storage(t, storage), t.is_complex())
