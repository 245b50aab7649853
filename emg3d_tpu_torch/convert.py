"""State carried between the JAX package and the port, as numpy arrays.

The port never imports ``emg3d_tpu``.  These helpers take the JAX
package's state as plain numpy arrays (or objects with the same
attributes) and turn it into the port's tensors and host objects on a
given device, and back.  The tests use them to feed both packages
identical inputs.
"""
import numpy as np
import torch

from .dtypes import COMPLEX, REAL, REAL_OF, to_storage
from .meshes import TensorMesh
from .models import Model
from .ops.smoothers import LINE_BKEYS, NLINE

__all__ = ['params_to_torch', 'params_to_numpy', 'fields_to_torch',
           'fields_to_numpy', 'mesh_to_torch', 'mesh_to_numpy',
           'model_to_torch', 'model_to_numpy', 'line_factors_to_torch',
           'line_factors_to_numpy', 'line_stack_entries', 'pair_to_torch',
           'tensor_to_pair']


def _tensor(a, dtype, device):
    # torch.tensor copies: the solver updates its tensors in place and
    # must never write into the caller's numpy buffers.
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def params_to_torch(params, device='cpu', dtype=COMPLEX):
    """A level's ``(eta_x, eta_y, eta_z, zeta, hx, hy, hz)`` as tensors.

    η becomes ``dtype`` (complex128, or complex64), ζ and the widths its
    real dtype.  Where eta_y or eta_z is the same object as eta_x
    (isotropic and HTI/VTI models), the tensors are shared too, as in
    build_levels.
    """
    real = REAL_OF[dtype]
    eta_x, eta_y, eta_z, zeta, hx, hy, hz = params
    ex = _tensor(eta_x, dtype, device)
    ey = ex if eta_y is eta_x else _tensor(eta_y, dtype, device)
    ez = ex if eta_z is eta_x else _tensor(eta_z, dtype, device)
    return (ex, ey, ez, *(_tensor(a, real, device)
                          for a in (zeta, hx, hy, hz)))


def params_to_numpy(params):
    return tuple(t.detach().cpu().numpy() for t in params)


def fields_to_torch(fields, device='cpu', dtype=COMPLEX):
    """Edge components ``(fx, fy, fz)`` as (copied) tensors."""
    return tuple(_tensor(f, dtype, device) for f in fields)


def fields_to_numpy(fields):
    return tuple(t.detach().cpu().numpy() for t in fields)


def mesh_to_torch(mesh):
    """The port's TensorMesh from anything with ``h`` and ``origin``."""
    return TensorMesh([np.asarray(h, dtype=np.float64) for h in mesh.h],
                      origin=np.asarray(mesh.origin, dtype=np.float64))


def mesh_to_numpy(mesh):
    return {'h': [np.array(h) for h in mesh.h],
            'origin': np.array(mesh.origin)}


def model_to_torch(model):
    """The port's Model from a model's ``to_dict()`` (or that dict)."""
    inp = model if isinstance(model, dict) else model.to_dict()
    inp = dict(inp)
    grid = inp.get('grid')
    if grid is not None and not isinstance(grid, dict):
        inp['grid'] = mesh_to_torch(grid)
    return Model.from_dict(inp)


def model_to_numpy(model):
    """A model as the dict its ``from_dict`` (in either package) takes."""
    return model.to_dict(copy=True)


def line_factors_to_torch(L_all, d_all, Bent, device='cpu', storage=None):
    """The port's line factor stack from the JAX package's entries.

    ``L_all`` (10 strict-lower LDLᵀ entries), ``d_all`` (5 inverse
    diagonals) and ``Bent`` (dict of the 8 B entries) are ``(S, ny-1,
    nz-1)`` arrays, as ``block_tridiag_factor_entries`` of
    ``_line_entries_x`` returns them (or :func:`line_stack_entries` of a
    Pallas stack).  Returns the ``(S, NLINE, 2, 2, ny2, nz2)`` complex128
    stack of ``ops.smoothers.line_factor_stack``; padded lines get
    identity factors (dinv 1, L and B 0).  With ``storage``
    ``torch.bfloat16`` it returns the port's bfloat16 stack of the
    entries rounded to bfloat16, ``(..., nz2, 2)``: exactly the values of
    a JAX stack built with ``line_factors(..., fdtype=jnp.bfloat16)``.
    """
    planes = [*L_all, *d_all, *(Bent[k] for k in LINE_BKEYS)]
    S, nyn, nzn = np.shape(planes[0])
    ny2, nz2 = -(-nyn // 2), -(-nzn // 2)
    full = np.zeros((S, NLINE, 2 * ny2, 2 * nz2), dtype=np.complex128)
    full[:, 10:15] = 1.0
    for p, v in enumerate(planes):
        full[:, p, :nyn, :nzn] = np.broadcast_to(np.asarray(v),
                                                 (S, nyn, nzn))
    quarters = full.reshape(S, NLINE, ny2, 2, nz2, 2).transpose(
        0, 1, 3, 5, 2, 4)
    if storage is not None:
        # Every bfloat16 value is a float32 one: round from complex64.
        return to_storage(torch.tensor(np.ascontiguousarray(quarters),
                                       dtype=torch.complex64,
                                       device=device), storage)
    return torch.tensor(np.ascontiguousarray(quarters), dtype=COMPLEX,
                        device=device)


def line_stack_entries(stack, shape):
    """``(L_all, d_all, Bent)`` of the JAX package's padded Pallas factor
    stack ``(S, 46, Yp, Zp)`` (``pallas_lr.line_factors``: each entry's
    real and imaginary plane in turn, L in ``_LORD``, the inverse
    diagonal, B in ``_BORD`` = LINE_BKEYS order; line (j, k) at padded
    index (j, k)), as complex128 ``(S, ny-1, nz-1)`` arrays.  ``stack`` is
    numpy of any real dtype (a bfloat16 stack as float32, exactly);
    ``shape`` the cell shape of the frame whose x-lines it solves."""
    _, ny, nz = shape
    a = np.asarray(stack, dtype=np.float64)[:, :, 1:ny, 1:nz]
    planes = [a[:, 2 * p] + 1j * a[:, 2 * p + 1] for p in range(NLINE)]
    return (planes[:10], planes[10:15], dict(zip(LINE_BKEYS, planes[15:])))


def line_factors_to_numpy(fac, shape):
    """Inverse of :func:`line_factors_to_torch`: ``(L_all, d_all, Bent)``.

    ``shape`` is the cell shape of the frame whose x-lines the stack
    solves (the rotated frame for y/z-lines).
    """
    _, ny, nz = shape
    a = fac.detach().cpu().numpy()
    S, n, _, _, ny2, nz2 = a.shape
    full = a.transpose(0, 1, 4, 2, 5, 3).reshape(S, n, 2 * ny2, 2 * nz2)
    planes = [np.ascontiguousarray(full[:, p, :ny - 1, :nz - 1])
              for p in range(n)]
    return (planes[:10], planes[10:15],
            dict(zip(LINE_BKEYS, planes[15:])))


def pair_to_torch(pair, device='cpu'):
    """A split (re, im) pair as one complex128 tensor.

    ``pair`` is the JAX package's ``cx.C2`` as numpy (anything with
    ``re`` and ``im``) or a 2-tuple of real arrays.
    """
    re, im = (pair.re, pair.im) if hasattr(pair, 're') else pair
    return torch.complex(_tensor(re, REAL, device), _tensor(im, REAL, device))


def tensor_to_pair(t):
    """A complex tensor (a field, or a gradient in PyTorch's convention
    ∂L/∂Re + i·∂L/∂Im) as the JAX package's (re, im) numpy pair."""
    a = t.detach().resolve_conj().cpu().numpy()
    return np.ascontiguousarray(a.real), np.ascontiguousarray(a.imag)
