"""State carried between the JAX package and the port, as numpy arrays.

The port never imports ``emg3d_tpu``.  These helpers take the JAX
package's state as plain numpy arrays (or objects with the same
attributes) and turn it into the port's tensors and host objects on a
given device, and back.  The tests use them to feed both packages
identical inputs.
"""
import numpy as np
import torch

from .dtypes import COMPLEX, REAL
from .meshes import TensorMesh
from .models import Model

__all__ = ['params_to_torch', 'params_to_numpy', 'fields_to_torch',
           'fields_to_numpy', 'mesh_to_torch', 'mesh_to_numpy',
           'model_to_torch', 'model_to_numpy']


def _tensor(a, dtype, device):
    # torch.tensor copies: the solver updates its tensors in place and
    # must never write into the caller's numpy buffers.
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def params_to_torch(params, device='cpu'):
    """A level's ``(eta_x, eta_y, eta_z, zeta, hx, hy, hz)`` as tensors.

    η becomes complex128, ζ and the widths float64.  Where eta_y or
    eta_z is the same object as eta_x (isotropic and HTI/VTI models),
    the tensors are shared too, as in build_levels.
    """
    eta_x, eta_y, eta_z, zeta, hx, hy, hz = params
    ex = _tensor(eta_x, COMPLEX, device)
    ey = ex if eta_y is eta_x else _tensor(eta_y, COMPLEX, device)
    ez = ex if eta_z is eta_x else _tensor(eta_z, COMPLEX, device)
    return (ex, ey, ez, *(_tensor(a, REAL, device)
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
