"""Shared inputs for the emg3d_tpu_torch parity tests.

Every input is made by numpy from a seed and handed to both packages:
the JAX package (``emg3d_tpu``) as numpy/jax arrays, the port
(``emg3d_tpu_torch``) through ``emg3d_tpu_torch.convert``.
"""
import numpy as np
import torch


def level(jt, shape, seed, aniso=True):
    """A random stretched (tri-axial) level in both packages.

    Returns ``(grid_jax, params_np)``: the JAX mesh and the level's
    numpy ``(eta_x, eta_y, eta_z, zeta, hx, hy, hz)`` in complex128 /
    float64.
    """
    rng = np.random.default_rng(seed)
    grid = jt.TensorMesh([rng.uniform(50, 150, n) for n in shape],
                         origin=(0., 0., 0.))
    rho = [rng.uniform(0.3, 30, shape) for _ in range(3 if aniso else 1)]
    model = jt.Model(grid, *rho)
    sfield = jt.SourceField.zeros(grid, frequency=0.9)
    vm = jt.VolumeModel(grid, model, sfield)
    params = (np.asarray(vm.eta_x), np.asarray(vm.eta_y),
              np.asarray(vm.eta_z), np.asarray(vm.zeta),
              *[np.asarray(h) for h in grid.h])
    return grid, params


def edge_shapes(shape):
    nx, ny, nz = shape
    return ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
            (nx + 1, ny + 1, nz))


def random_fields(shape, seed):
    """Random complex128 edge fields (numpy) of a cell shape."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(sh) + 1j * rng.standard_normal(sh)
                 for sh in edge_shapes(shape))


def to_jax(arrays):
    import jax.numpy as jnp
    return tuple(jnp.asarray(a) for a in arrays)


def rel(a, b):
    """max |a − b| / max |b| over matching component sequences."""
    a = [np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                    else x) for x in a]
    b = [np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                    else x) for x in b]
    num = max(float(np.max(np.abs(x - y))) if x.size else 0.0
              for x, y in zip(a, b))
    den = max(float(np.max(np.abs(y))) if y.size else 0.0 for y in b)
    return num / den
