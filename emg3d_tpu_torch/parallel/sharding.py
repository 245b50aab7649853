"""Spatial domain decomposition over a mesh of ranks.

Counterpart of ``emg3d_tpu/parallel/sharding.py``.  The JAX package
annotates shardings and lets GSPMD partition every op of a level; PyTorch
has no such compiler, so the port runs SPMD over processes: one rank per
GPU, each holding a y/z slab of every sharded level with explicit halo
exchanges (:mod:`.halo`).  This module makes the mesh, the ``sharding``
option of ``solve`` and the slab layout of a level.

A level is distributed while every rank keeps at least
``min_local_planes`` cells along each sharded axis (the JAX package's
agglomeration rule, ``emg3d_tpu/solver.py:870-888``); coarser levels are
replicated on every rank.
"""
import math

import torch
import torch.distributed as dist

__all__ = ['make_mesh', 'field_sharding', 'shard_solve_options',
           'distribute_field', 'mesh_sizes']

VALID_AXES = (('y',), ('z',), ('y', 'z'))


def _device_type():
    """The mesh's device type follows the backend: NCCL meshes are CUDA
    meshes, gloo meshes CPU meshes (gloo moves host tensors)."""
    return 'cuda' if dist.get_backend() == 'nccl' else 'cpu'


def make_mesh(n_devices=None, axes=('z',)):
    """A 1-D (or 2-D) ``DeviceMesh`` of the process group's ranks.

    axes : the grid axes to partition, ``('z',)``, ``('y',)`` or
        ``('y', 'z')``; the mesh dimensions carry their names.  A 2-D
        mesh takes the JAX package's factorisation: ny the largest
        divisor of ``n_devices`` not above its square root.
    n_devices : the mesh's size, by default (and at most) the world
        size; the mesh holds ranks 0 .. n_devices-1.
    """
    from torch.distributed.device_mesh import init_device_mesh
    axes = tuple(axes)
    if axes not in VALID_AXES:
        raise ValueError(f"axes must be one of {VALID_AXES}; got {axes}")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 0 < n <= world:
        raise ValueError(f"n_devices {n}: the process group has {world} "
                         "ranks")
    if len(axes) == 1:
        shape = (n,)
    else:
        ny = math.isqrt(n)
        while n % ny:
            ny -= 1
        shape = (ny, n // ny)
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def mesh_sizes(mesh):
    """{axis name: ranks along it} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def field_sharding(mesh, shape):
    """The slab layout of a level of cell shape ``shape`` on ``mesh``,
    for this rank: which grid axes are sharded, and which node and cell
    planes it owns along each, as half-open ranges of global indices:
    ``{'axes': (1, 2), 'nodes': {ax: (a, b)}, 'cells': {ax: (a, c)}}``.
    (A solve nests the partition of its sharded levels into the coarsest
    one, :func:`.halo.partition`; this is a level split alone.)
    """
    from .halo import Slab, partition
    slab = Slab(tuple(shape), mesh, partition(mesh, [tuple(shape)])[0])
    return {'axes': slab.axes,
            'nodes': {ax: slab.owned[ax] for ax in slab.axes},
            'cells': {ax: slab.owned_cells(ax) for ax in slab.axes}}


def shard_solve_options(mesh, min_local_planes=4):
    """The ``sharding`` option for :func:`emg3d_tpu_torch.solve`."""
    return {'mesh': mesh, 'min_local_planes': int(min_local_planes)}


def distribute_field(field, mesh):
    """A host Field's components as ``DTensor``s sharded over the mesh.

    Each component is split along the grid axes the mesh names (y:
    ``Shard(1)``, z: ``Shard(2)``) and keeps its global shape, as the JAX
    package's global arrays do.  Every rank of the mesh calls it with the
    same field.  (The solver cuts its own haloed slabs; this is the
    layout for user code that works with ``DTensor``.)
    """
    import numpy as np
    from torch.distributed.tensor import Shard, distribute_tensor
    grid_axis = {'y': 1, 'z': 2}
    placements = [Shard(grid_axis[name]) for name in mesh.mesh_dim_names]
    dev = mesh.device_type

    def put(a):
        t = torch.as_tensor(np.ascontiguousarray(a)).to(dev)
        return distribute_tensor(t, mesh, placements)

    return tuple(put(f) for f in (field.fx, field.fy, field.fz))


# ``constrain`` of the JAX package (emg3d_tpu/parallel/sharding.py:100-117)
# places GSPMD sharding annotations inside jitted code.  PyTorch has no
# such compiler pass: every op of a sharded level runs on explicit slabs
# with explicit halo exchanges (.halo), so it is not carried over.
