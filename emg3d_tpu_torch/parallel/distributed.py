"""Multi-process initialization on ``torch.distributed``.

Counterpart of ``emg3d_tpu/parallel/distributed.py``.  PyTorch runs one
process per GPU: :func:`init` joins this process to a process group,
and :func:`emg3d_tpu_torch.parallel.make_mesh` lays the group's ranks
out as a ``DeviceMesh`` over the grid's y and z axes.  Every rank then
calls ``solve`` with the same arguments and keeps its slab (see
:mod:`emg3d_tpu_torch.parallel.halo`).

Configuration is by explicit arguments or environment, with the JAX
package's names:

- ``EMG3D_TPU_COORD``     — rendezvous address, ``host:port``.
- ``EMG3D_TPU_NPROC``     — number of processes (the world size).
- ``EMG3D_TPU_PROC_ID``   — this process's rank (0-based).

Without a coordinator address :func:`init` takes ``torch.distributed``'s
own environment (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``: what ``torchrun`` sets).  A process that sets none of
the three should not call ``init``; :func:`auto_init` does exactly that
gate and is safe to call unconditionally.

The backend is NCCL, and :func:`init` raises where CUDA is absent; the
CPU (gloo, which moves host tensors) is asked for by name,
``backend='gloo'``, as ``device='cpu'`` is on ``solve``.
"""
import os

import torch
import torch.distributed as dist

__all__ = ['init', 'auto_init', 'is_initialized', 'shutdown',
           'global_mesh', 'process_count', 'process_index']

_STATE = {'initialized': False}
BACKENDS = ('nccl', 'gloo')


def is_initialized():
    return _STATE['initialized']


def init(coordinator_address=None, num_processes=None, process_id=None,
         local_device_ids=None, backend='nccl'):
    """Join this process to the process group (idempotent).

    ``coordinator_address`` (``host:port``) becomes the rendezvous
    ``tcp://host:port``; ``num_processes`` and ``process_id`` the world
    size and rank.  ``local_device_ids`` names the CUDA device of this
    process (its first entry; default: rank modulo the visible devices).
    ``backend`` is ``'nccl'`` (the default; needs CUDA) or ``'gloo'``.
    """
    if _STATE['initialized']:
        return
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == 'nccl' and not torch.cuda.is_available():
        raise RuntimeError(
            "emg3d_tpu_torch.parallel.init uses NCCL by default, and no "
            "CUDA device is available; pass backend='gloo' to run the "
            "process group on the CPU.")
    if not dist.is_initialized():
        kw = {}
        if coordinator_address is not None:
            kw['init_method'] = f'tcp://{coordinator_address}'
        if num_processes is not None:
            kw['world_size'] = int(num_processes)
        if process_id is not None:
            kw['rank'] = int(process_id)
        if backend == 'nccl':
            rank = int(process_id if process_id is not None
                       else os.environ.get('RANK', 0))
            dev = (local_device_ids[0] if local_device_ids
                   else rank % torch.cuda.device_count())
            torch.cuda.set_device(int(dev))
        dist.init_process_group(backend=backend, **kw)
    _STATE['initialized'] = True


def auto_init(backend='nccl'):
    """Call :func:`init` iff the EMG3D_TPU_* environment is present.

    Safe to call unconditionally; a plain single-process run is
    untouched.  Returns whether it initialized.
    """
    coord = os.environ.get('EMG3D_TPU_COORD')
    nproc = os.environ.get('EMG3D_TPU_NPROC')
    pid = os.environ.get('EMG3D_TPU_PROC_ID')
    if coord is None and nproc is None and pid is None:
        return False
    init(coordinator_address=coord, num_processes=nproc, process_id=pid,
         backend=backend)
    return True


def shutdown():
    if _STATE['initialized']:
        dist.destroy_process_group()
        _STATE['initialized'] = False


def process_count():
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index():
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(axes=('z',), n_devices=None):
    """A ``DeviceMesh`` over every rank of the process group (all hosts).

    Ranks are laid out row-major, z fastest: on a 2-D ``('y', 'z')``
    mesh neighbouring ranks along z are consecutive, so with ranks
    numbered host by host the per-colour-step z exchanges stay within a
    host where they can.
    """
    from .sharding import make_mesh
    return make_mesh(n_devices, axes=axes)
