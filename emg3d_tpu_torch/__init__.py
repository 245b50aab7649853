"""emg3d_tpu_torch: the emg3d_tpu multigrid solver in PyTorch and CUDA.

The port of the JAX package ``emg3d_tpu`` to PyTorch on an NVIDIA H100.
Plain tensor code is PyTorch (complex128); the Pallas kernels of the
JAX package become hand-written CUDA kernels for Hopper (sm_90a), built
with nvcc at first use.  This package imports neither JAX nor
``emg3d_tpu``.

Ported so far: ``solve`` in every configuration of the JAX package
(F/V/W multigrid, point smoothing or semicoarsening with line
relaxation, standalone or preconditioning BiCGSTAB, CGS or GCROT(m,k));
``solve_batched`` (many (source, frequency) pairs on one grid advanced
together, plain multigrid, BiCGSTAB or CGS); ``Simulation`` over a
``Survey`` with its receivers, and the misfit and adjoint gradient of
``optimize``; the time domain (``Fourier``, :mod:`.time`), files
(:mod:`.io`, ``to_file``/``from_file``), the command line
(``python -m emg3d_tpu_torch config.cfg -f``) and autograd through the
solve (:mod:`.diff`, a ``torch.autograd.Function``).  Every entry point
runs on CUDA unless it is given ``device='cpu'`` (``Simulation``:
``solver_opts={'device': 'cpu'}``; the CLI: ``device = cpu`` in
``[solver_opts]``).  Multi-GPU solves (:mod:`.parallel`) run SPMD over
processes on ``torch.distributed``, one rank per GPU:
``solve(..., sharding=parallel.shard_solve_options(mesh))`` with any
smoother, semicoarsening and Krylov solver, in complex128 or complex64,
the levels split into y/z slabs with halo exchanges.

Precision: complex128/float64 unless asked.  A complex64 source field
asks for a complex64 solve; ``with dtypes.x64(False):`` (or
``dtypes.set_x64(False)``) runs every solve, ``Simulation`` and
:mod:`.diff` in complex64/float32, as the JAX package does with JAX's
x64 flag off (which is its default; the port's switch is on by
default).
"""
__version__ = '0.1.0'

from .meshes import TensorMesh, construct_mesh, good_mg_cell_nr, skin_depth
from .models import Model, VolumeModel
from .fields import (Field, SourceField, get_source_field, get_receiver,
                     get_receiver_response, get_h_field)
from .maps import grid2grid, interp3d
from .solver import solve, solve_batched
from .surveys import Survey, Dipole, PointDipole
from .simulations import Simulation, expand_grid_model
from .utils import EMArray, Report
from .time import Fourier
from . import diff, dtypes, io, optimize, parallel, time, trace

__all__ = [
    'TensorMesh', 'construct_mesh', 'good_mg_cell_nr', 'skin_depth',
    'Model', 'VolumeModel',
    'Field', 'SourceField', 'get_source_field', 'get_receiver',
    'get_receiver_response', 'get_h_field',
    'grid2grid', 'interp3d',
    'solve', 'solve_batched', 'Survey', 'Dipole', 'PointDipole', 'Simulation',
    'expand_grid_model', 'EMArray', 'Report', 'diff', 'io', 'optimize',
]
