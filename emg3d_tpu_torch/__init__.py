"""emg3d_tpu_torch: the emg3d_tpu multigrid solver in PyTorch and CUDA.

The port of the JAX package ``emg3d_tpu`` to PyTorch on an NVIDIA H100.
Plain tensor code is PyTorch (complex128); the Pallas kernels of the
JAX package become hand-written CUDA kernels for Hopper (sm_90a), built
with nvcc at first use.  This package imports neither JAX nor
``emg3d_tpu``.

The slice ported so far is the standalone multigrid solve with the
point Gauss-Seidel smoother: ``solve(grid, model, sfield)`` with its
defaults (F-cycles, no Krylov solver, no line relaxation).  ``solve``
runs on CUDA unless it is given ``device='cpu'``.
"""
__version__ = '0.1.0'

from .meshes import TensorMesh
from .models import Model, VolumeModel
from .fields import Field, SourceField, get_source_field
from .solver import solve

__all__ = ['TensorMesh', 'Model', 'VolumeModel', 'Field', 'SourceField',
           'get_source_field', 'solve']
