"""Multi-GPU execution: meshes of ranks, slabs, distributed solves."""
from .sharding import (make_mesh, field_sharding, shard_solve_options,
                       distribute_field)
from . import distributed, halo, lines

__all__ = ['make_mesh', 'field_sharding', 'shard_solve_options',
           'distribute_field', 'distributed', 'halo', 'lines']
