"""The factored point kernel's sweep: colour-major factors and plans.

- The colour-major factor buffer of ``point_gs.point_state`` unpacks
  bitwise to the node-indexed stack, packs back bitwise, and holds the
  JAX package's node-block LDLᵀ factors (``node_block_entries`` +
  ``ldl_factor_sparse``) at rel 1e-12; plane p of colour c's thread t
  sits at ``offs[c] + p·n_c + t``, z fastest, as the kernel reads it.
- ``point_gs.sweep_plan`` gives a valid plan for every level of the
  bench64, sclr64 and 512×384² hierarchies and refuses what the card
  could not run.
- The factored kernel's launches per bench64 solve, enumerated from the
  plans over the solver's own cycle (``chip_smoke.point_cycle_calls``):
  the number ``chip_smoke.py`` reads on the card.
"""
import math

import pytest

pytest.importorskip('jax')

import numpy as np  # noqa: E402
import torch  # noqa: E402

import emg3d_tpu as jt  # noqa: E402
from emg3d_tpu.ops.blocksolve import ldl_factor_sparse  # noqa: E402
from emg3d_tpu.ops.coeffs import (node_block_entries,  # noqa: E402
                                  node_coefficients)

import chip_smoke  # noqa: E402
import emg3d_tpu_torch as pt  # noqa: E402
from emg3d_tpu_torch import convert, solver  # noqa: E402
from emg3d_tpu_torch.ops import _build, point_gs  # noqa: E402
from emg3d_tpu_torch.ops import smoothers as psm  # noqa: E402

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-12
SHAPES = [(2, 2, 2), (4, 4, 4), (7, 5, 9), (8, 8, 8)]


def _node_stack(par_t, shape):
    """The node-indexed (20, nx-1, ny-1, nz-1) stack (the former layout)."""
    nb = tuple(n - 1 for n in shape)
    L, dinv = psm.node_factors(par_t)
    planes = [L[k] for k in point_gs.LKEYS] + list(dinv)
    return torch.stack([torch.broadcast_to(p, nb) for p in planes])


@pytest.mark.parametrize('shape', SHAPES)
def test_colour_major_factors(shape):
    _, par = tp.level(jt, shape, seed=sum(shape) + 3)
    par_t = convert.params_to_torch(par)
    flat = point_gs.point_state(par_t, shape).factors
    nodes = _node_stack(par_t, shape)
    assert flat.shape == (nodes.numel(),)
    assert flat.numel() * 16 == point_gs.factor_bytes(shape)
    assert torch.equal(point_gs.unpack_factors(flat, shape), nodes)
    assert torch.equal(point_gs.pack_factors(list(nodes), shape), flat)

    # The JAX package's factors, plane by plane.
    L_j, d_j = ldl_factor_sparse(6, node_block_entries(
        node_coefficients(*tp.to_jax(par))))
    want = [L_j[k] for k in point_gs.LKEYS] + list(d_j)
    nb = tuple(n - 1 for n in shape)
    for p, w in enumerate(want):
        w = np.broadcast_to(np.asarray(w), nb)
        assert tp.rel((nodes[p],), (w,)) < TOL, p


def test_colour_major_layout():
    """Plane p of colour c's thread t at offs[c] + p·n_c + t, thread t
    the node (x0 + 2q, y0 + 2b, z0 + 2c) with t = (q·cny + b)·cnz + c."""
    shape = (7, 5, 9)
    nb = tuple(n - 1 for n in shape)
    planes = [torch.arange(math.prod(nb), dtype=torch.float64).reshape(nb)
              + 1000.0 * p for p in range(point_gs.NFACTORS)]
    flat = point_gs.pack_factors(planes, shape)
    offs, total = point_gs.colour_offsets(shape)
    assert total == point_gs.NFACTORS * math.prod(nb)
    seen = 0
    for color in range(8):
        first, counts, _, _ = point_gs.launch_geometry(shape, color)
        n = math.prod(counts)
        seen += n
        for t in range(n):
            q, rem = divmod(t, counts[1] * counts[2])
            b, c = divmod(rem, counts[2])
            node = (first[0] + 2 * q - 1, first[1] + 2 * b - 1,
                    first[2] + 2 * c - 1)
            for p in (0, 13, 19):
                assert flat[offs[color] + p * n + t] == planes[p][node]
    assert seen == math.prod(nb)
    with pytest.raises(ValueError, match='factors: shape'):
        point_gs.unpack_factors(flat[:-1], shape)


def _level_shapes(shape, sc_dir):
    """Cell shapes of the solver's hierarchy (build_levels' rule)."""
    var = solver.MGParameters(verb=0, cycle='F', sslsolver=False,
                              linerelaxation=False, semicoarsening=False,
                              shape_cells=shape)
    shapes = [tuple(shape)]
    for _ in range(int(var.clevel[sc_dir])):
        flags = solver._coarsen_flags(solver._current_sc_dir(sc_dir,
                                                             shapes[-1]))
        shapes.append(tuple(n // 2 if f else n
                            for n, f in zip(shapes[-1], flags)))
    return shapes


def test_level_shapes_match_solver():
    grid, model, sfield = chip_smoke.bench_problem((16, 8, 12))
    vm = pt.VolumeModel(grid, model, sfield)
    var = solver.MGParameters(verb=0, cycle='F', sslsolver=False,
                              linerelaxation=False, semicoarsening=False,
                              shape_cells=grid.shape_cells)
    for sc in range(4):
        levels = solver.build_levels(grid, vm, sc, int(var.clevel[sc]),
                                     torch.device('cpu'), {'bytes': 0})
        assert [lev.shape for lev in levels] == _level_shapes((16, 8, 12),
                                                              sc)


HIERARCHIES = {
    'bench64': [((64, 64, 64), 0)],
    'sclr64': [((64, 64, 64), sc) for sc in (1, 2, 3)],
    'large': [((512, 384, 384), 0)],
}


@pytest.mark.parametrize('name', sorted(HIERARCHIES))
def test_sweep_plan_every_level(name):
    for shape, sc in HIERARCHIES[name]:
        for lev in _level_shapes(shape, sc):
            for nu in (1, 2, 3):
                p = point_gs.sweep_plan(lev, nu)
                seq = psm.color_sequence(nu)
                steps = sum(1 for c in seq if math.prod(
                    point_gs.launch_geometry(lev, c)[1]))
                most = max(math.prod(point_gs.launch_geometry(lev, c)[1])
                           for c in seq)
                assert p.steps == steps
                assert (p.plan == 'step') == (most > point_gs.STEP_NODES)
                if p.plan == 'step':
                    assert p.launches == steps
                    continue
                assert p.launches == (1 if steps else 0)
                assert p.threads % 32 == 0
                assert 32 <= p.threads <= point_gs.MAX_THREADS
                if p.plan == 'cluster':
                    assert 1 <= p.blocks <= point_gs.MAX_CLUSTER
                    assert most <= point_gs.CLUSTER_NODES
                elif p.plan == 'grid':
                    assert 1 <= p.blocks <= point_gs.GRID_BLOCKS
                else:
                    assert (p.blocks, p.threads) == (1, 256)
                    assert p.smem_bytes <= point_gs.SMEM_MAX
                assert p.blocks <= -(-most // p.threads)
                # The step plan: one launch per colour step with nodes.
                s = point_gs.sweep_plan(lev, nu, plan='step')
                assert (s.launches, s.steps) == (steps, steps)


def test_sweep_plan_refuses():
    with pytest.raises(ValueError, match='colour steps'):
        point_gs.sweep_plan((8, 8, 8), seq=[0] * (point_gs.MAX_SEQ + 1))
    with pytest.raises(ValueError, match='colour steps'):
        point_gs.sweep_plan((8, 8, 8), point_gs.MAX_SEQ // 8 + 1)
    with pytest.raises(ValueError, match='colour steps'):
        point_gs.sweep_plan((8, 8, 8), seq=[])
    with pytest.raises(ValueError, match='unknown sweep plan'):
        point_gs.sweep_plan((8, 8, 8), 1, plan='persistent')
    with pytest.raises(ValueError, match='shared plan'):
        point_gs.sweep_plan((64, 64, 64), 3, plan='shared')
    assert 'shared' not in point_gs.plans_admitted((64, 64, 64))
    assert point_gs.sweep_plan((8, 8, 8), seq=[0] * point_gs.MAX_SEQ)


def test_force_plan(monkeypatch):
    monkeypatch.setattr(point_gs, 'FORCE_PLAN', 'step')
    p = point_gs.sweep_plan((16, 16, 16), 3)
    assert (p.plan, p.launches, p.steps) == ('step', 24, 24)
    assert point_gs.sweep_plan((16, 16, 16), 3, plan='grid').plan == 'grid'


# K1 per F-cycle of the bench64 solve: 35 smoothing calls (six levels,
# 64³ to 2³), one launch each; 725 colour steps with nodes, which the
# step plan launches one by one (3625 launches per solve of 5
# cycles on the card).
BENCH64_CYCLE = (35, 725)


def test_bench64_launch_count():
    grid, model, sfield = chip_smoke.bench_problem()
    calls = chip_smoke.point_cycle_calls(grid, model, sfield)
    assert len(calls) == 35
    assert chip_smoke.k1_per_cycle(calls) == BENCH64_CYCLE
    assert chip_smoke.k1_per_cycle(calls, 'step') == (725, 725)
    assert 5 * BENCH64_CYCLE[0] <= 400     # it_mg 5 on the card


def test_cycle_calls_match_a_solve(monkeypatch):
    """The enumerated cycle's calls, times it_mg, are those of a solve."""
    grid, model, sfield = chip_smoke.bench_problem((16, 16, 16))
    calls = chip_smoke.point_cycle_calls(grid, model, sfield)
    seen = []
    real = point_gs.gauss_seidel_point

    def spy(e, s, state, nu, **kw):
        seen.append((state.shape, nu))
        return real(e, s, state, nu, **kw)
    monkeypatch.setattr(point_gs, 'gauss_seidel_point', spy)
    _, info = pt.solve(grid, model, sfield, cycle='F', verb=0,
                       return_info=True, device='cpu')
    assert info['exit_message'] == 'CONVERGED'
    assert seen == calls * info['it_mg']


def test_sweep_counters_and_binding():
    point_gs.LAUNCHES['factored'] = 2
    point_gs.STEPS['factored'] = 48
    point_gs.reset_launches()
    assert point_gs.LAUNCHES == {'factored': 0, 'fused': 0}
    assert point_gs.STEPS == {'factored': 0, 'fused': 0}
    # plan, 15 field/parameter pointers and the factors, the shape, the
    # colour table, offsets and sequence, 4 ints, the stream.
    assert len(_build.ARGTYPES['emg3d_point_gs_sweep']) == 28
    assert 'emg3d_point_gs_grid_capacity' in _build.ARGTYPES
