"""The point kernels' sweeps: colour-major data, plans, kernel rule.

- The colour-major factor buffer of ``point_gs.point_state`` unpacks
  bitwise to the node-indexed stack, packs back bitwise, and holds the
  JAX package's node-block LDLᵀ factors (``node_block_entries`` +
  ``ldl_factor_sparse``) at rel 1e-12; plane p of colour c's thread t
  sits at ``offs[c] + p·n_c + t``, z fastest, as the kernel reads it.
  K2's packed node data (η sums and ζ weight pairs) unpacks bitwise to
  ``st``/``w`` the same way.
- The plain fused smoother (the math K2 runs, re-factoring every colour
  step) equals ``emg3d_tpu.ops.smoothers.gauss_seidel_point`` at rel
  1e-12.
- ``point_gs.sweep_plan`` gives a valid plan of either kernel for every
  level of the bench64, sclr64 and 512×384² hierarchies and refuses
  what the card could not run; K2's ``shared`` bytes hold no factors.
- ``point_gs.point_kernel`` keeps K1 within FACTOR_SHARE of the card
  and follows FORCE_KERNEL; a level that takes K2 builds no factors,
  and K2's packed data only where it fits.
- Each kernel's launches per bench64 solve, enumerated from the rule
  and the plans over the solver's own cycle
  (``chip_smoke.point_cycle_calls``): the numbers ``chip_smoke.py``
  reads on the card.
"""
import math

import pytest

pytest.importorskip('jax')

import numpy as np  # noqa: E402
import torch  # noqa: E402

import emg3d_tpu as jt  # noqa: E402
from emg3d_tpu.ops import smoothers as jsm  # noqa: E402
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
# Bytes of an H100 80GB as torch reports them (the card of PERF.md).
CARD = 85045000192


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


@pytest.mark.parametrize('kernel', point_gs.KERNELS)
@pytest.mark.parametrize('name', sorted(HIERARCHIES))
def test_sweep_plan_every_level(name, kernel):
    for shape, sc in HIERARCHIES[name]:
        for lev in _level_shapes(shape, sc):
            for nu in (1, 2, 3):
                p = point_gs.sweep_plan(lev, nu, kernel=kernel)
                seq = psm.color_sequence(nu)
                steps = sum(1 for c in seq if math.prod(
                    point_gs.launch_geometry(lev, c)[1]))
                most = max(math.prod(point_gs.launch_geometry(lev, c)[1])
                           for c in seq)
                assert p.steps == steps
                assert (p.plan == 'step') == (
                    most > point_gs.STEP_NODES)
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
                    assert p.smem_bytes == point_gs._shared_bytes(lev,
                                                                  kernel)
                    assert p.smem_bytes <= point_gs.SMEM_MAX
                assert p.blocks <= -(-most // p.threads)
                # The step plan: one launch per colour step with nodes.
                s = point_gs.sweep_plan(lev, nu, plan='step', kernel=kernel)
                assert (s.launches, s.steps) == (steps, steps)


@pytest.mark.parametrize('shape', SHAPES + [(16, 16, 16), (10, 12, 14)])
def test_fused_shared_bytes_hold_no_factors(shape):
    """K2's shared plan holds e, s, η sums, ζ weights and widths: K1's
    bytes less its factors, so larger levels fit a block."""
    nodes = math.prod(n - 1 for n in shape)
    assert point_gs._shared_bytes(shape, 'fused') == (
        point_gs._shared_bytes(shape, 'factored')
        - 16 * point_gs.NFACTORS * nodes)
    admitted = point_gs.plans_admitted(shape, 'fused')
    assert ('shared' in admitted) == (
        point_gs._shared_bytes(shape, 'fused') <= point_gs.SMEM_MAX)
    assert set(point_gs.plans_admitted(shape)) <= set(admitted)


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
    with pytest.raises(ValueError, match='shared plan'):
        point_gs.sweep_plan((16, 16, 16), 3, plan='shared', kernel='fused')
    with pytest.raises(ValueError, match='unknown point-smoother kernel'):
        point_gs.sweep_plan((8, 8, 8), 3, kernel='packed')
    assert 'shared' not in point_gs.plans_admitted((64, 64, 64))
    assert point_gs.sweep_plan((8, 8, 8), seq=[0] * point_gs.MAX_SEQ)


def test_force_plan(monkeypatch):
    monkeypatch.setattr(point_gs, 'FORCE_PLAN', 'step')
    p = point_gs.sweep_plan((16, 16, 16), 3)
    assert (p.plan, p.launches, p.steps) == ('step', 24, 24)
    assert point_gs.sweep_plan((16, 16, 16), 3, plan='grid').plan == 'grid'


# Per F-cycle of the bench64 solve: 35 smoothing calls (six levels, 64³
# to 2³), one launch each under its level's sweep plan.  Under
# point_kernel on the card the two 64³ calls take K2 (48 colour steps),
# the 33 others K1 (677 steps); all on K1 (forced), 725 steps, which
# the step plan launches one by one.
BENCH64_CYCLE = {'factored': (33, 677), 'fused': (2, 48)}


def _card(monkeypatch):
    """point_kernel as on an H100 80GB (the card's memory)."""
    monkeypatch.setattr(point_gs, 'card_memory',
                        lambda d: CARD if torch.device(d).type == 'cuda'
                        else None)
    return lambda sh: point_gs.point_kernel(sh, 'cuda')


def test_bench64_launch_count(monkeypatch):
    grid, model, sfield = chip_smoke.bench_problem()
    calls = chip_smoke.point_cycle_calls(grid, model, sfield)
    assert len(calls) == 35
    card = _card(monkeypatch)
    assert chip_smoke.point_per_cycle(calls, card) == BENCH64_CYCLE
    k1 = chip_smoke.point_per_cycle(calls, lambda sh: 'factored')
    assert k1 == {'factored': (35, 725), 'fused': (0, 0)}
    assert chip_smoke.point_per_cycle(calls, lambda sh: 'factored',
                                      'step')['factored'] == (725, 725)
    monkeypatch.setattr(point_gs, 'FORCE_KERNEL', 'factored')
    assert chip_smoke.point_per_cycle(calls, card) == k1
    # One launch per smoothing call under either rule: 175 launches per
    # solve at the card's it_mg of 5.
    for rule in (BENCH64_CYCLE, k1):
        assert 5 * sum(n for n, _ in rule.values()) == 175


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
    point_gs.STEPS['fused'] = 24
    point_gs.reset_launches()
    assert point_gs.LAUNCHES == {'factored': 0, 'fused': 0}
    assert point_gs.STEPS == {'factored': 0, 'fused': 0}
    # plan and kernel, 15 field/parameter pointers and the colour-major
    # buffer, the shape, the colour table, offsets and sequence, 4 ints,
    # the stream.
    assert len(_build.ARGTYPES['emg3d_point_gs_sweep']) == 29
    assert len(_build.ARGTYPES['emg3d_point_gs_step']) == 29
    assert len(_build.ARGTYPES['emg3d_point_gs_grid_capacity']) == 2
    assert point_gs._KERNEL_CODE == {'factored': 0, 'fused': 1,
                                     'fused_packed': 2}


@pytest.mark.parametrize('shape', SHAPES)
def test_node_data_unpacks_bitwise(shape):
    """K2's packed node data: the six η sums and six ζ weight pairs of
    every interior node, colour-major, unpacking bitwise to st and w."""
    _, par = tp.level(jt, shape, seed=sum(shape) + 5)
    state = point_gs.point_state(convert.params_to_torch(par), shape,
                                 factored=False)
    assert state.factors is None and state.nodes is None   # CPU: none
    flat = point_gs.pack_node_data(state.st, state.w, shape)
    nodes = math.prod(n - 1 for n in shape)
    assert flat.shape == (point_gs.NODE_PLANES * nodes,)
    assert flat.numel() * 16 == point_gs.node_bytes(shape) == 192 * nodes
    sums, pairs = point_gs.unpack_node_data(flat, shape)
    want_s, want_p = point_gs.node_planes(state.st, state.w)
    assert all(torch.equal(a, b) for a, b in zip(sums, want_s))
    assert all(torch.equal(a, c) and torch.equal(b, d)
               for (a, b), (c, d) in zip(pairs, want_p))
    # Plane p of colour c's thread t at offs[c] + p·n_c + t.
    offs, total = point_gs.colour_offsets(shape, point_gs.NODE_PLANES)
    assert total == flat.numel()
    for color in range(8):
        first, counts, _, _ = point_gs.launch_geometry(shape, color)
        n = math.prod(counts)
        for t in range(n):
            q, rem = divmod(t, counts[1] * counts[2])
            b, c = divmod(rem, counts[2])
            node = (first[0] + 2 * q - 1, first[1] + 2 * b - 1,
                    first[2] + 2 * c - 1)
            assert flat[offs[color] + 5 * n + t] == want_s[5][node]
            v = flat[offs[color] + 11 * n + t]
            assert (v.real, v.imag) == (want_p[5][0][node],
                                        want_p[5][1][node])
    with pytest.raises(ValueError, match='nodes: shape'):
        point_gs.unpack_node_data(flat[:-1], shape)


@pytest.mark.parametrize('shape', SHAPES)
def test_fused_plain_matches_jax(shape):
    """The plain fused smoother (re-factoring every colour step, as K2
    does) against the JAX package's point smoother."""
    _, par = tp.level(jt, shape, seed=sum(shape) + 6)
    e = tp.random_fields(shape, seed=sum(shape) + 7)
    s = tp.random_fields(shape, seed=sum(shape) + 8)
    ref = jsm.gauss_seidel_point(*tp.to_jax(e), *tp.to_jax(s),
                                 *tp.to_jax(par), nu=2)
    state = point_gs.point_state(convert.params_to_torch(par), shape,
                                 factored=False)
    et = convert.fields_to_torch(e)
    out = point_gs.gauss_seidel_point_plain(et, convert.fields_to_torch(s),
                                            state, 2, _mode='fused')
    assert tp.rel(out, ref) < TOL


def test_point_kernel_rule(monkeypatch):
    """K2 where a colour has FUSED_NODES nodes or more (the card's
    table), K1 below; K1 never beyond FACTOR_SHARE of the card, even
    when forced; FORCE_KERNEL otherwise wins; off the card K1."""
    card = _card(monkeypatch)
    big = (512, 384, 384)
    assert point_gs.factor_bytes(big) > point_gs.FACTOR_SHARE * CARD
    assert point_gs.node_bytes(big) <= point_gs.FACTOR_SHARE * CARD
    for shape in [(2, 2, 2), (16, 16, 16), (32, 32, 32), (64, 48, 48),
                  (64, 64, 64), (128, 128, 128), (256, 192, 192), big]:
        most = max(math.prod(point_gs.launch_geometry(shape, c)[1])
                   for c in range(8))
        want = 'fused' if most >= point_gs.FUSED_NODES else 'factored'
        assert card(shape) == want, shape
        assert point_gs.point_kernel(shape, 'cpu') == 'factored'
    assert card((32, 32, 32)) == 'factored'
    assert card((64, 64, 64)) == 'fused'
    assert card(big) == 'fused'
    monkeypatch.setattr(point_gs, 'FORCE_KERNEL', 'factored')
    assert card((128, 128, 128)) == 'factored'
    assert card(big) == 'fused'                  # the cap holds
    monkeypatch.setattr(point_gs, 'FORCE_KERNEL', 'fused')
    assert card((2, 2, 2)) == 'fused'
    assert point_gs.point_kernel((2, 2, 2), 'cpu') == 'fused'
    monkeypatch.setattr(point_gs, 'FORCE_KERNEL', 'fast')
    with pytest.raises(ValueError, match='FORCE_KERNEL'):
        card((2, 2, 2))


def test_node_data_only_where_it_fits(monkeypatch):
    """K2's packed node data is built only on a card, only for a level
    beyond the shared plan (which reads st and w), and only where it
    fits FACTOR_SHARE of the card; elsewhere K2 reads st and w."""
    shape = (12, 10, 14)
    assert 'shared' not in point_gs.plans_admitted(shape, 'fused')
    _, par = tp.level(jt, shape, seed=12)
    arrays = convert.params_to_torch(par)
    need = point_gs.node_bytes(shape)
    for total, packs in ((need / point_gs.FACTOR_SHARE, True),
                         (need / point_gs.FACTOR_SHARE - 1, False),
                         (None, False)):
        monkeypatch.setattr(point_gs, 'card_memory', lambda d: total)
        assert point_gs.packs_nodes(shape, 'cuda') == packs
        st = point_gs.point_state(arrays, shape, factored=False)
        assert (st.nodes is not None) == packs and st.factors is None
    monkeypatch.setattr(point_gs, 'card_memory', lambda d: CARD)
    assert not point_gs.packs_nodes((8, 8, 8), 'cuda')       # shared plan
    assert point_gs.packs_nodes((16, 16, 16), 'cuda')
    monkeypatch.undo()
    assert not point_gs.packs_nodes(shape, 'cpu')


@pytest.mark.parametrize('force,plain', [('fused', False), (None, False),
                                         ('factored', False),
                                         ('fused', True)])
def test_level_state_builds_one_kernel(monkeypatch, force, plain):
    """The solver builds K1's factors only for a level that runs K1, and
    K2's node data only for one that runs K2 (a level beyond the shared
    plan, with the CPU standing in for an H100's memory); under the
    override (``_build.PLAIN``) K1's, whatever FORCE_KERNEL says."""
    monkeypatch.setattr(point_gs, 'card_memory', lambda d: CARD)
    monkeypatch.setattr(point_gs, 'FORCE_KERNEL', force)
    monkeypatch.setattr(_build, 'PLAIN', plain)

    class Lev:
        pass
    lev = Lev()
    shape = (12, 10, 14)
    _, par = tp.level(jt, shape, seed=13)
    lev.arrays = convert.params_to_torch(par)
    lev.shape = shape
    lev.pstate = None
    lev.lanes = None
    st = solver._level_state(lev)
    fused = force == 'fused' and not plain
    assert (st.factors is None) == fused
    assert (st.nodes is not None) == fused
    assert solver._level_state(lev) is st                 # built once
