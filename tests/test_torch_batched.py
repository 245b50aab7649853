"""Port vs JAX package: batched solves (``solve_batched``) and their lanes.

Both packages solve the same (source, frequency) pairs on the CPU in
complex128, stacked on a lane axis:

- plain multigrid, one and two frequencies, point smoothing, and a
  fixed sc/lr pair with two: equal ``exit_message`` and ``it_mg``, every lane's field
  within rel 1e-9 (the mirror of tests/test_batched.py:20, 55);
- BiCGSTAB and CGS at 8³ and tol 1e-10: every lane's field within rel
  1e-7 and ``it_ssl`` within ±1 (the JAX package refines its batched
  Krylov solve in a split representation that the port's complex128
  recurrence does not need; tests/test_batched.py:73, 126, 146, 197).

Then the lane plumbing on the CPU: the lane → group table, η stacked
per lane, the 4-D coarsening of model parameters, the lane-aware launch
geometries of K3 and K4, lane states and their plain sweep.
"""
import pytest

pytest.importorskip('jax')

import numpy as np  # noqa: E402
import torch  # noqa: E402

import emg3d_tpu as jt  # noqa: E402
from emg3d_tpu.solver import solve_batched as jsolve_batched  # noqa: E402

import emg3d_tpu_torch as pt  # noqa: E402
from emg3d_tpu_torch import convert, solver  # noqa: E402
from emg3d_tpu_torch.ops import _build, line_gs, transfers  # noqa: E402

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)


def _problem(n=8, seed=2):
    grid = jt.TensorMesh([np.full(n, 100.)] * 3, origin=(-n * 50.,) * 3)
    rng = np.random.default_rng(seed)
    model = jt.Model(grid, property_x=rng.uniform(0.5, 5, grid.shape_cells))
    return grid, model


def _pairs(grid_j, model_j, lanes):
    gp = convert.mesh_to_torch(grid_j)
    mp = convert.model_to_torch(model_j)
    sj = [jt.get_source_field(grid_j, [x, 0, 0, 0, 0], f) for x, f in lanes]
    sp = [pt.get_source_field(gp, [x, 0, 0, 0, 0], f) for x, f in lanes]
    return (grid_j, model_j, sj), (gp, mp, sp)


ONE_FREQ = [(-200, 1.0), (0, 1.0), (200, 1.0)]
TWO_FREQ = [(-200, 1.0), (0, 2.0), (200, 1.0)]

# Point smoothing with one and with two frequencies; a fixed sc/lr pair
# with two (one K5 stack per frequency group, K3/K4 over every lane).
MG_CASES = {
    'point-one-freq': (ONE_FREQ, {}),
    'point-two-freq': (TWO_FREQ, {}),
    'sc3-lr1-two-freq': (TWO_FREQ, {'semicoarsening': 3,
                                    'linerelaxation': 1}),
}


@pytest.mark.parametrize('case', list(MG_CASES))
def test_batched_multigrid_matches_jax(case):
    lanes, opts = MG_CASES[case]
    (gj, mj, sj), (gp, mp, sp) = _pairs(*_problem(), lanes)
    ej, ij = jsolve_batched(gj, mj, sj, verb=1, **opts)
    ep, ip = pt.solve_batched(gp, mp, sp, verb=1, device='cpu', **opts)
    assert set(ip) == set(ij)
    assert ip['exit_message'] == ij['exit_message'] == 'CONVERGED'
    assert ip['it_mg'] == ij['it_mg'] and ip['it_ssl'] == 0
    assert ip['rel_error'].shape == (3,) and np.all(ip['rel_error'] < 1e-6)
    np.testing.assert_allclose(ip['rel_error'], ij['rel_error'], rtol=1e-6)
    for a, b, sf in zip(ep, ej, sp):
        assert tp.rel((a.field,), (b.field,)) < 1e-9
        assert a._frequency == sf._frequency


KRYLOV_CASES = {
    'bicgstab': {'sslsolver': 'bicgstab'},
    'cgs': {'sslsolver': 'cgs'},
}


@pytest.mark.parametrize('case', list(KRYLOV_CASES))
def test_batched_krylov_matches_jax(case):
    """μ0-scaled (small-norm) sources of two frequencies: the complex128
    recurrence needs no unit-norm lane scaling."""
    (gj, mj, sj), (gp, mp, sp) = _pairs(*_problem(), TWO_FREQ)
    assert all(float(sf.norm()) < 1e-3 for sf in sp)
    opts = dict(KRYLOV_CASES[case], tol=1e-10, verb=1)
    ej, ij = jsolve_batched(gj, mj, sj, **opts)
    ep, ip = pt.solve_batched(gp, mp, sp, device='cpu', **opts)
    assert ip['exit_message'] == ij['exit_message'] == 'CONVERGED'
    assert abs(ip['it_ssl'] - ij['it_ssl']) <= 1 and ip['it_ssl'] > 0
    assert np.all(np.isfinite(ip['rel_error']))
    assert np.all(ip['rel_error'] < 1e-10)
    for a, b in zip(ep, ej):
        assert tp.rel((a.field,), (b.field,)) < 1e-7


def test_batched_lanes_match_single_solves():
    """Every lane of a batched solve (mixed frequencies) is its own
    solve: the same it_mg and the field within rel 1e-9 when each lane
    alone runs as many cycles."""
    grid, model = _problem()
    _, (gp, mp, sp) = _pairs(grid, model, TWO_FREQ)
    es, info = pt.solve_batched(gp, mp, sp, verb=1, device='cpu', tol=1e-8)
    for e, sf in zip(es, sp):
        e1 = pt.solve(gp, mp, sf, verb=1, device='cpu', tol=1e-30,
                      maxit=info['it_mg'])
        assert tp.rel((e.field,), (e1.field,)) < 1e-9


def test_batched_validation():
    grid, model = _problem(4)
    _, (gp, mp, sp) = _pairs(grid, model, [(0, 1.0)])
    with pytest.raises(NotImplementedError, match='bicgstab and cgs'):
        pt.solve_batched(gp, mp, sp, sslsolver='gcrotmk', device='cpu')
    with pytest.raises(ValueError, match='at least one'):
        pt.solve_batched(gp, mp, [], device='cpu')


# ----------------------------------------------------------------------
# Lane plumbing
# ----------------------------------------------------------------------

def test_lanes_group_table():
    lanes = solver.Lanes([1.0, 0.5, 1.0, 2.0, 0.5], 'cpu')
    assert lanes.group.tolist() == [0, 1, 0, 2, 1]
    assert lanes.reps == (0, 1, 3)
    assert lanes.index.dtype == torch.int32
    assert lanes.index.tolist() == [0, 1, 0, 2, 1]


def test_build_levels_stacks_eta_per_lane():
    grid, model = _problem(8)
    gp, mp = convert.mesh_to_torch(grid), convert.model_to_torch(model)
    vms = [pt.VolumeModel(gp, mp, pt.SourceField.zeros(gp, frequency=f))
           for f in (1.0, 2.0, 1.0)]
    lanes = solver.Lanes([1.0, 2.0, 1.0], 'cpu')
    levels = solver.build_levels(gp, vms, 0, 2, torch.device('cpu'),
                                 {'bytes': 0}, lanes)
    for b, vm in enumerate(vms):
        one = solver.build_levels(gp, vm, 0, 2, torch.device('cpu'),
                                  {'bytes': 0})
        for lev, ref in zip(levels, one):
            assert lev.lanes is lanes
            assert lev.arrays[0].shape == (3,) + lev.shape
            assert lev.arrays[1] is lev.arrays[0]      # isotropic: shared
            assert torch.equal(lev.arrays[0][b], ref.arrays[0])
            assert torch.equal(lev.arrays[3], ref.arrays[3])   # ζ shared


def test_restrict_model_parameter_lanes():
    rng = np.random.default_rng(3)
    p = torch.tensor(rng.standard_normal((3, 8, 6, 4)))
    for coarsen in ((True, True, True), (False, True, True),
                    (True, False, True), (True, True, False)):
        out = transfers.restrict_model_parameter(p, coarsen)
        for b in range(3):
            assert torch.equal(out[b], transfers.restrict_model_parameter(
                p[b], coarsen))


@pytest.mark.parametrize('shape', [(3, 3, 3), (7, 5, 9), (64, 64, 64),
                                   (256, 256, 256)])
def test_lane_launch_geometry(shape):
    """One lane is the one-lane launch; more lanes keep each colour's
    lines and spread the blocks of every lane (the grid's y extent)."""
    for color in range(4):
        assert line_gs.residual_geometry(shape, color, lanes=1) == \
            line_gs.residual_geometry(shape, color)
        assert line_gs.launch_geometry(shape, color, lanes=1) == \
            line_gs.launch_geometry(shape, color)
        for lanes in (2, 8, 64):
            g3 = line_gs.residual_geometry(shape, color, lanes=lanes)
            g4 = line_gs.launch_geometry(shape, color, lanes=lanes)
            one3 = line_gs.residual_geometry(shape, color)
            one4 = line_gs.launch_geometry(shape, color)
            assert g3.lanes == g4.lanes == lanes
            assert g3.counts == one3.counts and g4.counts == one4.counts
            lines = g4.counts[0] * g4.counts[1]
            if lines == 0:
                assert g3.blocks == g4.blocks == 0
                continue
            # Longer K3 runs and more lines per K4 block as lanes add
            # blocks; each lane's lines stay covered.
            assert g3.xplanes >= one3.xplanes
            assert g4.lines_per_block >= one4.lines_per_block
            assert g4.blocks * g4.lines_per_block >= lines
            assert g3.blocks == -(-g3.counts[0] // g3.rows) * \
                -(-g3.counts[1] // g3.lines) * -(-shape[0] // g3.xplanes)
    with pytest.raises(ValueError, match='lanes'):
        line_gs.residual_geometry(shape, 0, lanes=line_gs.MAX_LANES + 1)
    with pytest.raises(ValueError, match='lanes'):
        line_gs.launch_geometry(shape, 0, lanes=0)


def _lane_state(shape, axis, lanes=(0, 1, 1, 0), seed=5):
    _, par = tp.level(jt, shape, seed)
    arrays = convert.params_to_torch(par)
    grouped = tuple(torch.stack([a, 2 * a]) for a in arrays[:3]) + arrays[3:]
    st = line_gs.line_state(grouped, shape, axis,
                            lanes=torch.tensor(lanes, dtype=torch.int32))
    e = [tp.random_fields(shape, seed + b) for b in range(len(lanes))]
    s = [tp.random_fields(shape, seed + 10 + b) for b in range(len(lanes))]
    stack = lambda f: tuple(torch.tensor(np.stack(c)) for c in zip(*f))
    return st, stack(e), stack(s)


@pytest.mark.parametrize('axis', [0, 1, 2])
def test_lane_state_sweep_equals_lane_by_lane(axis):
    """The plain sweep of a lane state (every lane at once, each with its
    group's η and factor stack) is bitwise the one-lane sweep of each
    lane; each group's stack is that of its one-lane state."""
    shape = (7, 5, 9)
    st, e, s = _lane_state(shape, axis)
    assert st.factors.shape[0] == 2 and line_gs.lane_count(st) == 4
    out = tuple(t.clone() for t in e)
    got = line_gs.line_relaxation(out, s, st, 2)
    assert all(a is b for a, b in zip(got, out))          # in place
    for b, g in enumerate(st.lanes.tolist()):
        one = line_gs.lane_state(st, g)
        ref_state = line_gs.line_state(
            tuple(a[g] for a in st.arrays[:3]) + st.arrays[3:], st.shape, 0)
        assert torch.equal(one.factors, ref_state.factors)
        eb = tuple(t[b].clone() for t in e)
        line_gs.line_relaxation(eb, tuple(t[b] for t in s), one, 2)
        assert all(torch.equal(x[b], y) for x, y in zip(out, eb))


def test_lane_state_checks(monkeypatch):
    shape = (5, 4, 3)
    st, e, s = _lane_state(shape, 0)
    with pytest.raises(ValueError, match='shape'):
        line_gs.line_relaxation(tuple(t[0] for t in e),
                                tuple(t[0] for t in s), st, 1)
    with pytest.raises(ValueError, match='groups'):
        line_gs.line_state(st.arrays, shape, 0,
                           lanes=torch.tensor([0, 2], dtype=torch.int32))
    with pytest.raises(ValueError, match='lane state'):
        line_gs.line_state(st.arrays, shape, 0,
                           lanes=torch.tensor([0, 1]))           # int64

    def boom():
        raise AssertionError("kernel library requested for CPU tensors")
    monkeypatch.setattr(_build, 'library', boom)
    with pytest.raises(ValueError, match='no line-relaxation kernel'):
        line_gs.residual(e, s, st, 0, tuple(torch.empty_like(t) for t in e))
    with pytest.raises(ValueError, match='no line-relaxation kernel'):
        line_gs.thomas(e, s, st.factors, st, 0)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    grid, model = _problem(4)
    _, (gp, mp, sp) = _pairs(grid, model, [(0, 1.0)])
    with pytest.raises(RuntimeError, match='CUDA'):
        pt.solve_batched(gp, mp, sp, verb=0)
