"""Port vs JAX package: line relaxation and its kernels' plain versions.

- The factor stack entry by entry against
  ``block_tridiag_factor_entries(5, *_line_entries_x(...))``, rel 1e-12
  (fp64; the elimination's operation order is the JAX package's, the
  complex division differs in the last bits).
- ``line_relaxation`` (the port's torch-op path, and the wrapper with
  its cached line state, which runs the plain version on the CPU) against
  ``emg3d_tpu.ops.smoothers.line_relaxation`` in complex128, rel 1e-12.
- The plain version in complex64 against the JAX Pallas line kernels in
  interpret mode on float32 split inputs from the same seed, atol 2e-5
  (float32 rounding), as tests/test_pallas_lr.py:19-47 runs them.
- The Thomas launch geometry (tests/test_torch_line_factor.py holds
  its shared-memory plan), the memory rule of the line state
  (identical fields whether factor stacks are cached or rebuilt) and
  the wrapper's checks.
"""
import pytest

pytest.importorskip('jax')

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import emg3d_tpu as jt  # noqa: E402
from emg3d_tpu import cx  # noqa: E402
from emg3d_tpu.ops import smoothers as jsm  # noqa: E402
from emg3d_tpu.ops.blocksolve import block_tridiag_factor_entries  # noqa
from emg3d_tpu.ops.coeffs import node_coefficients  # noqa: E402
from emg3d_tpu.ops.pallas_lr import (line_factors,  # noqa: E402
                                     line_relaxation_pallas, rotate_arrays)

import emg3d_tpu_torch as pt  # noqa: E402
from emg3d_tpu_torch import convert, solver  # noqa: E402
from emg3d_tpu_torch.ops import _build, line_gs, stencil  # noqa: E402
from emg3d_tpu_torch.ops import smoothers as psm  # noqa: E402

import torch_parity as tp  # noqa: E402
from test_pallas_gs import _setup  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-12
_t = convert.fields_to_torch

# One compiled program per call instead of one per eager JAX op.
_j_lr = jax.jit(jsm.line_relaxation, static_argnames=('nu', 'axis'))


@jax.jit
def _j_factors(arrays):
    nx = arrays[0].shape[0]
    return block_tridiag_factor_entries(
        5, *jsm._line_entries_x(node_coefficients(*arrays), nx))


def _inputs(shape, seed):
    _, par = tp.level(jt, shape, seed=seed)
    e = tp.random_fields(shape, seed=seed + 1)
    s = tp.random_fields(shape, seed=seed + 2)
    return par, e, s


@pytest.mark.parametrize('axis', [0, 1, 2])
@pytest.mark.parametrize('shape', [(4, 4, 4), (7, 5, 9)])
def test_factor_entries_match_jax(shape, axis):
    par, _, _ = _inputs(shape, seed=5)
    rot = rotate_arrays(tp.to_jax(par), axis)
    L_j, d_j, = _j_factors(rot)
    nx = rot[0].shape[0]
    _, B_j = jsm._line_entries_x(node_coefficients(*rot), nx)
    fac = line_gs.line_factors(convert.params_to_torch(par), shape, axis)
    rs = psm.rotate_shape(shape, axis)
    assert tuple(fac.shape) == (rs[0], psm.NLINE, 2, 2, rs[1] // 2,
                                rs[2] // 2)
    L_p, d_p, B_p = convert.line_factors_to_numpy(fac, rs)
    got = [*L_p, *d_p, *(B_p[k] for k in psm.LINE_BKEYS)]
    want = [*L_j, *d_j, *(B_j[k] for k in psm.LINE_BKEYS)]
    for a, b in zip(got, want):
        b = np.broadcast_to(np.asarray(b), a.shape)
        assert tp.rel((a,), (b,)) < TOL
    # And back: the JAX entries carried into the port's stack.
    back = convert.line_factors_to_torch(L_j, d_j, B_j)
    assert tp.rel((back,), (fac,)) < TOL
    assert torch.equal(convert.line_factors_to_torch(L_p, d_p, B_p), fac)


@pytest.mark.parametrize('nu', [1, 2])
@pytest.mark.parametrize('axis', [0, 1, 2])
@pytest.mark.parametrize('shape', [(4, 4, 4), (7, 5, 9), (9, 7, 9),
                                   (12, 8, 8)])
def test_line_relaxation_matches_jax(shape, axis, nu):
    par, e, s = _inputs(shape, seed=sum(shape) + axis)
    ref = _j_lr(*tp.to_jax(e), *tp.to_jax(s), *tp.to_jax(par), nu=nu,
                axis=axis)
    par_t = convert.params_to_torch(par)

    out = psm.line_relaxation(*_t(e), *_t(s), *par_t, nu=nu, axis=axis)
    assert tp.rel(out, ref) < TOL

    state = line_gs.line_state(par_t, shape, axis)
    et = _t(e)
    got = line_gs.line_relaxation(et, _t(s), state, nu)
    assert tp.rel(got, ref) < TOL
    assert all(a is b for a, b in zip(got, et))        # in place
    ep = _t(e)
    line_gs.line_relaxation_plain(ep, _t(s), state, nu)
    assert all(torch.equal(a, b) for a, b in zip(ep, et))


@pytest.mark.parametrize('shape,axis,nu', [
    ((12, 8, 8), 0, 2), ((12, 8, 8), 1, 1), ((12, 8, 8), 2, 1),
    ((10, 9, 8), 0, 2), ((10, 9, 8), 1, 1), ((10, 9, 8), 2, 1)])
def test_plain_complex64_matches_pallas_interpret(shape, axis, nu):
    e_j, s_j, par_j = _setup(shape, seed=11)
    fs = None if axis == 0 else line_factors(par_j, shape, axis)
    ref = line_relaxation_pallas(e_j, s_j, par_j, nu=nu, shape=shape,
                                 axis=axis, fstack=fs, interpret=True)

    def c64(a):
        if isinstance(a, cx.C2):
            return torch.tensor(np.asarray(cx.tocomplex(a)),
                                dtype=torch.complex64)
        return torch.tensor(np.asarray(a), dtype=torch.float32)
    state = line_gs.line_state(tuple(c64(a) for a in par_j), shape, axis)
    assert state.factors.dtype == torch.complex64
    out = line_gs.line_relaxation(tuple(c64(a) for a in e_j),
                                  tuple(c64(a) for a in s_j), state, nu)
    assert out[0].dtype == torch.complex64
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(cx.tocomplex(b)),
                                   atol=2e-5)


@pytest.mark.parametrize('shape', [(3, 3, 3), (4, 4, 4), (7, 5, 9),
                                   (9, 7, 9), (64, 64, 64)])
def test_launch_geometry(shape):
    _, ny, nz = shape
    seen = set()
    for color in range(4):
        g = line_gs.launch_geometry(shape, color)
        cy, cz, counts, blocks = g.cy, g.cz, g.counts, g.blocks
        assert cy + 2 * cz == color
        lines = {(j, k) for j in range(1, ny) for k in range(1, nz)
                 if (j - 1) % 2 == cy and (k - 1) % 2 == cz}
        assert counts[0] * counts[1] == len(lines)
        # Thread (q, r) takes line (1 + cy + 2q, 1 + cz + 2r).
        assert lines == {(1 + cy + 2 * q, 1 + cz + 2 * r)
                         for q in range(counts[0]) for r in range(counts[1])}
        seen |= lines
        if not lines:
            assert (blocks, g.threads) == (0, 0)
        else:
            # One warp per block, lines_per_block lines each.
            lpb = g.lines_per_block
            assert g.threads == 32 and lpb in (1, 2, 4, 8, 16, 32)
            assert blocks * lpb >= len(lines) > (blocks - 1) * lpb
            # Within the factor stack's parity quarter.
            assert counts[0] <= ny // 2 and counts[1] <= nz // 2
    assert len(seen) == (ny - 1) * (nz - 1)
    # K3: slabs of rows × lines × stations cover the colour's lines.
    for color in range(4):
        g = line_gs.residual_geometry(shape, color)
        assert g.counts == line_gs.launch_geometry(shape, color).counts
        assert g.threads % 32 == 0 and g.threads <= 256
        assert g.threads >= 5 * g.rows * g.lines
        slabs = [-(-n // d) for n, d in zip(
            (*g.counts, shape[0]), (g.rows, g.lines, g.xplanes))]
        assert g.blocks == (np.prod(slabs) if np.prod(g.counts) else 0)
        assert g.smem_bytes <= line_gs.SMEM_MAX
        assert g.staged == (g.xplanes >= line_gs.RES_STAGED) == (
            g.smem_bytes > 0)


@pytest.mark.parametrize('axis', [0, 1, 2])
@pytest.mark.parametrize('shape', [(3, 3, 3), (7, 5, 9), (9, 7, 9),
                                   (8, 8, 8)])
def test_colour_edges_complete(shape, axis):
    """Line relaxation whose residual holds only the colour's edges
    (``line_gs.colour_edges``) and NaN everywhere else equals the JAX
    package's: the Thomas step of a colour reads no other entry."""
    par, e, s = _inputs(shape, seed=sum(shape) + axis)
    ref = _j_lr(*tp.to_jax(e), *tp.to_jax(s), *tp.to_jax(par), nu=1,
                axis=axis)
    state = line_gs.line_state(convert.params_to_torch(par), shape, axis)
    er = line_gs._rotated(_t(e), axis)
    sr = line_gs._rotated(_t(s), axis)
    for color in psm.line_color_sequence(1):
        r = tuple(torch.full_like(t, complex(np.nan, np.nan)) for t in er)
        line_gs.residual_plain(er, sr, state, color, r)
        masks = line_gs.colour_edge_masks(state.shape, color)
        for t, m in zip(r, masks):
            assert bool(torch.isfinite(t[m]).all())
            assert bool(torch.isnan(t[~m]).all())
        er = psm.line_thomas_x(er, r, state.factors, color)
    out = psm.unrotate_fields(er, axis)
    assert all(bool(torch.isfinite(t).all()) for t in out)
    assert tp.rel(out, ref) < TOL


def _colour_work_brute(shape, color):
    """colour_residual_work counted edge by edge from the stencil."""
    ex, ey, ez, f1, f2, f3 = (set() for _ in range(6))
    rx, ry, rz = line_gs.colour_edges(shape, color)
    n = 0
    for comp, rng in enumerate((rx, ry, rz)):
        for i in rng[0]:
            for j in rng[1]:
                for k in rng[2]:
                    n += 1
                    if comp == 0:       # u3(i,j|j-1,k), u2(i,j,k|k-1)
                        f3 |= {(i, j, k), (i, j - 1, k)}
                        f2 |= {(i, j, k), (i, j, k - 1)}
                    elif comp == 1:     # u1(i,j,k|k-1), u3(i|i-1,j,k)
                        f1 |= {(i, j, k), (i, j, k - 1)}
                        f3 |= {(i, j, k), (i - 1, j, k)}
                    else:               # u2(i|i-1,j,k), u1(i,j|j-1,k)
                        f2 |= {(i, j, k), (i - 1, j, k)}
                        f1 |= {(i, j, k), (i, j - 1, k)}
    for i, j, k in f1:
        ez |= {(i, j, k), (i, j + 1, k)}
        ey |= {(i, j, k), (i, j, k + 1)}
    for i, j, k in f2:
        ex |= {(i, j, k), (i, j, k + 1)}
        ez |= {(i, j, k), (i + 1, j, k)}
    for i, j, k in f3:
        ey |= {(i, j, k), (i + 1, j, k)}
        ex |= {(i, j, k), (i, j + 1, k)}
    reads = len(ex) + len(ey) + len(ez)
    return 3 * n * 16 + reads * 16 + (len(f1) + len(f2) + len(f3)) * 8, \
        n * 76


@pytest.mark.parametrize('shape', [(3, 3, 3), (7, 5, 9), (4, 6, 5)])
def test_colour_residual_work(shape):
    import chip_smoke
    for color in range(4):
        work = chip_smoke.colour_residual_work(shape, color)
        assert work == _colour_work_brute(shape, color)
        assert work[0] < chip_smoke.residual_work(shape)[0]
        # No colour edge lies on the PEC boundary (where r = s).
        mx, my, mz = line_gs.colour_edge_masks(shape, color)
        for m, axes in ((mx, (1, 2)), (my, (0, 2)), (mz, (0, 1))):
            for ax in axes:
                assert not bool(m.select(ax, 0).any())
                assert not bool(m.select(ax, -1).any())


def test_residual_plain_restricted():
    shape = (7, 5, 9)
    par, e, s = _inputs(shape, seed=4)
    state = line_gs.line_state(convert.params_to_torch(par), shape, 0)
    full = stencil.residual_parts(*_t(s), *_t(e), *state.arrays)
    for color in range(4):
        out = tuple(torch.zeros_like(t) for t in full)
        line_gs.residual_plain(_t(e), _t(s), state, color, out)
        for o, f, m in zip(out, full,
                           line_gs.colour_edge_masks(shape, color)):
            assert torch.equal(o[m], f[m])
            assert not bool(o[~m].any())


def _sclr_problem(n=8):
    grid = pt.TensorMesh([np.full(n, 100.)] * 3, origin=(-n * 50.,) * 3)
    model = pt.Model(grid, property_x=1.0, property_z=3.0)
    return grid, model, pt.get_source_field(grid, (0, 0, 0, 0, 0), 1.0)


def test_memory_rule_cached_or_rebuilt(monkeypatch):
    """Identical fields whether the factor stacks are cached or rebuilt.

    A budget of 0 rebuilds every stack at every smoothing call; a budget
    of one finest stack caches that one only; the default caches all.
    """
    grid, model, sfield = _sclr_problem()
    kw = dict(semicoarsening=True, linerelaxation=True, verb=0,
              return_info=True, device='cpu')
    ref, iref = pt.solve(grid, model, sfield, **kw)
    one = line_gs.factor_bytes(grid.shape_cells, 0)
    for budget in (0, one):
        monkeypatch.setattr(line_gs, 'cache_budget', lambda dev: budget)
        e, info = pt.solve(grid, model, sfield, **kw)
        assert info['it_mg'] == iref['it_mg']
        assert info['exit_message'] == 'CONVERGED'
        assert np.array_equal(e.field, ref.field)


def test_line_state_budget_and_sharing(monkeypatch):
    grid, model, sfield = _sclr_problem()
    var = solver.MGParameters(verb=0, cycle='F', sslsolver=False,
                              linerelaxation=True, semicoarsening=True,
                              shape_cells=grid.shape_cells)
    vm = pt.VolumeModel(grid, model, sfield)
    ctx = solver._SolveContext(grid, vm, sfield, pt.Field.zeros(grid),
                               var, torch.device('cpu'))
    one = line_gs.factor_bytes(grid.shape_cells, 0)
    monkeypatch.setattr(line_gs, 'cache_budget', lambda dev: one)
    fine1, fine2 = ctx.levels(1)[0], ctx.levels(2)[0]
    assert fine1.lstate is fine2.lstate              # shared finest
    assert fine1.arrays is fine2.arrays
    assert solver._line_state(fine1, 0).factors is not None
    assert solver._line_state(fine2, 1).factors is None   # over budget
    assert solver._line_state(fine2, 0) is solver._line_state(fine1, 0)
    assert ctx.meter['bytes'] == one
    assert ctx.levels(1)[1].meter is ctx.meter


def test_kernel_entry_points_refuse_cpu(monkeypatch):
    """K3/K4's wrappers launch or raise: no plain path for CPU tensors."""
    def boom():
        raise AssertionError("kernel library requested for CPU tensors")
    monkeypatch.setattr(_build, 'library', boom)
    shape = (5, 4, 3)
    par, e, s = _inputs(shape, seed=2)
    state = line_gs.line_state(convert.params_to_torch(par), shape, 0)
    et, st = _t(e), _t(s)
    with pytest.raises(ValueError, match='no line-relaxation kernel'):
        line_gs.residual(et, st, state, 0, tuple(torch.empty_like(t)
                                                 for t in et))
    with pytest.raises(ValueError, match='no line-relaxation kernel'):
        line_gs.thomas(et, st, state.factors, state, 0)


def test_lr_dir_helpers():
    assert solver._current_lr_dir(7, (2, 5, 5)) == 4
    assert solver._current_lr_dir(4, (5, 2, 2)) == 0
    assert solver._current_lr_dir(6, (5, 5, 2)) == 6
    assert solver._lr_axes(7) == (0, 1, 2)
    assert solver._lr_axes(5) == (0, 2)
    assert solver._lr_axes(0) == ()


def test_cpu_wrapper_never_builds(monkeypatch):
    """CPU tensors run the plain versions; no library, no launch count."""
    def boom():
        raise AssertionError("kernel library requested for CPU tensors")
    monkeypatch.setattr(_build, 'library', boom)
    line_gs.reset_launches()
    shape = (5, 4, 3)
    par, e, s = _inputs(shape, seed=1)
    state = line_gs.line_state(convert.params_to_torch(par), shape, 1)
    line_gs.line_relaxation(_t(e), _t(s), state, 1)
    assert line_gs.LAUNCHES == {'line_factor': 0, 'line_residual': 0,
                                'line_thomas': 0}


def test_wrapper_checks():
    shape = (5, 4, 3)
    par, e, s = _inputs(shape, seed=1)
    state = line_gs.line_state(convert.params_to_torch(par), shape, 2)
    with pytest.raises(ValueError, match='shape'):
        line_gs.line_relaxation(_t(e)[::-1], _t(s), state, 1)
    bad = state._replace(factors=state.factors[:, :, :, :, :1])
    with pytest.raises(ValueError, match='factors: shape'):
        line_gs.line_relaxation(_t(e), _t(s), bad, 1)
    meta = tuple(t.to('meta') for t in _t(e))
    with pytest.raises(ValueError):
        line_gs.line_relaxation(meta, tuple(t.to('meta') for t in _t(s)),
                                state, 1)
