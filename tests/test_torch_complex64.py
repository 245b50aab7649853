"""Port vs JAX package: the complex64 solve path.

A complex64 source runs the whole solve in complex64/float32, in both
packages (the JAX package with x64 on, as its tests run it; where its
accelerator configuration is meant, with ``EMG3D_TPU_SPLIT=1`` and
``EMG3D_TPU_PIPELINE=1``, as tests/test_solver.py:107-135):

- the double-single residual (``ops.dsres.residual_ds_plain``) on
  tests/test_dsres.py's integer-valued 12×10×8 setup and on a random
  12³ setup of two lanes (exactly representable coefficients): within
  rel 1e-12 of the JAX package's, and within 3e-7·‖r‖ of the float64
  evaluation of the same float32 operator (tests/test_dsres.py:109);
  lanes at once equal lane by lane;
- ``ds_accumulate`` bitwise equal to the JAX package's two-sum;
- the complex64 level arrays, η sums, ζ weights, node-block and line
  station entries and K2's node data within rel 1e-6 of the JAX
  package's float32 values (both compute them in float32: bit for bit
  here); K1's factors and the line factor stacks, whose last planes
  amplify float32 rounding by the cancellation in the elimination (up
  to ~2e-5 in both packages), as close to the float64 factorization of
  the same float32 entries as the JAX package's;
- solves: the 16³ fullspace with point F-cycles (the case that ran in
  complex128 before; the JAX package's default configuration), and at
  8³ with sc+lr standalone, with BiCGSTAB and with GCROT(m,k), and
  ``solve_batched`` with two lanes (MG and BiCGSTAB), against the JAX
  package's accelerator configuration (whose compiled cycles these
  cases share): the same exit message, ``it_mg`` equal in the 16³ case
  and equal or ±1 in the others (ROADMAP §3), ``rel_error`` < 1e-6, the same returned dtype, fields within rel
  2e-5 of the JAX package's and of the complex128 solve;
- mixed-dtype states are refused, the complex64 kernel entry points
  refuse CPU tensors, and the byte accounting takes the element size.
"""
import pytest

pytest.importorskip('jax')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import emg3d_tpu as jt  # noqa: E402
from emg3d_tpu import solver as jsolver  # noqa: E402
from emg3d_tpu.ops import smoothers as jsm  # noqa: E402
from emg3d_tpu.ops import stencil as jstencil  # noqa: E402
from emg3d_tpu.ops.blocksolve import (block_tridiag_factor_entries,  # noqa
                                      ldl_factor_sparse)
from emg3d_tpu.ops.coeffs import (node_block_entries,  # noqa: E402
                                  node_coefficients)
from emg3d_tpu.ops.dsres import residual_ds as j_residual_ds  # noqa: E402
from emg3d_tpu.ops.pallas_lr import rotate_arrays  # noqa: E402

import emg3d_tpu_torch as pt  # noqa: E402
from emg3d_tpu_torch import convert, dtypes, solver  # noqa: E402
from emg3d_tpu_torch.ops import _build, dsres, line_gs, point_gs  # noqa
from emg3d_tpu_torch.ops import blocksolve as pbs  # noqa: E402
from emg3d_tpu_torch.ops import coeffs as pco  # noqa: E402
from emg3d_tpu_torch.ops import smoothers as psm  # noqa: E402
from emg3d_tpu_torch.ops import stencil as pst  # noqa: E402

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

C64 = torch.complex64
REL_FIELD = 2e-5        # complex64 fields against each other
REL_ARRAYS = 1e-6       # float32 level arrays against each other


def _c64(sf, mod):
    """A package's SourceField in complex64."""
    return mod.SourceField(*(np.asarray(getattr(sf, c)).astype(np.complex64)
                             for c in ('fx', 'fy', 'fz')),
                           frequency=sf._frequency)


# ----------------------------------------------------------------------
# The double-single residual
# ----------------------------------------------------------------------

def _edges(shape):
    return tp.edge_shapes(shape)


def _integer_setup():
    """tests/test_dsres.py's setup: integer η/ζ, power-of-two widths (the
    float32 and float64 coefficients are bit-identical), an O(1) hi
    stream with a lo at its rounding level, s = fl32(A64·(hi + lo))."""
    shape = (12, 10, 8)
    rng = np.random.default_rng(11)
    eta = [(rng.integers(-8, 8, shape) + 1j * rng.integers(-8, 8, shape)
            ).astype(np.complex64) for _ in range(3)]
    par = (*eta, rng.integers(1, 8, shape).astype(np.float32),
           np.full(shape[0], 128., np.float32),
           np.full(shape[1], 64., np.float32),
           np.full(shape[2], 128., np.float32))
    hi, lo = [], []
    for sh in _edges(shape):
        hi.append((rng.normal(size=sh) + 1j * rng.normal(size=sh)
                   ).astype(np.complex64))
        lo.append((1e-7 * (rng.normal(size=sh) + 1j * rng.normal(size=sh))
                   ).astype(np.complex64))
    return shape, par, hi, lo


def _random_setup(lanes=2):
    """A random 12³ level of ``lanes`` lanes (η per lane): integer η and
    ζ and random power-of-two widths, so the float32 coefficients are
    exact, random hi/lo streams per lane."""
    shape = (12, 12, 12)
    rng = np.random.default_rng(12)
    eta = [(rng.integers(-9, 9, (lanes,) + shape)
            + 1j * rng.integers(-9, 9, (lanes,) + shape)
            ).astype(np.complex64) for _ in range(3)]
    par = (*eta, rng.integers(1, 9, shape).astype(np.float32),
           *(2.0 ** rng.integers(5, 9, n) for n in shape))
    par = par[:4] + tuple(h.astype(np.float32) for h in par[4:])
    hi = [(rng.normal(size=(lanes,) + sh) + 1j * rng.normal(
        size=(lanes,) + sh)).astype(np.complex64) for sh in _edges(shape)]
    lo = [(1e-7 * (rng.normal(size=(lanes,) + sh) + 1j * rng.normal(
        size=(lanes,) + sh))).astype(np.complex64) for sh in _edges(shape)]
    return shape, par, hi, lo


def _lane(par, b):
    return tuple(a[b] if i < 3 and a.ndim == 4 else a
                 for i, a in enumerate(par))


def _f64_residual(par, hi, lo):
    """s = fl32(A64·(hi + lo)) and the float64 residual s − A64·(hi +
    lo) of the same (exact) operator, per component."""
    par64 = convert.params_to_torch(par)
    e64 = tuple(torch.tensor(h.astype(np.complex128) + lo_)
                for h, lo_ in zip(hi, lo))
    s32 = tuple(a.to(C64) for a in pst.amat(*e64, *par64))
    r64 = pst.residual_parts(*(t.to(torch.complex128) for t in s32),
                             *e64, *par64)
    return s32, r64


def _jax_residual(par, hi, lo, s32):
    out = j_residual_ds(tuple(jnp.asarray(h) for h in hi),
                        tuple(jnp.asarray(x) for x in lo),
                        tuple(jnp.asarray(t.numpy()) for t in s32),
                        tuple(jnp.asarray(a) for a in par))
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize('setup', ['integer', 'random12'])
def test_residual_ds_matches_jax_and_f64(setup):
    if setup == 'integer':
        shape, par, hi, lo = _integer_setup()
        lanes = [(par, hi, lo)]
    else:
        shape, par, hi, lo = _random_setup()
        lanes = [(_lane(par, b), [h[b] for h in hi], [x[b] for x in lo])
                 for b in range(2)]
    outs, s_all = [], []
    for par_b, hi_b, lo_b in lanes:
        s32, r64 = _f64_residual(par_b, hi_b, lo_b)
        s_all.append(s32)
        ar = convert.params_to_torch(par_b, dtype=C64)
        out = dsres.residual_ds_plain(
            tuple(torch.tensor(h) for h in hi_b),
            tuple(torch.tensor(x) for x in lo_b), s32, ar)
        assert all(o.dtype == C64 for o in out)
        outs.append(out)
        ref = _jax_residual(par_b, hi_b, lo_b, s32)
        # The same exact transformations in the same order as JAX.
        for o, j in zip(out, ref):
            assert tp.rel((o.numpy().astype(np.complex128),),
                          (j.astype(np.complex128),)) <= 1e-12
        # Within output-representation accuracy of the f64 residual;
        # the plain float32 evaluation is far off (its noise is of the
        # residual's own size).
        plain = pst.residual_parts(
            *s32, *(torch.tensor(h) for h in hi_b), *ar)
        plain = tuple(p - a for p, a in zip(plain, pst.amat(
            *(torch.tensor(x) for x in lo_b), *ar)))
        for o, r, p in zip(out, r64, plain):
            rn = float(torch.linalg.norm(r))
            err = float(torch.linalg.norm(o.to(torch.complex128) - r))
            err_pl = float(torch.linalg.norm(p.to(torch.complex128) - r))
            assert err < 3e-7 * rn + 1e-30, (err, rn)
            assert err_pl > 20 * err
    if len(lanes) > 1:
        # The batched form: every lane at once (η per lane), equal to
        # lane by lane.
        ar = convert.params_to_torch(par, dtype=C64)
        s = tuple(torch.stack(c) for c in zip(*s_all))
        both = dsres.residual_ds(tuple(torch.tensor(h) for h in hi),
                                 tuple(torch.tensor(x) for x in lo), s, ar)
        for b, out in enumerate(outs):
            assert all(torch.equal(x[b], y) for x, y in zip(both, out))


def test_residual_ds_without_lo():
    """A None lo stream is a zero one."""
    shape, par, hi, lo = _integer_setup()
    s32, _ = _f64_residual(par, hi, lo)
    ar = convert.params_to_torch(par, dtype=C64)
    h = tuple(torch.tensor(x) for x in hi)
    a = dsres.residual_ds(h, None, s32, ar)
    b = dsres.residual_ds(h, tuple(torch.zeros_like(x) for x in h), s32, ar)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_ds_accumulate_matches_jax():
    rng = np.random.default_rng(5)
    shape = (6, 5, 4)

    def cplx(scale):
        return [(scale * (rng.normal(size=sh) + 1j * rng.normal(size=sh))
                 ).astype(np.complex64) for sh in _edges(shape)]
    hi, lo, d = cplx(1.0), cplx(1e-7), cplx(1e-3)
    jh, jl = jsolver._ds_accumulate(*(tuple(jnp.asarray(a) for a in x)
                                      for x in (hi, lo, d)))
    ph, pl = dsres.ds_accumulate(*(tuple(torch.tensor(a) for a in x)
                                   for x in (hi, lo, d)))
    for a, b in zip((*ph, *pl), (*jh, *jl)):
        assert a.dtype == C64
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # The two-sum is exact: hi + lo = hi₀ + fl32(d + lo₀) in float64.
    for h, l_, h0, l0, d0 in zip(ph, pl, hi, lo, d):
        got = h.numpy().astype(np.complex128) + l_.numpy()
        want = h0.astype(np.complex128) + (d0 + l0)
        np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# Level arrays in float32
# ----------------------------------------------------------------------

@jax.jit
def _j_line_factors(arrays):
    nx = arrays[0].shape[0]
    return block_tridiag_factor_entries(
        5, *jsm._line_entries_x(node_coefficients(*arrays), nx))


def _rel32(a, b):
    return tp.rel((np.asarray(a).astype(np.complex128),),
                  (np.broadcast_to(np.asarray(b), np.shape(a))
                   .astype(np.complex128),))


def _as_close(port, jax_, exact, what):
    """A float32 factor plane of the port as close to the float64 one
    (``exact``) as the JAX package's (``jax_``), up to one float32
    rounding; and within 5e-5 of JAX's (the cancellation both see)."""
    err_p, err_j = _rel32(port, exact), _rel32(jax_, exact)
    assert err_p <= max(2 * err_j, REL_ARRAYS), (what, err_p, err_j)
    assert _rel32(port, jax_) <= 5e-5, what


def test_level_arrays_match_jax():
    shape = (8, 6, 4)
    rng = np.random.default_rng(7)
    h = [60. * 1.1 ** np.abs(np.arange(n) - (n - 1) / 2) for n in shape]
    gj = jt.TensorMesh(h, origin=(0., 0., 0.))
    mj = jt.Model(gj, *(10 ** rng.uniform(0, 1, shape) for _ in range(3)))
    src = (*(hh.sum() / 2 for hh in h), 0., 0.)
    sj = jt.get_source_field(gj, src, 1.0)
    gp, mp = convert.mesh_to_torch(gj), convert.model_to_torch(mj)
    vmj = jt.VolumeModel(gj, mj, sj)
    vmp = pt.VolumeModel(gp, mp, pt.get_source_field(gp, src, 1.0))
    lj = jsolver.build_levels(gj, vmj, 0, 2, np.complex64)
    lp = solver.build_levels(gp, vmp, 0, 2, torch.device('cpu'),
                             {'bytes': 0}, dtype=C64)
    assert len(lj) == len(lp) == 3
    for lvj, lvp in zip(lj, lp):
        assert lvj.shape == lvp.shape
        assert lvp.arrays[0].dtype == C64
        assert all(a.dtype == torch.float32 for a in lvp.arrays[3:])
        for a, b in zip(lvp.arrays, lvj.arrays):
            assert np.asarray(b).dtype in (np.complex64, np.float32)
            assert _rel32(a.numpy(), b) <= REL_ARRAYS
        arj = tuple(jnp.asarray(a) for a in lvj.arrays)
        par = lvp.arrays
        # η edge sums and ζ face weights.
        for a, b in zip(pst.eta_edge_sums(*par[:3]),
                        jstencil.eta_edge_sums(*arj[:3])):
            assert _rel32(a.numpy(), b) <= REL_ARRAYS
        for a, b in zip(pst.zeta_face_weights(par[3]),
                        jstencil.zeta_face_weights(arj[3])):
            assert _rel32(a.numpy(), b) <= REL_ARRAYS
        # The node-block entries; K1's colour-major factors against the
        # float64 factorization of the same entries, as close as the JAX
        # package's float32 factors.
        ent = pco.node_block_entries(pco.node_coefficients(*par))
        entj = node_block_entries(node_coefficients(*arj))
        for k, v in ent.items():
            assert _rel32(v.numpy(), entj[k]) <= REL_ARRAYS, k
        state = point_gs.point_state(par, lvp.shape, factored=True)
        assert state.factors.dtype == C64
        fac = point_gs.unpack_factors(state.factors, lvp.shape)
        L, dinv = ldl_factor_sparse(6, entj)
        want = [L[k] for k in point_gs.LKEYS] + list(dinv)
        L64, d64 = pbs.ldl_factor_sparse(6, {
            k: v.to(torch.complex128) for k, v in ent.items()})
        exact = [L64[k] for k in point_gs.LKEYS] + list(d64)
        for n, (w, x) in enumerate(zip(want, exact)):
            _as_close(fac[n].numpy(), w, x.numpy(), n)
        nodes = point_gs.pack_node_data(state.st, state.w, lvp.shape)
        assert nodes.dtype == C64
        sums, pairs = point_gs.unpack_node_data(nodes, lvp.shape)
        jsums, jpairs = point_gs.node_planes(
            tuple(torch.tensor(np.asarray(t))
                  for t in jstencil.eta_edge_sums(*arj[:3])),
            tuple(torch.tensor(np.asarray(t))
                  for t in jstencil.zeta_face_weights(arj[3])))
        for a, b in zip(sums, jsums):
            assert _rel32(a.numpy(), b.numpy()) <= REL_ARRAYS
        for (a0, a1), (b0, b1) in zip(pairs, jpairs):
            assert _rel32(a0.numpy(), b0.numpy()) <= REL_ARRAYS
            assert _rel32(a1.numpy(), b1.numpy()) <= REL_ARRAYS
    # The finest level's line factor stacks, every axis: the station
    # entries (the B planes) as JAX's, the eliminated planes as close to
    # the float64 elimination of the same entries as JAX's.
    arj = tuple(jnp.asarray(a) for a in lj[0].arrays)
    for axis in range(3):
        rs = psm.rotate_shape(shape, axis)
        stack = line_gs.line_factors(lp[0].arrays, shape, axis)
        assert stack.dtype == C64
        L_p, d_p, B_p = convert.line_factors_to_numpy(stack, rs)
        ar = psm.rotate_arrays(lp[0].arrays, axis)
        exact = psm.factor_line_stack_(
            psm.pack_line_entries(ar, rs).to(torch.complex128))
        L_x, d_x, _ = convert.line_factors_to_numpy(exact, rs)
        rot = rotate_arrays(arj, axis)
        L_j, d_j = _j_line_factors(rot)
        _, B_j = jsm._line_entries_x(node_coefficients(*rot), rs[0])
        for k in psm.LINE_BKEYS:
            assert _rel32(B_p[k], B_j[k]) <= REL_ARRAYS, (axis, k)
        for n, (a, b, x) in enumerate(zip([*L_p, *d_p], [*L_j, *d_j],
                                          [*L_x, *d_x])):
            _as_close(a, b, x, (axis, n))


# ----------------------------------------------------------------------
# Solves
# ----------------------------------------------------------------------

def _fullspace(n):
    grid = jt.TensorMesh([np.full(n, 100.)] * 3, origin=(-n * 50.,) * 3)
    return grid, jt.Model(grid, property_x=1.0), (0., 0., 0., 0., 0.)


def _both(grid_j, model_j, src, freq=1.0):
    grid_p = convert.mesh_to_torch(grid_j)
    model_p = convert.model_to_torch(model_j)
    return ((grid_j, model_j, jt.get_source_field(grid_j, src, freq)),
            (grid_p, model_p, pt.get_source_field(grid_p, src, freq)))


def _rel(a, b):
    a, b = np.asarray(a.field), np.asarray(b.field)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _accelerator(monkeypatch):
    """The JAX package's accelerator configuration on the CPU: split
    re/im fields and pipelined checks (its refined Krylov path)."""
    monkeypatch.setenv('EMG3D_TPU_SPLIT', '1')
    monkeypatch.setenv('EMG3D_TPU_PIPELINE', '1')


SCLR = {'semicoarsening': 1, 'linerelaxation': 1}     # x kept fine, x-lines
# The table's case (16³ fullspace, point F-cycles, the JAX package's
# default configuration; it_mg equal) and sc+lr standalone at 8³ (its
# accelerator configuration, as the Krylov cases below; it_mg ±1):
# (cells per axis, options, accelerator configuration, it_mg slack).
MG_CASES = {
    'point-16': (16, {}, False, 0),
    'sclr-8': (8, SCLR, True, 1),
}


@pytest.mark.parametrize('case', list(MG_CASES))
def test_multigrid_complex64_matches_jax(monkeypatch, case):
    n, opts, accel, slack = MG_CASES[case]
    (gj, mj, sj), (gp, mp, sp) = _both(*_fullspace(n))
    with monkeypatch.context() as m:
        if accel:
            _accelerator(m)
        ej, ij = jt.solve(gj, mj, _c64(sj, jt), cycle='F', verb=1,
                          return_info=True, **opts)
    ep, ip = pt.solve(gp, mp, _c64(sp, pt), cycle='F', verb=1,
                      return_info=True, device='cpu', **opts)
    e2, i2 = pt.solve(gp, mp, sp, cycle='F', verb=1, return_info=True,
                      device='cpu', **opts)
    assert ip['exit_message'] == ij['exit_message'] == 'CONVERGED'
    assert abs(ip['it_mg'] - ij['it_mg']) <= slack
    assert ip['rel_error'] < 1e-6 and ij['rel_error'] < 1e-6
    # The lo stream is live: both return hi + lo in complex128.
    assert ep.field.dtype == np.asarray(ej.field).dtype == np.complex128
    assert _rel(ep, ej) < REL_FIELD
    assert _rel(ep, e2) < REL_FIELD
    # The float32 arithmetic ran: not the complex128 solve's residual.
    assert ip['rel_error'] != i2['rel_error']


@pytest.mark.parametrize('ssl', ['bicgstab', 'gcrotmk'])
def test_krylov_complex64_matches_jax(monkeypatch, ssl):
    """Single-solve Krylov in complex64 runs under two-float refinement,
    as the JAX package's accelerator configuration does."""
    (gj, mj, sj), (gp, mp, sp) = _both(*_fullspace(8))
    opts = dict(cycle='F', sslsolver=ssl, verb=1, return_info=True, **SCLR)
    with monkeypatch.context() as m:
        _accelerator(m)
        ej, ij = jt.solve(gj, mj, _c64(sj, jt), **opts)
    ep, ip = pt.solve(gp, mp, _c64(sp, pt), device='cpu', **opts)
    assert ip['exit_message'] == ij['exit_message'] == 'CONVERGED'
    assert ip['rel_error'] < 1e-6 and ij['rel_error'] < 1e-6
    assert ep.field.dtype == np.asarray(ej.field).dtype == np.complex128
    assert _rel(ep, ej) < REL_FIELD
    assert ip['it_ssl'] >= 1


@pytest.mark.parametrize('ssl', [False, 'bicgstab'])
def test_batched_complex64_matches_jax(ssl):
    """Two lanes (tests/test_batched.py:227-260 at 8³): plain MG goes
    two-float, BiCGSTAB runs unit-norm lanes under refinement."""
    n = 8
    gj = jt.TensorMesh([np.full(n, 100.)] * 3)
    rng = np.random.default_rng(2)
    mj = jt.Model(gj, property_x=rng.uniform(0.5, 5, gj.shape_cells))
    gp, mp = convert.mesh_to_torch(gj), convert.model_to_torch(mj)
    srcs = [[300 + 100 * i, 400, 400, 0, 0] for i in range(2)]
    sj = [_c64(jt.get_source_field(gj, s, 1.0), jt) for s in srcs]
    sp = [_c64(pt.get_source_field(gp, s, 1.0), pt) for s in srcs]
    kw = dict(cycle='F', verb=1, tol=1e-6)
    if ssl:
        kw['sslsolver'] = ssl
    esj, ij = jsolver.solve_batched(gj, mj, sj, **kw)
    esp, ip = pt.solve_batched(gp, mp, sp, device='cpu', **kw)
    assert ip['exit_message'] == ij['exit_message'] == 'CONVERGED'
    assert np.all(ip['rel_error'] < 1e-6) and np.all(ij['rel_error'] < 1e-6)
    assert abs(ip['it_mg'] - ij['it_mg']) <= 1
    for a, b in zip(esp, esj):
        assert a.field.dtype == np.asarray(b.field).dtype == np.complex128
        assert _rel(a, b) < REL_FIELD


# ----------------------------------------------------------------------
# Dtype checks and byte accounting
# ----------------------------------------------------------------------

def _level32(shape, seed, dtype=C64):
    _, par = tp.level(jt, shape, seed=seed)
    return convert.params_to_torch(par, dtype=dtype)


def test_precision_policy():
    assert dtypes.precision(np.complex64) == (torch.float32, C64)
    assert dtypes.precision(np.float32) == (torch.float32, C64)
    assert dtypes.precision(np.complex128) == (torch.float64,
                                               torch.complex128)
    assert dtypes.REAL == torch.float64 and dtypes.COMPLEX == \
        torch.complex128


def test_mixed_dtypes_refused():
    shape = (4, 4, 4)
    par64 = _level32(shape, 3, torch.complex128)
    par32 = _level32(shape, 3)
    e32 = tuple(torch.zeros(sh, dtype=C64) for sh in _edges(shape))
    e64 = tuple(t.to(torch.complex128) for t in e32)
    st64 = point_gs.point_state(par64, shape)
    st32 = point_gs.point_state(par32, shape)
    assert st32.factors.dtype == C64 and st32.w[0].dtype == torch.float32
    point_gs.gauss_seidel_point(e32, e32, st32, 1)      # consistent
    for e, st in ((e32, st64), (e64, st32)):
        with pytest.raises(ValueError, match='state'):
            point_gs.gauss_seidel_point(e, e, st, 1)
    with pytest.raises(ValueError, match='state'):
        point_gs.gauss_seidel_point(e32, e64, st32, 1)
    with pytest.raises(ValueError, match='state'):
        point_gs.gauss_seidel_point(e32, e32, st32._replace(
            w=tuple(t.double() for t in st32.w)), 1)
    ls32 = line_gs.line_state(par32, shape, 0)
    ls64 = line_gs.line_state(par64, shape, 0)
    assert ls32.factors.dtype == C64
    line_gs.line_relaxation(e32, e32, ls32, 1)
    for e, st in ((e32, ls64), (e64, ls32)):
        with pytest.raises(ValueError, match='call'):
            line_gs.line_relaxation(e, e, st, 1)


def test_kernel_entry_points_refuse_cpu():
    shape = (4, 4, 4)
    par32 = _level32(shape, 4)
    st = line_gs.line_state(par32, shape, 0)
    e = tuple(torch.zeros(sh, dtype=C64) for sh in _edges(shape))
    with pytest.raises(ValueError, match='no line-relaxation kernel'):
        line_gs.factor(st.st, st.w, st.ih, st.shape)
    with pytest.raises(ValueError, match='no line-relaxation kernel'):
        line_gs.residual(e, e, st, 0, e)
    with pytest.raises(ValueError, match='no line-relaxation kernel'):
        line_gs.thomas(e, e, st.factors, st, 0)
    with pytest.raises(ValueError, match='no residual_ds kernel'):
        dsres.residual(e, None, e, dsres.ds_params(par32))
    with pytest.raises(ValueError, match='no residual_ds kernel'):
        dsres.residual(e, None, e, dsres.ds_params(par32),
                       _plan=dsres.tile_plan(shape, chunk=1))
    # Every kernel has its complex64 entry point (K6 only that one).
    for name in ('emg3d_point_gs_step', 'emg3d_point_gs_sweep',
                 'emg3d_point_gs_grid_capacity', 'emg3d_line_residual',
                 'emg3d_line_thomas', 'emg3d_line_factor'):
        assert _build.ARGTYPES[name + _build.C64] == _build.ARGTYPES[name]
    assert 'emg3d_residual_ds_c64' in _build.ARGTYPES
    text = (_build.CSRC / 'dsres.cu').read_text()
    assert 'extern "C" int emg3d_residual_ds_c64(' in text
    with pytest.raises(ValueError, match='complex128 or complex64'):
        _build.entry('emg3d_line_factor', torch.float32)


@pytest.mark.parametrize('shape', [(8, 8, 8), (64, 64, 64), (256,) * 3])
def test_byte_accounting_takes_element_size(shape):
    for fn in (point_gs.factor_bytes, point_gs.node_bytes):
        assert 2 * fn(shape, C64) == fn(shape)
    for axis in range(3):
        assert 2 * line_gs.factor_bytes(shape, axis, C64) == \
            line_gs.factor_bytes(shape, axis)
    for kernel in point_gs.KERNELS:
        assert 2 * point_gs._shared_bytes(shape, kernel, C64) == \
            point_gs._shared_bytes(shape, kernel)
    rs = psm.rotate_shape(shape, 1)
    for color in range(4):
        g16 = line_gs.residual_geometry(rs, color)
        g8 = line_gs.residual_geometry(rs, color, dtype=C64)
        assert (g8.blocks, g8.xplanes, g8.staged) == (g16.blocks,
                                                      g16.xplanes,
                                                      g16.staged)
        assert 2 * g8.smem_bytes == g16.smem_bytes
        t16 = line_gs.launch_geometry(rs, color, z_shared=False)
        t8 = line_gs.launch_geometry(rs, color, z_shared=False, dtype=C64)
        assert (t8.blocks, t8.lines_per_block) == (t16.blocks,
                                                   t16.lines_per_block)
        assert 2 * t8.smem_bytes == t16.smem_bytes
    # The plans keep the complex128 rules; only the shared plan's bytes
    # admit it on more levels.
    plan16 = point_gs.sweep_plan(shape, 3)
    plan8 = point_gs.sweep_plan(shape, 3, dtype=C64)
    if plan16.plan != 'shared':
        assert plan8.plan in (plan16.plan, 'shared')
    assert plan8.launches == 1 or plan8.plan == 'step'
