"""Port vs JAX package: source fields, stencil and grid transfers.

Inputs are made by numpy from a seed and fed to both packages; the port
runs in complex128 on the CPU.  Tolerance: rel 1e-12 (max |Δ| over
max |JAX|), float64 summation-order noise.
"""
import pytest

pytest.importorskip('jax')

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import emg3d_tpu as jt  # noqa: E402
from emg3d_tpu.ops import stencil as jst, transfers as jtr  # noqa: E402

import emg3d_tpu_torch as pt  # noqa: E402
from emg3d_tpu_torch import convert  # noqa: E402
from emg3d_tpu_torch.ops import stencil as pst, transfers as ptr  # noqa

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-12
_t = convert.fields_to_torch

# One compiled program per call instead of one per eager JAX op.
_j_restrict = jax.jit(jtr.restrict, static_argnums=(4,))
_j_prolongate = jax.jit(jtr.prolongate, static_argnums=(7,))
_j_restrict_param = jax.jit(jtr.restrict_model_parameter,
                            static_argnums=(1,))
_j_residual = jax.jit(jst.residual_parts)
_j_pec = jax.jit(jst.pec_mask_apply)

SHAPES = [(2, 2, 2), (4, 4, 4), (7, 5, 9), (8, 6, 10)]


@pytest.mark.parametrize('src,electric', [
    ((-120., 130., -10., 15., -5., 25.), True),      # finite dipole
    ((10., -20., 5., 30., 60.), True),               # point dipole
    ((10., -20., 5., 30., 60.), False),              # magnetic: loop
    ([[-100., 50., 120.], [-30., 40., 10.],          # polyline
      [0., 20., -40.]], True),
])
def test_source_field_all_formats(src, electric):
    grid_j = jt.TensorMesh([np.full(8, 80.), np.full(6, 90.),
                            np.full(7, 70.)], origin=(-320, -270, -245))
    grid_p = convert.mesh_to_torch(grid_j)
    sj = jt.get_source_field(grid_j, src, 1.5, electric=electric)
    sp = pt.get_source_field(grid_p, src, 1.5, electric=electric)
    for a, b in zip((sj.fx, sj.fy, sj.fz), (sp.fx, sp.fy, sp.fz)):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(sj.moment, sp.moment)
    assert sj._frequency == sp._frequency
    assert float(sj.norm()) == float(sp.norm())


@pytest.mark.parametrize('shape', SHAPES)
def test_amat_residual_pec(shape):
    _, par = tp.level(jt, shape, seed=sum(shape))
    e = tp.random_fields(shape, seed=1)
    s = tp.random_fields(shape, seed=2)
    par_t = convert.params_to_torch(par)

    aj = jst.amat(*tp.to_jax(e), *tp.to_jax(par))
    ap = pst.amat(*_t(e), *par_t)
    assert tp.rel(ap, aj) < TOL

    rj = _j_residual(*tp.to_jax(s), *tp.to_jax(e), *tp.to_jax(par))
    rp = pst.residual_parts(*_t(s), *_t(e), *par_t)
    assert tp.rel(rp, rj) < TOL

    mj = _j_pec(*tp.to_jax(e))
    mp = pst.pec_mask_apply(*_t(e))
    for a, b in zip(mp, mj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    for fj, fp in ((jst.zeta_face_weights(tp.to_jax(par)[3]),
                    pst.zeta_face_weights(par_t[3])),
                   (jst.eta_edge_sums(*tp.to_jax(par[:3])),
                    pst.eta_edge_sums(*par_t[:3]))):
        assert tp.rel(fp, fj) < TOL


def _weights(h, coarsen, mod):
    """Per-direction restriction/prolongation weights of stretched h."""
    rw, pw = [None] * 3, [None] * 3
    for ax in range(3):
        if not coarsen[ax]:
            continue
        nodes = np.r_[0., np.cumsum(h[ax])]
        cnodes = nodes[::2]
        ch = np.diff(cnodes)
        centers = (nodes[:-1] + nodes[1:]) / 2
        ccenters = (cnodes[:-1] + cnodes[1:]) / 2
        rw[ax] = mod.restrict_weights_1d(nodes, centers, h[ax], cnodes,
                                         ccenters, ch)
        pw[ax] = mod.prolong_weights_1d(nodes, cnodes)
    return rw, pw


PATTERNS = [(True, True, True), (False, True, True), (True, False, True),
            (True, True, False), (True, False, False),
            (False, True, False), (False, False, True)]


@pytest.mark.parametrize('coarsen', PATTERNS)
def test_restrict_prolongate(coarsen):
    shape = (8, 6, 10)
    rng = np.random.default_rng(5)
    h = [rng.uniform(50, 150, n) for n in shape]
    rwj, pwj = _weights(h, coarsen, jtr)
    rwp, pwp = _weights(h, coarsen, ptr)
    # The host weight functions are copies: identical results.
    for a, b in zip(rwj + pwj, rwp + pwp):
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def tw(w):
        return torch.tensor(w, dtype=torch.float64)
    rw_t = tuple(None if w is None else tuple(tw(x) for x in w)
                 for w in rwp)
    pw_t = tuple(None if w is None else tw(w) for w in pwp)

    r = tp.random_fields(shape, seed=3)
    cj = _j_restrict(*tp.to_jax(r), tuple(rwj), coarsen)
    cp = ptr.restrict(*_t(r), rw_t, coarsen)
    assert [tuple(c.shape) for c in cp] == [tuple(c.shape) for c in cj]
    assert tp.rel(cp, cj) < TOL

    cshape = tuple(n // 2 if c else n for n, c in zip(shape, coarsen))
    ce = tp.random_fields(cshape, seed=4)
    e = tp.random_fields(shape, seed=6)
    pj = _j_prolongate(*tp.to_jax(e), *tp.to_jax(ce), tuple(pwj),
                       coarsen)
    pp = ptr.prolongate(*_t(e), *_t(ce), pw_t, coarsen)
    assert tp.rel(pp, pj) < TOL

    _, par = tp.level(jt, shape, seed=9)
    for p in (par[0], par[3]):
        mj = _j_restrict_param(tp.to_jax((p,))[0], coarsen)
        mp = ptr.restrict_model_parameter(torch.tensor(p), coarsen)
        assert mp.shape == tuple(mj.shape)
        assert tp.rel((mp,), (mj,)) < TOL


def test_field_host_methods():
    grid_j = jt.TensorMesh([np.full(n, 50.) for n in (4, 3, 5)])
    grid_p = convert.mesh_to_torch(grid_j)
    comps = tp.random_fields((4, 3, 5), seed=8)
    fj = jt.Field(*comps, frequency=2.0)
    fp = pt.Field(*comps, frequency=2.0)
    np.testing.assert_array_equal(fp.field, fj.field)
    for a, b in zip(fp.ensure_pec().field, fj.ensure_pec().field):
        assert a == b
    sj = jt.SourceField(*comps, frequency=2.0).ensure_pec()
    sp = pt.SourceField(*comps, frequency=2.0).ensure_pec()
    assert type(sp) is pt.SourceField and type(sj) is jt.SourceField
    np.testing.assert_array_equal(sp.field, sj.field)
    assert fp.norm() == float(fj.norm())
    assert fp.smu0 == fj.smu0
    back = pt.Field.from_flat(grid_p, fj.field, frequency=2.0)
    np.testing.assert_array_equal(back.fx, comps[0])
    again = jt.Field.from_dict(fp.to_dict())
    np.testing.assert_array_equal(np.asarray(again.fz), comps[2])
    zp = pt.SourceField.zeros(grid_p, frequency=-1.0)
    zj = jt.SourceField.zeros(grid_j, frequency=-1.0)
    assert zp.fx.dtype == np.asarray(zj.fx).dtype == np.float64
