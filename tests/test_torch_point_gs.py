"""Port vs JAX package: the point Gauss-Seidel smoother.

- The port's plain smoother (and the kernel wrapper, which runs it for
  CPU tensors, in both modes) against ``emg3d_tpu.ops.smoothers`` in
  complex128, rel 1e-12.
- Single colours against ``smoothers._point_color_update``, as
  tests/test_pallas_gs.py:57-72 holds the Pallas kernel.
- The port's plain version in complex64 against the JAX Pallas kernels
  in interpret mode (``_kernel_resident`` by default, ``_kernel`` with a
  ``_tx`` override) on float32 split inputs from the same seed, atol
  1e-5 (float32 rounding), as tests/test_pallas_gs.py:17-54 runs them.
"""
import pytest

pytest.importorskip('jax')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import emg3d_tpu as jt  # noqa: E402
from emg3d_tpu import cx  # noqa: E402
from emg3d_tpu.ops import smoothers as jsm  # noqa: E402
from emg3d_tpu.ops.blocksolve import ldl_factor_sparse  # noqa: E402
from emg3d_tpu.ops.coeffs import (node_block_entries,  # noqa: E402
                                  node_coefficients)
from emg3d_tpu.ops.pallas_gs import gauss_seidel_point_pallas  # noqa

from emg3d_tpu_torch import convert  # noqa: E402
from emg3d_tpu_torch.ops import point_gs, smoothers as psm  # noqa: E402

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-12
_t = convert.fields_to_torch

# One compiled program per call instead of one per eager JAX op.
_j_gs = jax.jit(jsm.gauss_seidel_point, static_argnames=('nu',))
_j_color = jax.jit(jsm._point_color_update, static_argnums=(4,))
SHAPES = [(2, 2, 2), (4, 4, 4), (7, 5, 9), (8, 8, 8)]


def _inputs(shape, seed):
    _, par = tp.level(jt, shape, seed=seed)
    e = tp.random_fields(shape, seed=seed + 1)
    s = tp.random_fields(shape, seed=seed + 2)
    return par, e, s


@pytest.mark.parametrize('nu', [1, 2, 3])
@pytest.mark.parametrize('shape', SHAPES)
def test_plain_matches_jax(shape, nu):
    par, e, s = _inputs(shape, seed=sum(shape))
    ref = _j_gs(*tp.to_jax(e), *tp.to_jax(s), *tp.to_jax(par), nu=nu)
    par_t = convert.params_to_torch(par)

    out = psm.gauss_seidel_point(*_t(e), *_t(s),
                                 *par_t, nu=nu)
    assert tp.rel(out, ref) < TOL

    for factored in (True, False):
        state = point_gs.point_state(par_t, shape, factored=factored)
        et = _t(e)
        got = point_gs.gauss_seidel_point(et, _t(s), state, nu)
        assert tp.rel(got, ref) < TOL, factored
        assert all(a is b for a, b in zip(got, et))   # in place


def test_single_colors_exact():
    shape = (12, 8, 8)
    par, e, s = _inputs(shape, seed=7)
    fact = ldl_factor_sparse(6, node_block_entries(
        node_coefficients(*tp.to_jax(par))))
    par_t = convert.params_to_torch(par)
    for factored in (True, False):
        state = point_gs.point_state(par_t, shape, factored=factored)
        for color in (0, 3, 7):
            ref = _j_color(tp.to_jax(e), tp.to_jax(s), tp.to_jax(par),
                           fact, color)
            out = point_gs.gauss_seidel_point(
                _t(e), _t(s), state, 1, _seq=(color,))
            assert tp.rel(out, ref) < TOL, (factored, color)


def _pallas_setup(shape, seed=3):
    """tests/test_pallas_gs.py:_setup, in both packages."""
    rng = np.random.default_rng(seed)
    grid = jt.TensorMesh([rng.uniform(50, 150, n) for n in shape])
    model = jt.Model(grid, property_x=rng.uniform(.1, 10,
                                                  grid.shape_cells))
    sfield = jt.SourceField.zeros(grid, frequency=0.9)
    sfield.fx[shape[0]//2, shape[1]//2, shape[2]//2] = 1 + 0.5j
    vm = jt.VolumeModel(grid, model, sfield)
    arrays = [np.asarray(a) for a in (vm.eta_x, vm.eta_y, vm.eta_z,
                                      vm.zeta, *grid.h)]
    par_j = tuple(cx.aspair(a, dtype=jnp.float32) if np.iscomplexobj(a)
                  else jnp.asarray(a, dtype=jnp.float32) for a in arrays)
    s_np = [np.asarray(f) for f in (sfield.fx, sfield.fy, sfield.fz)]
    s_j = tuple(cx.aspair(f, dtype=jnp.float32) for f in s_np)
    e_j = tuple(cx.zeros_like(x) for x in s_j)

    # The port in complex64/float32 from the same numbers.
    par_t = tuple(torch.tensor(a.astype(np.complex64 if np.iscomplexobj(a)
                                        else np.float32)) for a in arrays)
    s_t = convert.fields_to_torch(s_np, dtype=torch.complex64)
    e_t = tuple(torch.zeros_like(t) for t in s_t)
    return (e_j, s_j, par_j), (e_t, s_t, par_t)


@pytest.mark.parametrize('shape,tx', [((12, 8, 8), None),
                                      ((12, 8, 8), 5)])
def test_plain_complex64_matches_pallas_interpret(shape, tx):
    (e_j, s_j, par_j), (e_t, s_t, par_t) = _pallas_setup(shape)
    ref = gauss_seidel_point_pallas(e_j, s_j, par_j, nu=2, shape=shape,
                                    interpret=True, _tx=tx)
    state = point_gs.point_state(par_t, shape, factored=tx is None)
    out = point_gs.gauss_seidel_point(e_t, s_t, state, 2)
    assert out[0].dtype == torch.complex64
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(),
                                   np.asarray(cx.tocomplex(b)), atol=1e-5)
