"""Port vs JAX package: autograd through the solve (``diff``).

The setup of tests/test_diff.py at 8³ (unit edge samplers, σ = 1 with a
3 Ω·m-contrast block, 1 Hz, tol 1e-10 in both packages): the port's
``torch.autograd`` gradient of ½‖d − d_obs‖² equals ``jax.grad`` of the
JAX package's ``custom_vjp`` within rel 1e-8

- with respect to log σ;
- with respect to η_x, η_y, η_z (complex) and ζ (real), each checked
  apart, so that a conjugation error shows: PyTorch's gradient of a
  real loss in a complex tensor is ∂L/∂Re + i·∂L/∂Im, the JAX
  package's (re, im) pair read as one complex number;
- with respect to the source, which is the adjoint field λ.
"""
import pytest

pytest.importorskip('jax')

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import emg3d_tpu as jt  # noqa: E402
from emg3d_tpu import cx  # noqa: E402

import emg3d_tpu_torch as pt  # noqa: E402
from emg3d_tpu_torch import convert  # noqa: E402

torch.set_num_threads(1)

N = 8
FREQ = 1.0
TOL = 1e-8
# Unit samplers of one interior edge of each component.
SAMPLES = ((0, (5, 4, 4)), (0, (2, 5, 3)), (1, (4, 2, 5)), (2, (3, 5, 2)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _weights():
    grid = jt.TensorMesh([np.full(N, 100.)] * 3, origin=(-400.,) * 3)
    shapes = (grid.shape_edges_x, grid.shape_edges_y, grid.shape_edges_z)
    out = []
    for comp, idx in SAMPLES:
        w = np.zeros(shapes[comp])
        w[idx] = 1.0
        out.append((comp, w))
    return out


def _sigma_true():
    sig = np.ones((N,) * 3)
    sig[3:5, 3:5, 3:5] = 3.0
    return sig


@pytest.fixture(scope='module')
def jax_side():
    grid = jt.TensorMesh([np.full(N, 100.)] * 3, origin=(-400.,) * 3)
    sf = jt.fields.get_source_field(grid, (0, 0, 0, 0, 0), FREQ,
                                    strength=0)
    s = tuple(cx.aspair(np.asarray(f)) for f in (sf.fx, sf.fy, sf.fz))
    w = [(c, jnp.asarray(a)) for c, a in _weights()]
    fsolve = jt.diff.make_differentiable_solve(grid, FREQ, tol=1e-10,
                                               verb=0)

    def data(arrays4, src):
        return jt.diff.sample_edges(fsolve(arrays4, src), w)

    eta_t, zeta_t = jt.diff.eta_zeta_from_sigma(
        grid, jnp.asarray(_sigma_true()), FREQ)
    d_obs = data((eta_t, eta_t, eta_t, zeta_t), s)

    def misfit(log_sigma):
        eta, zeta = jt.diff.eta_zeta_from_sigma(grid, jnp.exp(log_sigma),
                                                FREQ)
        return 0.5 * jnp.sum((data((eta, eta, eta, zeta), s) - d_obs) ** 2)

    def parts(ex, ey, ez, zeta, src):
        return 0.5 * jnp.sum((data((ex, ey, ez, zeta), src) - d_obs) ** 2)

    log0 = jnp.zeros((N,) * 3)
    val, g_log = jax.value_and_grad(misfit)(log0)
    eta0, zeta0 = jt.diff.eta_zeta_from_sigma(grid, jnp.exp(log0), FREQ)
    g_parts = jax.grad(parts, argnums=(0, 1, 2, 3, 4))(
        eta0, eta0, eta0, zeta0, s)
    to_c = lambda p: np.asarray(p.re) + 1j * np.asarray(p.im)  # noqa: E731
    return {'misfit': float(val), 'log': np.asarray(g_log),
            'eta': [to_c(g) for g in g_parts[:3]],
            'zeta': np.asarray(g_parts[3]),
            'src': [to_c(g) for g in g_parts[4]],
            'd_obs': np.asarray(d_obs)}


@pytest.fixture(scope='module')
def torch_side():
    grid = pt.TensorMesh([np.full(N, 100.)] * 3, origin=(-400.,) * 3)
    sf = pt.get_source_field(grid, (0, 0, 0, 0, 0), FREQ, strength=0)
    w = [(c, torch.tensor(a)) for c, a in _weights()]
    fsolve = pt.diff.make_differentiable_solve(grid, FREQ, tol=1e-10,
                                               device='cpu')

    def data(arrays4, src):
        return pt.diff.sample_edges(fsolve(arrays4, src), w)

    s = tuple(torch.tensor(np.asarray(f)) for f in (sf.fx, sf.fy, sf.fz))
    eta_t, zeta_t = pt.diff.eta_zeta_from_sigma(
        grid, torch.tensor(_sigma_true()), FREQ)
    d_obs = data((eta_t, eta_t, eta_t, zeta_t), s).detach()

    log0 = torch.zeros((N,) * 3, dtype=torch.float64, requires_grad=True)
    eta, zeta = pt.diff.eta_zeta_from_sigma(grid, torch.exp(log0), FREQ)
    val = 0.5 * torch.sum((data((eta, eta, eta, zeta), s) - d_obs).abs()
                          ** 2)
    val.backward()

    eta0, zeta0 = pt.diff.eta_zeta_from_sigma(
        grid, torch.ones((N,) * 3, dtype=torch.float64), FREQ)
    leaves = [t.clone().requires_grad_(True)
              for t in (eta0, eta0, eta0, zeta0, *s)]
    L = 0.5 * torch.sum((data(leaves[:4], leaves[4:]) - d_obs).abs() ** 2)
    grads = torch.autograd.grad(L, leaves)
    return {'misfit': float(val.detach()), 'log': log0.grad.numpy(),
            'eta': [g.numpy() for g in grads[:3]],
            'zeta': grads[3].numpy(), 'src': [g.numpy() for g in grads[4:]],
            'd_obs': d_obs.numpy(), 'dtypes': [g.dtype for g in grads]}


def test_observed_data_and_misfit(jax_side, torch_side):
    d_j = jax_side['d_obs'][:, 0] + 1j * jax_side['d_obs'][:, 1]
    assert _rel(torch_side['d_obs'], d_j) < TOL
    assert abs(torch_side['misfit'] - jax_side['misfit']) < \
        TOL * jax_side['misfit']


def test_grad_log_sigma(jax_side, torch_side):
    g = torch_side['log']
    assert np.isfinite(g).all() and np.any(g)
    assert _rel(g, jax_side['log']) < TOL


@pytest.mark.parametrize('comp', [0, 1, 2])
def test_grad_eta(jax_side, torch_side, comp):
    assert torch_side['dtypes'][comp] == torch.complex128
    g, ref = torch_side['eta'][comp], jax_side['eta'][comp]
    assert np.any(ref.real) and np.any(ref.imag)
    assert _rel(g, ref) < TOL
    # A conjugated gradient would be far off.
    assert _rel(np.conj(g), ref) > 1e-3


def test_grad_zeta(jax_side, torch_side):
    assert torch_side['dtypes'][3] == torch.float64
    assert _rel(torch_side['zeta'], jax_side['zeta']) < TOL


def test_grad_source_is_adjoint_field(jax_side, torch_side):
    for comp in range(3):
        g, ref = torch_side['src'][comp], jax_side['src'][comp]
        assert np.isfinite(g).all()
        assert _rel(g, ref) < TOL
    # The convert helpers carry the pairs across both ways.
    t = convert.pair_to_torch(convert.tensor_to_pair(
        torch.tensor(torch_side['src'][0])))
    assert np.array_equal(t.numpy(), torch_side['src'][0])


def test_device_checks(monkeypatch):
    grid = pt.TensorMesh([np.full(4, 100.)] * 3, origin=(-200.,) * 3)
    fs = pt.diff.make_differentiable_solve(grid, FREQ, device='cpu')
    sf = pt.get_source_field(grid, (0, 0, 0, 0, 0), FREQ)
    s = tuple(torch.tensor(np.asarray(f)) for f in (sf.fx, sf.fy, sf.fz))
    eta, zeta = pt.diff.eta_zeta_from_sigma(
        grid, torch.ones((4,) * 3, dtype=torch.float64), FREQ)
    e = fs((eta, eta, eta, zeta), s)
    assert [t.shape for t in e] == [t.shape for t in s]
    with pytest.raises(ValueError, match='runs on'):
        fs((eta.to('meta'), eta, eta, zeta), s)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        pt.diff.make_differentiable_solve(grid, FREQ)
