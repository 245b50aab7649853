"""Port vs JAX package: MG-preconditioned GCROT(m,k), end to end.

Both packages solve the same problem on the CPU in complex128 with
``sslsolver='gcrotmk'`` (the JAX package's device-basis
``_gcrotmk_device`` on its host-scalar route, the port's ``_gcrotmk``):
equal ``exit_message``, ``it_mg`` and ``it_ssl``, fields within rel
1e-9.  The mirror of ``test_gcrotmk_device_basis``
(tests/test_solver.py:83), held against the JAX package instead of the
golden file.
"""
import pytest

pytest.importorskip('jax')

import numpy as np  # noqa: E402
import torch  # noqa: E402

import emg3d_tpu as jt  # noqa: E402

import emg3d_tpu_torch as pt  # noqa: E402
from emg3d_tpu_torch import solver  # noqa: E402

from test_torch_solver_sclr import _both, _fullspace, check  # noqa: E402

torch.set_num_threads(1)

# The VTI fullspace: point smoothing at 16³, a fixed sc/lr pair at 8³
# (its JAX compiles at 16³ would double this file's time).
CASES = {
    'point-F-16': (16, {'cycle': 'F'}),
    'sc3-lr1-8': (8, {'semicoarsening': 3, 'linerelaxation': 1}),
}


@pytest.mark.parametrize('case', list(CASES))
def test_gcrotmk_matches_jax(case):
    n, opts = CASES[case]
    (gj, mj, sj), (gp, mp, sp) = _both(*_fullspace(n))
    opts = dict(opts, sslsolver='gcrotmk', verb=1, return_info=True)
    ej, ij = jt.solve(gj, mj, sj, **opts)
    ep, ip = pt.solve(gp, mp, sp, device='cpu', **opts)
    check(ej, ij, ep, ip)
    assert ip['it_ssl'] > 0


def test_gcrotmk_recycles_and_truncates():
    """Small m and k: several outer cycles, the recycled pairs wrap around
    (oldest out), and the solve still converges to the same field as
    BiCGSTAB within the tolerance."""
    grid = pt.TensorMesh([np.full(8, 100.)] * 3, origin=(-400.,) * 3)
    model = pt.Model(grid, property_x=1.0, property_z=3.0)
    sfield = pt.get_source_field(grid, (0, 0, 0, 0, 0), 1.0)
    calls = []
    real = solver._gcrotmk

    def small(*a, **k):
        calls.append(1)
        return real(*a, m=2, k=2, **k)
    solver._gcrotmk = small
    try:
        e, info = pt.solve(grid, model, sfield, sslsolver='gcrotmk',
                           cycle='V', tol=1e-8, verb=1, return_info=True,
                           device='cpu')
    finally:
        solver._gcrotmk = real
    ref = pt.solve(grid, model, sfield, sslsolver='bicgstab', cycle='V',
                   tol=1e-10, verb=1, device='cpu')
    assert calls and info['exit_message'] == 'CONVERGED'
    assert info['it_ssl'] > 2                     # outer cycles wrapped k
    assert info['rel_error'] < 1e-8
    assert np.linalg.norm(e.field - ref.field) < 1e-6 * np.linalg.norm(
        ref.field)
