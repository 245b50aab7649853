"""Port vs JAX package: MG-preconditioned BiCGSTAB and CGS, end to end.

Both packages solve the same problem on the CPU in complex128 (the JAX
package's host-scalar Krylov route): equal ``exit_message``, ``it_mg``
and ``it_ssl``, fields within rel 1e-9.  Also the three places where
the Krylov path differs from the standalone one: the warm start runs
Krylov even on a converged field, the preconditioner judges itself
against its own rhs, and a stagnating preconditioner aborts with a zero
field.
"""
import pytest

pytest.importorskip('jax')

import numpy as np  # noqa: E402
import torch  # noqa: E402

import emg3d_tpu as jt  # noqa: E402

import emg3d_tpu_torch as pt  # noqa: E402

from test_torch_solver_sclr import _both, _fullspace, check  # noqa: E402

torch.set_num_threads(1)

# Solve options at 8³: V-cycle BiCGSTAB and CGS, a fixed sc/lr
# preconditioner, and Simulation's default (sslsolver + rotating sc/lr).
CASES = {
    'bicgstab-V': {'sslsolver': 'bicgstab', 'cycle': 'V'},
    'cgs-V': {'sslsolver': 'cgs', 'cycle': 'V'},
    'bicgstab-sc3-lr1': {'sslsolver': True, 'semicoarsening': 3,
                         'linerelaxation': 1},
    'simulation-default': {'sslsolver': True, 'semicoarsening': True,
                           'linerelaxation': True},
}


@pytest.mark.parametrize('case', list(CASES))
def test_krylov_matches_jax(case):
    (gj, mj, sj), (gp, mp, sp) = _both(*_fullspace())
    opts = CASES[case]
    ej, ij = jt.solve(gj, mj, sj, verb=1, return_info=True, **opts)
    ep, ip = pt.solve(gp, mp, sp, verb=1, return_info=True, device='cpu',
                      **opts)
    check(ej, ij, ep, ip)
    assert ip['it_ssl'] > 0


def test_warm_start_runs_krylov():
    """A converged efield under sslsolver still runs Krylov (no
    'NOTHING DONE' shortcut): it returns at once with its residual."""
    (gj, mj, sj), (gp, mp, sp) = _both(*_fullspace())
    fj = jt.solve(gj, mj, sj, cycle='V', verb=0)
    fp = pt.solve(gp, mp, sp, cycle='V', verb=0, device='cpu')
    opts = dict(sslsolver='cgs', cycle='V', verb=1, return_info=True)
    ij = jt.solve(gj, mj, sj, efield=fj, **opts)
    ip = pt.solve(gp, mp, sp, efield=fp, device='cpu', **opts)
    check(fj, ij, fp, ip)
    assert ip['it_ssl'] == ip['it_mg'] == 0
    assert len(ip['error_at_cycle']) == len(ij['error_at_cycle'])


def test_preconditioner_judges_its_own_rhs():
    """Started two sc+lr cycles from the solution, the preconditioner's
    rhs is small against the source: each call still runs its 3-cycle
    schedule until its OWN rhs has dropped by tol (judged against the
    source's norm, it would stop after fewer cycles)."""
    (gj, mj, sj), (gp, mp, sp) = _both(*_fullspace())
    opts = dict(semicoarsening=True, linerelaxation=True)
    fj = jt.solve(gj, mj, sj, maxit=2, verb=0, **opts)
    fp = pt.solve(gp, mp, sp, maxit=2, verb=0, device='cpu', **opts)
    kw = dict(sslsolver=True, verb=1, return_info=True, **opts)
    ij = jt.solve(gj, mj, sj, efield=fj, **kw)
    ip = pt.solve(gp, mp, sp, efield=fp, device='cpu', **kw)
    check(fj, ij, fp, ip)
    assert ip['it_mg'] % 3 == 0 and ip['it_mg'] > 0


@pytest.mark.parametrize('opts,message', [
    # No smoothing anywhere: every preconditioner cycle leaves the
    # residual as it was; the 4-cycle sc schedule lets the preconditioner
    # reach its stagnation check, which aborts the Krylov solve.
    ({'semicoarsening': 1111, 'nu_pre': 0, 'nu_coarse': 0, 'nu_post': 0},
     'STAGNATED (returned field is zero)'),
    ({'cycle': 'V', 'maxit': 1}, 'MAX. ITERATION REACHED, NOT CONVERGED'),
])
def test_krylov_exits_match_jax(opts, message):
    (gj, mj, sj), (gp, mp, sp) = _both(*_fullspace())
    opts = dict(opts, sslsolver='bicgstab', verb=1, return_info=True)
    ej, ij = jt.solve(gj, mj, sj, **opts)
    ep, ip = pt.solve(gp, mp, sp, device='cpu', **opts)
    check(ej, ij, ep, ip, exit_message=message)
    if message.startswith('STAGNATED'):
        assert ip['it_mg'] == 3 and ip['it_ssl'] == 0
        assert not np.any(ep.field)
