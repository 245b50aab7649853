"""Port vs JAX package with the x64 switch off.

The JAX package's x64 flag is off unless a program turns it on; the
port's switch (``emg3d_tpu_torch.dtypes.x64``) is on unless a program
turns it off.  With both off, every solve runs in complex64/float32:
the JAX package canonicalizes a complex128 source with ``jnp.asarray``,
the port's ``dtypes.precision`` does the same.

The JAX side runs once, in subprocesses of this file (x64 off,
``JAX_PLATFORMS=cpu``; tests/conftest.py turns x64 on in the pytest
process before any array exists, so it cannot be turned off there; four
parts in parallel, :data:`PARTS`, since one process traces under one
interpreter lock) that write their numbers to ``.npz`` files; they start
with the module and the port's cases run meanwhile, in-process under
``dtypes.x64(False)`` with ``device='cpu'``.  The problem is tests/test_torch_simulation.py's
``_sim_inputs`` (8³, 200 m cells, two x-dipoles, 1 and 2 Hz, point
smoother):

- (a) dtypes: ``Field.zeros`` is complex64 (float32 in the Laplace
  domain); ``get_source_field`` of a dipole, a polyline and a magnetic
  loop, and ``Simulation._get_rfield`` (on the JAX run's data), equal
  the JAX package's bitwise, dtypes included (complex128: numpy
  promotes the complex64 start);
- (b) ``solve`` of a complex128 source, standalone and under BiCGSTAB
  (the JAX package's accelerator configuration, ``EMG3D_TPU_SPLIT=1``
  and ``EMG3D_TPU_PIPELINE=1``: its refined Krylov solve, which the port
  mirrors), and a Laplace-domain source, at tol 1e-6 (two-float) and
  1e-4 (no switch): the same exit message and returned dtype, it_mg and
  it_ssl within ±1 (ROADMAP §3), fields within ``REL_FIELD``; an
  ``efield`` updated in place keeps its complex128;
- (c) ``Simulation`` with ``sslsolver=False`` and with BiCGSTAB (one
  batched solve of the four pairs each way): ``compute(observed=True)``
  with noise seed 3, the misfit and gradient of a homogeneous start
  model within ``REL_DATA``, ``REL_MISFIT`` and ``REL_GRAD``, every
  forward and adjoint pair's exit, counts (±1) and dtype equal;
- (d) the switch: on by default, restored by the context manager, also
  after an exception; ``solve(..., sharding=)`` (one gloo rank) with it
  off runs the complex64 path;
- ``diff`` with a complex64 source: the field and λ come back complex64
  (with the switch on too), and with the switch off the η, ζ and source
  gradients are within ``REL_DIFF`` of ``jax.grad``'s with x64 off.

Run as ``python tests/test_torch_x64_off.py OUT.npz`` the file is the
JAX side.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

if __name__ != '__main__':
    pytest.importorskip('jax')

import torch  # noqa: E402

import emg3d_tpu_torch as pt  # noqa: E402
from emg3d_tpu_torch import dtypes  # noqa: E402

from test_torch_diff import FREQ as DFREQ, N as DN  # noqa: E402
from test_torch_diff import _sigma_true, _weights  # noqa: E402
from test_torch_simulation import _sim_inputs  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
REL_FIELD = 2e-5        # complex64 fields (tests/test_torch_complex64.py)
REL_DATA = 2e-5         # responses: samples of those fields
REL_MISFIT = 1e-5
REL_GRAD = 1e-4
REL_DIFF = 1e-4         # diff's gradients, complex64 solves at tol 1e-6
DTOL = 1e-6             # diff's solve tolerance (two-float)
SRC = (500., 800., 800., 0., 0.)
SOURCES = {
    'dipole': ((500., 800., 800., 20., 10.), True),
    'polyline': (([300., 900., 900.], [500., 500., 1100.],
                  [800., 800., 900.]), True),
    'magnetic': ((800., 800., 800., 30., 20.), False),
}
SOLVES = {
    'point': {'sslsolver': False},
    'bicgstab': {'sslsolver': 'bicgstab'},
    'laplace': {'sslsolver': False, 'frequency': -1.0},
}
SIMS = {'point': {}, 'bicgstab': {'sslsolver': 'bicgstab'}}
TOLS = (1e-6, 1e-4)
INFO = ('exit_message', 'it_mg', 'it_ssl')


def _solve_args(pkg, case):
    mesh, model, _, _ = _sim_inputs(pkg)
    opts = dict(SOLVES[case])
    freq = opts.pop('frequency', 1.0)
    return mesh, model, pkg.get_source_field(mesh, SRC, freq), opts


def _simulations(pkg, case, opts=None):
    """tests/test_torch_simulation.py's ``_run`` at tol 1e-6: observed
    data (noise seed 3) on the true model, then a homogeneous start
    model's misfit and gradient.  Returns both Simulations."""
    mesh, model, survey, base = _sim_inputs(pkg, tol=1e-6)
    base.update(SIMS[case], **(opts or {}))
    sim = pkg.Simulation('t', survey, mesh, model, gridding='same',
                         solver_opts=base, verb=-1, max_workers=1)
    np.random.seed(3)
    sim.compute(observed=True)
    start = pkg.Model(mesh, np.ones(mesh.shape_cells),
                      mapping='Conductivity')
    sim2 = pkg.Simulation('t', sim.survey, mesh, start, gridding='same',
                          solver_opts=base, verb=-1)
    sim2.misfit, sim2.gradient
    return sim, sim2


def _sim_record(sim, sim2):
    """The numbers (c) compares, as a flat dict."""
    out = {'obs': np.array(sim.data.observed),
           'synthetic': np.array(sim2.data.synthetic),
           'misfit': np.float64(sim2.misfit),
           'gradient': np.asarray(sim2.gradient)}
    for which, src, infos in (
            ('e', sim2._dict_efield, sim2._dict_efield_info),
            ('b', sim2._dict_bfield, sim2._dict_bfield_info)):
        for s in sim2.survey.sources:
            for f in sim2.survey.frequencies:
                key = f'{which}_{s}_{f}'
                out[key + '_dtype'] = np.array(str(src[s][f].fx.dtype))
                for k in INFO:
                    out[f'{key}_{k}'] = np.array(infos[s][f][k])
    return out


def _diff_run(pkg):
    """diff's grid and complex64 source: tests/test_torch_diff.py's
    setup (8³, σ = 1 against a contrast block, unit edge samplers), whose
    gradient of ½‖d − d_obs‖² in (η_x, η_y, η_z, ζ, s) the cases take
    at tol 1e-6."""
    grid = pkg.TensorMesh([np.full(DN, 100.)] * 3, origin=(-400.,) * 3)
    sf = pkg.get_source_field(grid, (0, 0, 0, 0, 0), DFREQ, strength=0)
    src = [np.asarray(f).astype(np.complex64) for f in (sf.fx, sf.fy, sf.fz)]
    return grid, src


# ----------------------------------------------------------------------
# The JAX side (subprocesses, x64 off)
# ----------------------------------------------------------------------

def _jax_sources(res):
    """(a): default fields and sources."""
    import emg3d_tpu as jt
    mesh, _, _, _ = _sim_inputs(jt)
    res['zeros'] = np.array(str(jt.Field.zeros(mesh).fx.dtype))
    res['zeros_laplace'] = np.array(str(jt.Field.zeros(
        mesh, frequency=-1.0).fx.dtype))
    for name, (src, electric) in SOURCES.items():
        sf = jt.get_source_field(mesh, src, 1.0, electric=electric)
        for c in ('fx', 'fy', 'fz'):
            res[f'src_{name}_{c}'] = np.asarray(getattr(sf, c))


def _jax_solve(res, case):
    """(b) for one case."""
    import emg3d_tpu as jt
    mesh, model, sf, opts = _solve_args(jt, case)
    for tol in TOLS:
        e, info = jt.solve(mesh, model, sf, tol=tol, verb=0,
                           return_info=True, **opts)
        key = f'solve_{case}_{tol}'
        for c in ('fx', 'fy', 'fz'):
            res[f'{key}_{c}'] = np.asarray(getattr(e, c))
        for k in INFO:
            res[f'{key}_{k}'] = np.array(info[k])


def _jax_diff(res):
    """(b)'s point case, then diff's gradients."""
    import jax
    import jax.numpy as jnp
    import emg3d_tpu as jt
    from emg3d_tpu import cx
    _jax_solve(res, 'point')
    grid, src = _diff_run(jt)
    s = tuple(cx.aspair(c) for c in src)
    w = [(c, jnp.asarray(a, dtype=jnp.float32)) for c, a in _weights()]
    fsolve = jt.diff.make_differentiable_solve(grid, DFREQ, tol=DTOL,
                                               verb=0)

    def data(arrays4, src_):
        return jt.diff.sample_edges(fsolve(arrays4, src_), w)

    eta_t, zeta_t = jt.diff.eta_zeta_from_sigma(
        grid, jnp.asarray(_sigma_true(), dtype=jnp.float32), DFREQ)
    d_obs = data((eta_t, eta_t, eta_t, zeta_t), s)

    def parts(ex, ey, ez, zeta, src_):
        return 0.5 * jnp.sum((data((ex, ey, ez, zeta), src_) - d_obs) ** 2)

    eta0, zeta0 = jt.diff.eta_zeta_from_sigma(
        grid, jnp.ones((DN,) * 3, dtype=jnp.float32), DFREQ)
    g = jax.grad(parts, argnums=(0, 1, 2, 3, 4))(eta0, eta0, eta0, zeta0, s)
    for i in range(3):
        res[f'diff_eta{i}'] = np.asarray(g[i].re) + 1j * np.asarray(g[i].im)
        res[f'diff_src{i}'] = (np.asarray(g[4][i].re)
                               + 1j * np.asarray(g[4][i].im))
    res['diff_zeta'] = np.asarray(g[3])
    res['diff_dtype'] = np.array(str(g[0].re.dtype))


def _jax_sims(res, case):
    """(c) for one case, and the adjoint sources of the point case."""
    import emg3d_tpu as jt
    sim, sim2 = _simulations(jt, case)
    for k, v in _sim_record(sim, sim2).items():
        res[f'sim_{case}_{k}'] = v
    if case == 'point':
        for s in sim2.survey.sources:
            for f in sim2.survey.frequencies:
                rf = sim2._get_rfield(s, f)
                for c in ('fx', 'fy', 'fz'):
                    res[f'rfield_{s}_{f}_{c}'] = np.asarray(getattr(rf, c))


# The JAX side's processes, run in parallel (their traces take the GIL of
# one process): each part and its extra environment.  The single
# BiCGSTAB solve runs in the JAX package's accelerator configuration
# (split pairs, pipelined checks: its refined Krylov solve, which the
# port mirrors); the rest in its CPU configuration (the batched Krylov
# solves are refined in both).
PARTS = {
    'solves': ({}, lambda res: (_jax_sources(res), _jax_diff(res))),
    'accelerator': ({'EMG3D_TPU_SPLIT': '1', 'EMG3D_TPU_PIPELINE': '1'},
                    lambda res: _jax_solve(res, 'bicgstab')),
    'sim_point': ({}, lambda res: (_jax_sims(res, 'point'),
                                   _jax_solve(res, 'laplace'))),
    'sim_bicgstab': ({}, lambda res: _jax_sims(res, 'bicgstab')),
}


def _jax_main(out, part):
    import jax
    assert not jax.config.jax_enable_x64
    res = {}
    PARTS[part][1](res)
    np.savez(out, **res)


class _JaxSide:
    """The JAX side's processes, one per part of :data:`PARTS`, started
    at once (their output into a log file each); :meth:`get` waits for
    their ``.npz`` files."""

    def __init__(self, tmp):
        self.procs = {}
        for part, (extra, _) in PARTS.items():
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith('EMG3D_TPU_')}
            env.update(JAX_PLATFORMS='cpu', JAX_ENABLE_X64='0',
                       PYTHONPATH=str(REPO), **extra)
            path = tmp / f'{part}.npz'
            with open(tmp / f'{part}.log', 'w') as log:
                self.procs[path] = subprocess.Popen(
                    [sys.executable, __file__, str(path), part], cwd=REPO,
                    env=env, stdout=log, stderr=subprocess.STDOUT)
        self.res = None

    def get(self):
        if self.res is None:
            res = {}
            for path, proc in self.procs.items():
                proc.wait(timeout=600)
                assert proc.returncode == 0, \
                    path.with_suffix('.log').read_text()[-4000:]
                with np.load(path) as f:
                    res.update({k: f[k] for k in f.files})
            self.res = res
        return self.res

    def close(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()


@pytest.fixture(scope='module', autouse=True)
def jax_side(tmp_path_factory):
    job = _JaxSide(tmp_path_factory.mktemp('x64_off'))
    yield job
    job.close()


# ----------------------------------------------------------------------
# The port's side
# ----------------------------------------------------------------------

CPU = {'device': 'cpu'}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)
    return float(np.max(np.abs(a[fin] - b[fin])) / np.max(np.abs(b[fin])))


def _near(a, b):
    """Counts within ±1 (ROADMAP §3), exit messages equal."""
    if isinstance(b, str):
        return a == b
    return abs(int(a) - int(b)) <= 1


def test_switch_default_and_restore():
    assert dtypes.x64_enabled()
    assert dtypes.precision(np.complex128) == (torch.float64,
                                               torch.complex128)
    with dtypes.x64(False):
        assert not dtypes.x64_enabled()
        assert dtypes.real_dtype() == np.float32
        assert dtypes.complex_dtype() == np.complex64
        assert dtypes.complex_dtype(np.float64) == np.complex128
        for dt in (np.complex128, np.float64, np.complex64, np.float32):
            assert dtypes.precision(dt) == (torch.float32, torch.complex64)
        with dtypes.x64(True):
            assert dtypes.precision(np.complex128)[1] == torch.complex128
        assert not dtypes.x64_enabled()
    assert dtypes.x64_enabled()
    with pytest.raises(KeyError):
        with dtypes.x64(False):
            raise KeyError('restored all the same')
    assert dtypes.x64_enabled() and dtypes.real_dtype() == np.float64
    dtypes.set_x64(False)
    try:
        assert not dtypes.x64_enabled()
    finally:
        dtypes.set_x64(True)


def test_sharded_solve_x64_off(tmp_path):
    """``solve(..., sharding=)`` on a one-rank gloo group with the switch
    off: the complex64 path, as a hand-cast complex64 source takes it
    with the switch on (the same cast; only the norm that judges
    convergence is the complex128 source's)."""
    import torch.distributed as dist
    from emg3d_tpu_torch import parallel
    mesh, model, sf, _ = _solve_args(pt, 'point')
    s64 = pt.SourceField(*(f.astype(np.complex64) for f in
                           (sf.fx, sf.fy, sf.fz)), frequency=1.0)
    dist.init_process_group('gloo', init_method=f'file://{tmp_path}/pg',
                            world_size=1, rank=0)
    try:
        opts = parallel.shard_solve_options(parallel.make_mesh(1),
                                            min_local_planes=2)
        for kw in ({}, {'sslsolver': True}):
            out = []
            for src, x64 in ((s64, True), (sf, False)):
                with dtypes.x64(x64):
                    out.append(pt.solve(mesh, model, src, verb=0,
                                        return_info=True, sharding=opts,
                                        **kw, **CPU))
            (e0, i0), (e1, i1) = out
            assert i1['exit_message'] == i0['exit_message'] == 'CONVERGED'
            assert (i1['it_mg'], i1['it_ssl']) == (i0['it_mg'], i0['it_ssl'])
            assert e1.field.dtype == e0.field.dtype == np.complex128
            assert np.linalg.norm(e1.field - e0.field) <= \
                1e-12 * np.linalg.norm(e0.field), kw
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope='module')
def port_sims():
    """(c)'s port side, both cases (they run while the JAX side does)."""
    with dtypes.x64(False):
        return {case: _sim_record(*_simulations(pt, case, CPU))
                for case in SIMS}


@pytest.mark.parametrize('case', list(SIMS))
def test_simulation_matches_jax(jax_side, port_sims, case):
    got = port_sims[case]
    ref = {k[len(f'sim_{case}_'):]: v for k, v in jax_side.get().items()
           if k.startswith(f'sim_{case}_')}
    assert got.keys() == ref.keys()
    rel = {k: _rel(got[k], ref[k])
           for k in ('obs', 'synthetic', 'misfit', 'gradient')}
    print(f"\n{case}: misfit {float(got['misfit']):.10g} (JAX "
          f"{float(ref['misfit']):.10g}), rel {rel}")
    assert rel['obs'] < REL_DATA and rel['synthetic'] < REL_DATA
    assert rel['misfit'] < REL_MISFIT and rel['gradient'] < REL_GRAD
    assert got['synthetic'].dtype == np.complex128
    assert got['gradient'].dtype == ref['gradient'].dtype == np.float64
    for k, v in ref.items():
        if k.endswith('_dtype'):
            assert str(got[k]) == str(v) == 'complex128', k
        elif k.endswith(INFO):
            assert _near(got[k].item(), v.item()), (k, got[k], v)
            if k.endswith('exit_message'):
                assert str(v) == 'CONVERGED'


@pytest.mark.parametrize('tol', TOLS)
@pytest.mark.parametrize('case', list(SOLVES))
def test_solve_matches_jax(jax_side, case, tol):
    mesh, model, sf, opts = _solve_args(pt, case)
    assert sf.fx.dtype == (np.complex128 if case != 'laplace'
                           else np.float64)
    with dtypes.x64(False):
        e, info = pt.solve(mesh, model, sf, tol=tol, verb=0,
                           return_info=True, **opts, **CPU)
        if case == 'point':
            # An efield updated in place keeps its dtype (numpy's
            # assignment, as in the JAX package).
            ef = pt.Field.zeros(mesh, frequency=1.0, dtype=np.complex128)
            pt.solve(mesh, model, sf, efield=ef, tol=tol, verb=0, **CPU)
            assert ef.fx.dtype == np.complex128
            assert _rel(ef.fx, e.fx) < REL_FIELD
    ref = jax_side.get()
    key = f'solve_{case}_{tol}'
    for c in ('fx', 'fy', 'fz'):
        r = ref[f'{key}_{c}']
        assert getattr(e, c).dtype == r.dtype, (c, r.dtype)
        assert _rel(getattr(e, c), r) < REL_FIELD
    # tol 1e-6 switches to two-float (complex128 hi + lo); the Krylov
    # solves are always refined.
    two_float = tol < 2e-5 or case == 'bicgstab'
    assert e.fx.dtype == (np.complex128 if two_float else
                          np.float32 if case == 'laplace' else np.complex64)
    for k in INFO:
        assert _near(info[k], ref[f'{key}_{k}'].item()), (k, info[k])
    assert info['exit_message'] == 'CONVERGED'


def test_sources_and_rfield_match_jax(jax_side):
    mesh, model, survey, opts = _sim_inputs(pt, tol=1e-6)
    with dtypes.x64(False):
        assert pt.Field.zeros(mesh).fx.dtype == np.complex64
        assert pt.Field.zeros(mesh, frequency=-1.).fx.dtype == np.float32
        srcs = {name: pt.get_source_field(mesh, src, 1.0, electric=el)
                for name, (src, el) in SOURCES.items()}
    ref = jax_side.get()
    assert str(ref['zeros']) == 'complex64'
    assert str(ref['zeros_laplace']) == 'float32'
    for name, sf in srcs.items():
        for c in ('fx', 'fy', 'fz'):
            r = ref[f'src_{name}_{c}']
            assert getattr(sf, c).dtype == r.dtype == np.complex128
            assert np.array_equal(getattr(sf, c), r), (name, c)
    # The adjoint sources, on the JAX run's data: bitwise too.
    with dtypes.x64(False):
        sim = pt.Simulation('t', survey, mesh, pt.Model(
            mesh, np.ones(mesh.shape_cells), mapping='Conductivity'),
            gridding='same', solver_opts={**opts, **CPU}, verb=-1)
        # What misfit stores: the residual and its weights.
        sim.data['observed'] = ref['sim_point_obs'].copy()
        sim.data['residual'] = ref['sim_point_synthetic'] - ref[
            'sim_point_obs']
        sim.data['weights'] = np.asarray(
            sim.survey.standard_deviation) ** -2.0
        n = 0
        for s in survey.sources:
            for f in survey.frequencies:
                rf = sim._get_rfield(s, f)
                for c in ('fx', 'fy', 'fz'):
                    r = ref[f'rfield_{s}_{f}_{c}']
                    assert getattr(rf, c).dtype == r.dtype == np.complex128
                    assert np.array_equal(getattr(rf, c), r)
                n += 1
    assert n == 4


@pytest.mark.parametrize('x64', [False, True])
def test_diff_complex64_source(jax_side, x64):
    """A complex64 source gives a complex64 field and λ (the adjoint
    solve then runs in complex64, as the JAX package's); with x64 off
    the gradients match ``jax.grad``'s."""
    grid, src = _diff_run(pt)
    with dtypes.x64(x64):
        rdt = torch.float64 if x64 else torch.float32
        fsolve = pt.diff.make_differentiable_solve(grid, DFREQ, tol=DTOL,
                                                   device='cpu')
        w = [(c, torch.tensor(a, dtype=rdt)) for c, a in _weights()]
        s = tuple(torch.tensor(c) for c in src)
        eta_t, zeta_t = pt.diff.eta_zeta_from_sigma(
            grid, torch.tensor(_sigma_true(), dtype=rdt), DFREQ)
        d_obs = pt.diff.sample_edges(
            fsolve((eta_t, eta_t, eta_t, zeta_t), s), w).detach()
        eta0, zeta0 = pt.diff.eta_zeta_from_sigma(
            grid, torch.ones((DN,) * 3, dtype=rdt), DFREQ)
        assert eta0.dtype == (torch.complex128 if x64 else torch.complex64)
        leaves = [t.clone().requires_grad_(True)
                  for t in (eta0, eta0, eta0, zeta0, *s)]
        e = fsolve(leaves[:4], leaves[4:])
        assert all(c.dtype == torch.complex64 for c in e)
        loss = 0.5 * torch.sum((pt.diff.sample_edges(e, w) - d_obs).abs()
                               ** 2)
        grads = torch.autograd.grad(loss, leaves)
    lam = grads[4:]
    assert all(g.dtype == torch.complex64 for g in lam)
    assert all(torch.isfinite(g).all() for g in grads)
    if x64:
        return
    ref = jax_side.get()
    assert str(ref['diff_dtype']) == 'float32'
    rel = [_rel(grads[i].numpy(), ref[f'diff_eta{i}']) for i in range(3)]
    rel += [_rel(grads[3].numpy(), ref['diff_zeta'])]
    rel += [_rel(lam[i].numpy(), ref[f'diff_src{i}']) for i in range(3)]
    print(f"\ndiff gradients (η_x, η_y, η_z, ζ, s_x, s_y, s_z) rel {rel}")
    assert max(rel) < REL_DIFF
    assert grads[3].dtype == torch.float32


if __name__ == '__main__':
    _jax_main(*sys.argv[1:])
