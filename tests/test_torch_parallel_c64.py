"""Port vs JAX package: the complex64 solve over ranks.

A job of two gloo ranks ('z',) runs this file as a script (as
tests/test_torch_parallel_lines.py does), rank 0 writes what the ranks
gathered into a ``.npz``, and the pytest process meanwhile runs the JAX
package's single-device complex64 solves in a thread.  tests/
test_parallel.py's problem (seed 7, a point source) with a complex64
source, ``min_local_planes=2``:

- K6 on slabs: each rank's ``_SolveContext.residual_ds`` on its slab of
  the 16³ finest level (random hi, lo and s, seed 5; the ghosts of hi
  and lo spoilt with NaN, which the residual refreshes first) equals
  ``dsres.residual_ds_plain`` of the whole level on every edge of the
  slab, owned and ghost (the result is refreshed: it is the next
  cycle's source), within 1e-12 relative;
- the point F-cycle at 16³ and sc+lr BiCGSTAB at 8³ with
  ``semicoarsening=3, linerelaxation=3`` (z kept fine, z-lines: every
  level is split over the ranks, 4 node planes each, and smooths by the
  Schur-complement smoother; a fixed direction keeps the JAX compiles
  few): against ``emg3d_tpu.solve``'s single-device complex64 solve in
  its accelerator configuration (``EMG3D_TPU_SPLIT=1``,
  ``EMG3D_TPU_PIPELINE=1``, as tests/test_torch_complex64.py's Krylov
  cases) and the port's unsharded one, the same
  exit message, it_mg and it_ssl within ±1 (ROADMAP §3), rel_error
  < 1e-6, complex128 returned (the lo stream is live and gathered), and
  fields within 2e-5 of both (tests/test_torch_complex64.py's bar);
- the slab line smoother in complex64 (nu = 2, random e and s, seed 3)
  on the 16³ level: along x within each rank bitwise equal to the
  unsharded complex64 smoother; along z through the Schur-complement
  smoother (its float32 spikes and dense LU of the reduced system)
  within twice the unsharded complex64 smoother's own distance from the
  float64 evaluation of the same float32 inputs (ROADMAP §3 records
  both distances);
- the storage policy with ``solver.BF16_STORAGE = True``: every level
  on a slab builds its smoother states with float32 streams and may not
  store in bfloat16, the replicated level builds them in bfloat16, and
  the solve converges within ±1 it_mg of the unsharded forced-bf16 one;
- the messages of one two-float cycle (``halo.SENDS``).

Run as ``python tests/test_torch_parallel_c64.py OUT.npz`` with the
``EMG3D_TPU_*`` environment set, the file is one rank of a job.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

if __name__ != '__main__':
    pytest.importorskip('jax')

import torch  # noqa: E402

torch.set_num_threads(1)

NPROC = 2
MIN_PLANES = 2
REL_FIELD = 2e-5        # complex64 fields (tests/test_torch_complex64.py)
TOL_DS = 1e-12
SCLR_Z = {'semicoarsening': 3, 'linerelaxation': 3}
# name: (cells per axis, options).
SOLVES = {'point-16': (16, {}),
          'bicgstab-8': (8, dict(SCLR_Z, sslsolver=True))}


def _problem(pkg, n):
    """tests/test_parallel.py's problem (seed 7, point source) at n³ in
    ``pkg``, its source in complex64."""
    rng = np.random.default_rng(7)
    grid = pkg.TensorMesh([np.full(n, 100.)] * 3)
    model = pkg.Model(grid, property_x=rng.uniform(0.5, 5, grid.shape_cells))
    sfield = pkg.SourceField.zeros(grid, frequency=1.0)
    sfield.fx[n // 2, n // 2, n // 2] = 1.0
    return grid, model, pkg.SourceField(
        *(np.asarray(f).astype(np.complex64)
          for f in (sfield.fx, sfield.fy, sfield.fz)), frequency=1.0)


def _random_hls(shape):
    """Random complex64 hi, lo (at hi's rounding level) and s of a level
    of cell shape ``shape`` (seed 5)."""
    nx, ny, nz = shape
    rng = np.random.default_rng(5)
    edges = ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1), (nx + 1, ny + 1, nz))

    def rand(scale):
        return tuple((scale * (rng.normal(size=sh) + 1j * rng.normal(
            size=sh))).astype(np.complex64) for sh in edges)
    return rand(1.0), rand(1e-7), rand(1.0)


# ----------------------------------------------------------------------
# One rank of the job (port only)
# ----------------------------------------------------------------------

def _worker(out):
    import torch.distributed as dist
    import emg3d_tpu_torch as pt
    from emg3d_tpu_torch import parallel, solver
    from emg3d_tpu_torch.parallel import distributed, halo

    assert distributed.auto_init(backend='gloo')
    rank = distributed.process_index()
    mesh = parallel.make_mesh(axes=('z',))
    opts = parallel.shard_solve_options(mesh, min_local_planes=MIN_PLANES)
    res = {}

    def gathered(obj):
        got = [None] * NPROC
        dist.all_gather_object(got, obj)
        return got

    def run(name, **kw):
        n, o = SOLVES[name]
        e, info = pt.solve(*_problem(pt, n), cycle='F', verb=1,
                           device='cpu', return_info=True, **o, **kw)
        return e.field, [info['exit_message'], info['it_mg'],
                         info['it_ssl'], info['rel_error']]

    res['k6'] = np.array(gathered(_k6_on_slab(pt, solver, opts)))
    res['schur'] = np.array(_schur_c64(pt, solver, mesh))
    res['cycle_sends'] = np.array(gathered(_two_float_cycle(pt, solver,
                                                            halo, opts)))
    for name in SOLVES:
        res['sharded_' + name], info = run(name, sharding=opts)
        res['info_' + name] = np.array(info, dtype=object)
        res['same_' + name] = np.array(gathered(
            res['sharded_' + name].tobytes()) == [
            res['sharded_' + name].tobytes()] * NPROC)
    # The unsharded solves, one on each rank.
    name = list(SOLVES)[rank]
    field, info = run(name)
    for r, (f, i) in enumerate(gathered((field, info))):
        res['single_' + list(SOLVES)[r]] = f
        res['sinfo_' + list(SOLVES)[r]] = np.array(i, dtype=object)

    # The storage policy: bfloat16 forced, the point case sharded; the
    # unsharded forced-bf16 solve on rank 1.
    seen = []

    def spy(fn):
        def wrapped(lev, *args, **kw):
            state = fn(lev, *args, **kw)
            seen.append((lev.slab is not None, lev.bf16,
                         str(getattr(state, 'storage', None))))
            return state
        return wrapped
    states = solver._level_state
    solver.BF16_STORAGE = True
    solver._level_state = spy(states)
    try:
        _, info = run('point-16', sharding=opts)
        res['info_bf16'] = np.array(info, dtype=object)
        solver._level_state = states
        _, single = run('point-16') if rank == 1 else (None, None)
    finally:
        solver.BF16_STORAGE = None
        solver._level_state = states
    res['bf16_seen'] = np.array(sorted(set(seen)), dtype=object)
    res['sinfo_bf16'] = np.array(gathered(single)[1], dtype=object)
    if rank == 0:
        np.savez(out, **res)
    distributed.shutdown()


def _k6_on_slab(pt, solver, opts):
    """This rank's K6 (``ctx.residual_ds``) on its slab of the 16³ finest
    level against the plain residual of the whole level, cut to the
    slab: [max|Δ|/max|r| over the owned edges, over every slab edge]."""
    from emg3d_tpu_torch.ops import dsres
    from emg3d_tpu_torch.parallel import halo
    grid, model, sfield = _problem(pt, 16)
    vm = pt.VolumeModel(grid, model, sfield)
    var = solver.MGParameters(verb=0, cycle='F', sslsolver=False,
                              linerelaxation=False, semicoarsening=False,
                              shape_cells=tuple(grid.shape_cells))
    ctx = solver._SolveContext(grid, vm, sfield, sfield, var, 'cpu',
                               solver._normalize_sharding(opts))
    fine = ctx.levels(0)[0]
    slab = fine.slab
    whole = solver.build_levels(grid, vm, 0, 0, 'cpu', {'bytes': 0},
                                dtype=torch.complex64)[0]
    hi, lo, s = (tuple(torch.tensor(a) for a in t)
                 for t in _random_hls(tuple(grid.shape_cells)))
    ref = slab.cut_field(dsres.residual_ds_plain(hi, lo, s, whole.arrays))
    hs, ls, ss = (slab.cut_field(t) for t in (hi, lo, s))
    lower, upper = slab.nbr[2]
    for f in (hs, ls):
        # The ghosts a refresh fills: lower node planes and shared cell,
        # upper node planes.
        if lower is not None:
            for p in halo.Slab._planes(f, 2, True, True, False):
                p.fill_(complex('nan+nanj'))
        if upper is not None:
            for p in halo.Slab._planes(f, 2, False, False, False):
                p.fill_(complex('nan+nanj'))
    r = ctx.residual_ds(hs, ls, ss)
    m = max(float(t.abs().max()) for t in ref)

    def err(view):
        return max(float((view(a, c) - view(b, c)).abs().max())
                   for c, (a, b) in enumerate(zip(r, ref))) / m
    return [err(slab.owned_view), err(lambda f, c: f)]


def _schur_c64(pt, solver, mesh):
    """The complex64 slab line smoother (nu = 2) on the 16³ level along x
    (within the ranks) and z (Schur), gathered: per axis [axis, its
    max|Δ|/max|ref| from the float64 evaluation of the same float32
    inputs, the unsharded complex64 smoother's, max|slab − unsharded|
    /max|ref|]."""
    from emg3d_tpu_torch.ops import line_gs
    from emg3d_tpu_torch.parallel import halo, lines
    c64, c128 = torch.complex64, torch.complex128
    grid, model, sfield = _problem(pt, 16)
    vm = pt.VolumeModel(grid, model, sfield)

    def level():
        return solver.build_levels(grid, vm, 0, 0, 'cpu', {'bytes': 0},
                                   dtype=c64)[:1]
    whole = level()[0]
    lev = halo.shard_levels(level(), mesh, MIN_PLANES, 'cpu')[0]
    nx, ny, nz = whole.shape
    rng = np.random.default_rng(3)
    s, e = (tuple(torch.tensor(rng.normal(size=sh) + 1j * rng.normal(
        size=sh), dtype=c64) for sh in ((nx, ny + 1, nz + 1),
                                        (nx + 1, ny, nz + 1),
                                        (nx + 1, ny + 1, nz)))
            for _ in range(2))
    up = tuple(a.to(c128 if a.is_complex() else torch.float64)
               for a in whole.arrays)
    out = []
    for ax in (0, 2):
        es, ss = lev.slab.cut_field(e), lev.slab.cut_field(s)
        lines.relax(es, ss, lev, ax, 2, local_state=lambda ax=ax: (
            line_gs.line_state(lev.arrays, lev.shape, ax)))
        got = lev.slab.gather(es)
        ew = line_gs.line_relaxation_plain(
            tuple(t.clone() for t in e), s,
            line_gs.line_state(whole.arrays, whole.shape, ax), 2)
        e64 = line_gs.line_relaxation_plain(
            tuple(t.to(c128) for t in e), tuple(t.to(c128) for t in s),
            line_gs.line_state(up, whole.shape, ax), 2)
        m = max(float(t.abs().max()) for t in e64)

        def dist(a, b):
            return max(float((x.to(c128) - y.to(c128)).abs().max())
                       for x, y in zip(a, b)) / m
        out.append([ax, dist(got, e64), dist(ew, e64), dist(got, ew)])
    return out


def _two_float_cycle(pt, solver, halo, opts):
    """The messages this rank sends in one two-float cycle of the 16³
    point F-cycle (from e = 0, the lo stream live)."""
    grid, model, sfield = _problem(pt, 16)
    var = solver.MGParameters(verb=0, cycle='F', sslsolver=False,
                              linerelaxation=False, semicoarsening=False,
                              shape_cells=tuple(grid.shape_cells))
    ctx = solver._SolveContext(grid, pt.VolumeModel(grid, model, sfield),
                               sfield, sfield, var, 'cpu',
                               solver._normalize_sharding(opts))
    levels = ctx.levels(0)
    conf = (var.nu_pre, var.nu_coarse, var.nu_post, var.cycle,
            int(var.lr_dir))
    ds = solver._TwoFloat(ctx, var, ctx.s, levels[0].slab.norm)
    ds.lo = tuple(torch.zeros_like(c) for c in ctx.e)
    ds.r = ctx.residual_ds(ctx.e, ds.lo, ctx.s)
    halo.reset_sends()
    ds.cycle(ctx.e, levels, conf)
    return [halo.SENDS[k] for k in ('colour', 'halo', 'line', 'reduced',
                                    'sums')]


# ----------------------------------------------------------------------
# The pytest side
# ----------------------------------------------------------------------

def _free_port():
    with socket.socket() as sk:
        sk.bind(('127.0.0.1', 0))
        return sk.getsockname()[1]


@pytest.fixture(scope='module')
def job(tmp_path_factory):
    """The two ranks of this file, started at once: a function that
    waits for them and returns what rank 0 wrote."""
    out = str(tmp_path_factory.mktemp('ranks') / 'job.npz')
    coord = f'127.0.0.1:{_free_port()}'
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), out],
        env=dict(os.environ, EMG3D_TPU_COORD=coord,
                 EMG3D_TPU_NPROC=str(NPROC), EMG3D_TPU_PROC_ID=str(pid),
                 PYTHONPATH=root, OMP_NUM_THREADS='1'),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(NPROC)]
    res = {}

    def result():
        if not res:
            logs = [p.communicate(timeout=600)[0] for p in procs]
            for p, log in zip(procs, logs):
                assert p.returncode == 0, log[-3000:]
            res.update(np.load(out, allow_pickle=True))
        return res
    yield result
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope='module')
def jax_solves(job):
    """The JAX package's single-device complex64 solves of SOLVES in its
    accelerator configuration, started at once in threads of this
    process: {name: future of (field, info)}."""
    from concurrent.futures import ThreadPoolExecutor
    jt = pytest.importorskip('emg3d_tpu')

    def run(n, opts):
        e, info = jt.solve(*_problem(jt, n), cycle='F', verb=1,
                           return_info=True, **opts)
        return np.asarray(e.field), info

    with pytest.MonkeyPatch.context() as m:
        m.setenv('EMG3D_TPU_SPLIT', '1')
        m.setenv('EMG3D_TPU_PIPELINE', '1')
        pool = ThreadPoolExecutor(len(SOLVES))
        yield {name: pool.submit(run, *case)
               for name, case in SOLVES.items()}
        pool.shutdown()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_residual_ds_on_slabs(job, jax_solves):
    """K6 on each rank's slab (its ds_params, hi's and lo's ghosts
    refreshed first, the result's after) equals the plain double-single
    residual of the whole level on every slab edge.  (The first test
    asks for ``jax_solves`` too, so the JAX compiles overlap the
    ranks.)"""
    for owned, every in job()['k6']:
        assert owned <= TOL_DS and every <= TOL_DS, (owned, every)


def test_schur_smoother_c64(job):
    """The complex64 slab line smoother: within the ranks bitwise the
    unsharded smoother; through the Schur complement within twice the
    unsharded complex64 smoother's distance from the float64
    evaluation (pytest -s shows both)."""
    (ax0, d0, w0, x0), (ax2, d2, w2, x2) = job()['schur']
    print(f"\nx-lines: slab {d0:.3e}, unsharded {w0:.3e}; z-lines (Schur): "
          f"slab {d2:.3e}, unsharded {w2:.3e}, slab against unsharded "
          f"{x2:.3e}")
    assert (ax0, ax2) == (0, 2)
    assert x0 == 0.0 and d0 == w0
    assert 0 < d2 <= 2 * w2


@pytest.mark.parametrize('name', list(SOLVES))
def test_sharded_c64_solve_matches_jax(job, jax_solves, name):
    """The 2-rank complex64 solve against the JAX package's single-device
    complex64 solve and the port's unsharded one."""
    res = job()
    ej, ij = jax_solves[name].result()
    es, ep = res['sharded_' + name], res['single_' + name]
    msg, it_mg, it_ssl, rel_error = res['info_' + name]
    pmsg, pit_mg, pit_ssl, _ = res['sinfo_' + name]
    print(f"\n{name}: sharded {msg} it_mg {it_mg} it_ssl {it_ssl} "
          f"rel_error {rel_error:.4e}; unsharded {pit_mg}/{pit_ssl}; JAX "
          f"{ij['it_mg']}/{ij['it_ssl']}; fields against JAX "
          f"{_rel(es, ej):.3e}, against unsharded {_rel(es, ep):.3e}")
    assert msg == pmsg == ij['exit_message'] == 'CONVERGED'
    for ref in ((pit_mg, pit_ssl), (ij['it_mg'], ij['it_ssl'])):
        assert abs(it_mg - ref[0]) <= 1 and abs(it_ssl - ref[1]) <= 1
    assert rel_error < 1e-6
    assert es.dtype == ep.dtype == ej.dtype == np.complex128
    assert _rel(es, ej) < REL_FIELD and _rel(es, ep) < REL_FIELD
    assert res['same_' + name].all()
    if SOLVES[name][1].get('sslsolver'):
        assert it_ssl >= 1


def test_slab_storage_policy(job):
    """With bfloat16 storage forced, the levels on slabs build their
    point states with float32 streams and may not store in bfloat16;
    the replicated 2³ level builds its state in bfloat16.  The sharded
    solve converges within ±1 it_mg of the unsharded forced-bf16 one."""
    res = job()
    seen = {tuple(s) for s in res['bf16_seen']}
    assert seen == {(True, False, 'None'), (False, True, 'torch.bfloat16')}
    msg, it_mg, _, rel_error = res['info_bf16']
    smsg, sit_mg, _, _ = res['sinfo_bf16']
    assert msg == smsg == 'CONVERGED' and rel_error < 1e-6
    assert abs(it_mg - sit_mg) <= 1


def test_two_float_cycle_messages(job):
    """One two-float cycle of the 16³ point F-cycle on 2 ranks: levels
    16³, 8³ and 4³ are split (16×16×8|9 ... 4×4×2|3), 2³ replicated; its
    12 smoothing calls on slabs (2, 4 and 6 per level) of nu = 3 sweeps
    send 4 colour messages per sweep on each rank (the side whose
    boundary node plane has the colour's z parity sends): 144.  'halo':
    K6 refreshes hi, lo and its result, one message each per rank (3);
    each of the 3 restrictions to a split level refreshes the fine
    residual's lower ghosts (rank 0 sends, rank 1 receives) and the
    coarse source's ghosts (one each): 9 on rank 0, 6 on rank 1.  One
    all_reduce, the residual norm; no line messages."""
    sends = res = job()['cycle_sends']
    assert res.tolist() == [[144, 9, 0, 0, 1], [144, 6, 0, 0, 1]], sends


if __name__ == '__main__':
    _worker(sys.argv[1])
