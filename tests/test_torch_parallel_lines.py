"""Port vs JAX package: line relaxation, semicoarsening and Krylov over
ranks (``emg3d_tpu_torch.parallel.lines``, the sharded ``solve``).

As tests/test_torch_parallel.py: two jobs of ranks on gloo (2 and 4
processes, configured only through ``EMG3D_TPU_*`` and ``auto_init``)
run this file as a script, rank 0 writes what the ranks gathered into a
``.npz``, and the pytest process meanwhile runs the JAX package's
single-device functions in threads; complex128, tests/test_parallel.py's
16³ problem and seeds:

- the slab line smoother (nu = 2, random e and s) along x, y and z on
  ('z',) and ('y',) with 2 and 4 ranks and on ('y', 'z') 2×2, against
  ``smoothers.line_relaxation`` at rel 1e-12: lines within a rank, and
  y- and z-lines along their own sharded axis (the Schur-complement
  smoother); on the problem's 8³ level over 4 ranks ('z',) the z-lines
  are too short per rank and the level is gathered;
- the sc+lr F-cycle solve on 4 ranks ('z',) and 2×2, BiCGSTAB with sc+lr
  (the ``Simulation`` default) on 2×2, all with ``min_local_planes=2``,
  and GCROT(m,k) with point smoothing on 2 ranks ('z',), against
  ``emg3d_tpu.solve``: equal exit, ``it_mg`` and ``it_ssl``, fields
  within rel 1e-10.  The sc+lr solves stop at ``clevel=2`` (4³-sized
  levels): the full depth adds only 2-cell levels, replicated on every
  rank, and a third of the JAX reference's compiles;
- the messages of each colour step and reduced solve, and the rules of
  the partition (the Schur smoother's node planes per rank, the nesting
  of the semicoarsening hierarchies).

Run as ``python tests/test_torch_parallel_lines.py OUT.npz`` with the
``EMG3D_TPU_*`` environment set, the file is one rank of a job.
"""
import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

if __name__ != '__main__':
    pytest.importorskip('jax')

import torch  # noqa: E402

torch.set_num_threads(1)

N = 16
# Slab smoother cases per job: (mesh axes, level of the problem).
SMOOTH_CASES = {2: [(('z',), 0), (('y',), 0)],
                4: [(('z',), 0), (('y',), 0), (('y', 'z'), 0), (('z',), 1)]}
SCLR = {'semicoarsening': True, 'linerelaxation': True, 'clevel': 2}
# Solve cases per job: (mesh axes, JAX_SOLVES name, options).
SOLVE_CASES = {2: [(('z',), 'gcrotmk', {'sslsolver': 'gcrotmk'})],
               4: [(('z',), 'sclr', SCLR), (('y', 'z'), 'sclr', SCLR),
                   (('y', 'z'), 'bicgstab', {**SCLR, 'sslsolver': True})]}
JAX_SOLVES = {'sclr': SCLR, 'bicgstab': {**SCLR, 'sslsolver': True},
              'gcrotmk': {'sslsolver': 'gcrotmk'}}
MIN_PLANES = 2
TOL_SMOOTH = 1e-12
TOL_SOLVE = 1e-10


def _problem(pkg):
    """tests/test_parallel.py's problem (seed 7, point source) in ``pkg``."""
    rng = np.random.default_rng(7)
    grid = pkg.TensorMesh([np.full(N, 100.)] * 3)
    model = pkg.Model(grid, property_x=rng.uniform(0.5, 5, grid.shape_cells))
    sfield = pkg.SourceField.zeros(grid, frequency=1.0)
    sfield.fx[N // 2, N // 2, N // 2] = 1.0
    return grid, model, sfield


def _random_es(shape):
    """tests/test_parallel.py's smoother inputs (seed 3): random complex
    s, then e, of a level of cell shape ``shape`` (numpy)."""
    nx, ny, nz = shape
    rng = np.random.default_rng(3)
    s = tuple(rng.normal(size=sh) + 1j * rng.normal(size=sh) for sh in (
        (nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1), (nx + 1, ny + 1, nz)))
    e = tuple(rng.normal(size=c.shape) + 1j * rng.normal(size=c.shape)
              for c in s)
    return e, s


def _key(axes, n, *more):
    return '_'.join(('-'.join(axes), str(n)) + tuple(map(str, more)))


# ----------------------------------------------------------------------
# One rank of a job (port only)
# ----------------------------------------------------------------------

def _worker(out):
    import torch.distributed as dist
    import emg3d_tpu_torch as pt
    from emg3d_tpu_torch import parallel, solver
    from emg3d_tpu_torch.ops import line_gs
    from emg3d_tpu_torch.parallel import distributed, halo, lines

    assert distributed.auto_init(backend='gloo')
    world, rank = distributed.process_count(), distributed.process_index()
    res = {}
    grid, model, sfield = _problem(pt)
    vm = pt.VolumeModel(grid, model, sfield)

    def gathered(d):
        got = [None] * world
        dist.all_gather_object(got, d)
        return got

    for axes, lvl in SMOOTH_CASES[world]:
        mesh = parallel.make_mesh(axes=axes)
        for ax in range(3):
            levels = solver.build_levels(grid, vm, 0, lvl, 'cpu',
                                         {'bytes': 0})[lvl:]
            lev = halo.shard_levels(levels, mesh, MIN_PLANES, 'cpu')[0]
            slab = lev.slab
            e_np, s_np = _random_es(slab.shape)
            e = slab.cut_field(tuple(torch.tensor(a) for a in e_np))
            s = slab.cut_field(tuple(torch.tensor(a) for a in s_np))
            halo.reset_sends()
            lines.reset_gathered()
            lines.relax(e, s, lev, ax, 2, local_state=lambda: (
                line_gs.line_state(lev.arrays, lev.shape, ax)))
            key = _key(axes, world, lvl, ax)
            sends = gathered(dict(halo.SENDS))
            res['sends_' + key] = np.array(
                [[d[k] for k in ('colour', 'line', 'reduced', 'halo')]
                 for d in sends])
            res['gathered_' + key] = np.array(
                [sum(d.values()) for d in gathered(dict(lines.GATHERED))])
            for c, f in enumerate(slab.gather(e)):
                res[f'lr_{key}_{c}'] = f.numpy()
            if slab.split(ax):
                res['meter_' + key] = np.array(gathered(
                    _unbudgeted(grid, vm, lvl, mesh, ax, lev, e, s)))

    for axes, name, kw in SOLVE_CASES[world]:
        mesh = parallel.make_mesh(axes=axes)
        halo.reset_sends()
        lines.reset_gathered()
        efield, info = pt.solve(
            grid, model, sfield, cycle='F', verb=1, device='cpu',
            return_info=True, sharding=parallel.shard_solve_options(
                mesh, min_local_planes=MIN_PLANES), **kw)
        key = _key(axes, world, name)
        res['solve_' + key] = efield.field
        res['info_' + key] = np.array([info['exit_message'],
                                       str(info['it_mg']),
                                       str(info['it_ssl'])])
        res['ssends_' + key] = np.array(
            [[d[k] for k in ('colour', 'line', 'reduced', 'halo')]
             for d in gathered(dict(halo.SENDS))])
        res['sgathered_' + key] = np.array(
            [sum(d.values()) for d in gathered(dict(lines.GATHERED))])
        fields = gathered(efield.field)
        res['same_' + key] = np.array([np.array_equal(f, efield.field)
                                       for f in fields])
    if rank == 0:
        np.savez(out, **res)
    distributed.shutdown()


def _unbudgeted(grid, vm, lvl, mesh, ax, lev, e, s):
    """A second call of the split-axis smoother on ``lev`` (its states
    cached, within the budget) beside two calls on a fresh level of the
    same slab under a zero factor-byte budget, from the same e and s:
    [bitwise equal, meter with the budget, meter without, stack held
    without]."""
    from emg3d_tpu_torch import solver
    from emg3d_tpu_torch.ops import line_gs
    from emg3d_tpu_torch.parallel import halo, lines
    kept = tuple(t.clone() for t in e)
    lines.relax(kept, s, lev, ax, 2)
    levels = solver.build_levels(grid, vm, 0, lvl, 'cpu', {'bytes': 0})
    bare = halo.shard_levels(levels[lvl:], mesh, MIN_PLANES, 'cpu')[0]
    e0, s0 = (bare.slab.cut_field(tuple(torch.tensor(a) for a in t))
              for t in _random_es(bare.slab.shape))
    real = line_gs.cache_budget
    line_gs.cache_budget = lambda device: 0
    try:
        for _ in range(2):
            lines.relax(e0, s0, bare, ax, 2)
    finally:
        line_gs.cache_budget = real
    held = [st.factors if hasattr(st, 'factors') else st.fac
            for st in bare.lstate.values()]
    return [all(torch.equal(a, b) for a, b in zip(kept, e0)),
            lev.meter['bytes'], bare.meter['bytes'],
            any(f is not None for f in held)]


# ----------------------------------------------------------------------
# The pytest side
# ----------------------------------------------------------------------

def _free_port():
    with socket.socket() as sk:
        sk.bind(('127.0.0.1', 0))
        return sk.getsockname()[1]


class _Job:
    """``nproc`` ranks of this file, started at once, read on demand."""

    def __init__(self, nproc, tmp):
        self.out = str(tmp / f'job{nproc}.npz')
        coord = f'127.0.0.1:{_free_port()}'
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        self.procs = []
        for pid in range(nproc):
            env = dict(os.environ, EMG3D_TPU_COORD=coord,
                       EMG3D_TPU_NPROC=str(nproc),
                       EMG3D_TPU_PROC_ID=str(pid), PYTHONPATH=root,
                       OMP_NUM_THREADS='1')
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), self.out],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        self._res = None

    def result(self):
        if self._res is None:
            logs = [p.communicate(timeout=600)[0] for p in self.procs]
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, log[-3000:]
            self._res = dict(np.load(self.out))
        return self._res


@pytest.fixture(scope='module')
def jobs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('ranks')
    started = {n: _Job(n, tmp) for n in (2, 4)}
    yield started
    for job in started.values():
        for p in job.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope='module')
def jax_problem():
    jt = pytest.importorskip('emg3d_tpu')
    return (jt,) + _problem(jt)


@pytest.fixture(scope='module')
def jax_solves(jobs, jax_problem):
    """JAX's single-device solves of JAX_SOLVES, started at once in
    threads of this process (their compiles overlap the ranks' jobs; the
    two sc+lr solves share one thread and its compiles): {name: future
    of (field, info)}."""
    from concurrent.futures import ThreadPoolExecutor
    jt, grid, model, sfield = jax_problem

    def run(kw):
        e, info = jt.solve(grid, model, sfield, cycle='F', verb=1,
                           return_info=True, **kw)
        return e.field, info

    sclr, point = ThreadPoolExecutor(1), ThreadPoolExecutor(1)
    yield {name: (sclr if 'linerelaxation' in kw else point).submit(run, kw)
           for name, kw in JAX_SOLVES.items()}
    sclr.shutdown()
    point.shutdown()


def _rel(ref, out):
    return max(np.linalg.norm(np.asarray(b) - np.asarray(a))
               / np.linalg.norm(np.asarray(a)) for a, b in zip(ref, out))


def _fake_mesh(axes, dims, coord=None):
    """A stand-in for a DeviceMesh of ``dims`` ranks over ``axes`` (the
    partition rules need only its names, shape and this rank's place)."""
    ranks = torch.arange(int(np.prod(dims))).reshape(dims)
    coord = [0] * len(dims) if coord is None else list(coord)
    return SimpleNamespace(mesh_dim_names=axes, mesh=ranks,
                           get_coordinate=lambda: coord)


def test_slab_line_smoother_matches_jax(jobs, jax_problem, jax_solves):
    """The slab line smoother, gathered, equals JAX's single-device
    ``smoothers.line_relaxation`` within 1e-12 in every case: lines
    within a rank, lines along their own sharded axis (Schur), and the
    gathered 8³ level (tests/test_parallel.py:211-239)."""
    import jax.numpy as jnp
    from emg3d_tpu import VolumeModel
    from emg3d_tpu import solver as S
    from emg3d_tpu.ops import smoothers

    jt, grid, model, sfield = jax_problem
    levels = S.build_levels(grid, VolumeModel(grid, model, sfield), 0, 1,
                            np.complex128)
    refs = {}
    for n, cases in SMOOTH_CASES.items():
        res = jobs[n].result()
        for axes, lvl in cases:
            lev = levels[lvl]
            e, s = (tuple(map(jnp.asarray, t))
                    for t in _random_es(lev.shape))
            for ax in range(3):
                if (lvl, ax) not in refs:
                    refs[lvl, ax] = smoothers.line_relaxation(
                        *e, *s, *lev.arrays, nu=2, axis=ax)
                key = _key(axes, n, lvl, ax)
                out = [res[f'lr_{key}_{c}'] for c in range(3)]
                assert _rel(refs[lvl, ax], out) < TOL_SMOOTH, key


def test_line_step_messages(jobs):
    """Messages of the nu = 2 smoother (8 colour steps) per rank: across
    a line's transverse axes one per boundary and step, sent by the side
    whose boundary nodes hold the colour's lines (4 each); along a line
    axis split over ranks one per neighbour and step each way, and one
    all_gather per step plus one for the reduced system; a gathered
    level sends none of these, and counts one gather per call."""
    for n, cases in SMOOTH_CASES.items():
        res = jobs[n].result()
        for axes, lvl in cases:
            dims = (n,) if len(axes) == 1 else (2, n // 2)
            grid_axes = [{'y': 1, 'z': 2}[a] for a in axes]
            for ax in range(3):
                key = _key(axes, n, lvl, ax)
                sends = res['sends_' + key]
                gath = res['gathered_' + key]
                short = lvl == 1 and ax in grid_axes
                for r in range(n):
                    coord = np.unravel_index(r, dims)
                    nb = {g: int(c > 0) + int(c < d - 1)
                          for g, c, d in zip(grid_axes, coord, dims)}
                    if short:
                        assert sends[r].tolist() == [0, 0, 0, 0], key
                        assert gath[r] == 1, key
                        continue
                    across = sum(v for g, v in nb.items() if g != ax)
                    along = nb.get(ax, 0)
                    assert sends[r].tolist() == [
                        4 * across, 8 * along, 9 if along else 0, 0], key
                    assert gath[r] == 0, key


def test_line_states_metered(jobs):
    """The states of lines along a split axis count against the solve's
    factor-byte meter: the Schur smoother's segment stack and reduced
    systems, a gathered level's whole stack.  Under a zero budget the
    stacks are not held (the reduced systems are, and are counted) and
    every call rebuilds them: two calls give the same numbers, bit for
    bit, as two calls on the cached states."""
    from emg3d_tpu_torch.ops import line_gs
    for n, cases in SMOOTH_CASES.items():
        res = jobs[n].result()
        for axes, lvl in cases:
            shape = (N >> lvl,) * 3
            for ax in range(3):
                key = _key(axes, n, lvl, ax)
                if 'meter_' + key not in res:
                    continue
                for same, kept, bare, held in res['meter_' + key]:
                    assert same and not held, key
                    if lvl == 1:            # gathered: the whole stack
                        assert kept == line_gs.factor_bytes(shape, ax)
                        assert bare == 0, key
                    else:                   # Schur
                        assert 0 < bare < kept, key
    assert any(k.startswith('meter_') for k in jobs[4].result())


@pytest.mark.parametrize('n,axes,name,kw', [
    (n, axes, name, kw) for n, cases in SOLVE_CASES.items()
    for axes, name, kw in cases])
def test_sharded_solve_matches_jax(jobs, jax_solves, n, axes, name, kw):
    """The sc+lr F-cycle on 4 ranks ('z',) and 2×2, BiCGSTAB with sc+lr
    on 2×2 and GCROT(m,k) on 2 ranks ('z',), min_local_planes=2: equal
    exit, it_mg and it_ssl to JAX's single-device solve
    (tests/test_parallel.py:242-262), fields within 1e-10, every rank
    the same whole field.  The sc+lr solves gather the levels whose
    lines are too short per rank, and count it."""
    field, info = jax_solves[name].result()
    res = jobs[n].result()
    key = _key(axes, n, name)
    exit_msg, it_mg, it_ssl = res['info_' + key]
    assert exit_msg == info['exit_message'] == 'CONVERGED'
    assert (int(it_mg), int(it_ssl)) == (info['it_mg'], info['it_ssl'])
    assert _rel((field,), (res['solve_' + key],)) < TOL_SOLVE
    assert res['same_' + key].all()
    sends = res['ssends_' + key]
    if 'linerelaxation' in kw:
        assert sends[:, 1].min() > 0 and sends[:, 2].min() > 0
        assert res['sgathered_' + key].min() > 0
    else:
        assert sends[:, 1].sum() == sends[:, 2].sum() == 0
    # Krylov vectors refresh their ghosts before the operator.
    assert sends[:, 3].min() > 0


@pytest.mark.parametrize('n,dims,axes,supported', [
    (16, (4,), ('z',), True), (12, (4,), ('z',), False),
    (16, (2,), ('y',), True), (6, (2,), ('z',), False),
    (8, (2,), ('z',), True), (40, (2, 2), ('y', 'z'), True)])
def test_schur_rule(n, dims, axes, supported):
    """Lines along a split axis take the Schur smoother where every rank
    of the port's partition keeps MIN_LINE_PLANES (4) node planes along
    it (the JAX package's supported_line, shmap.py:102, on this
    partition: 12 cells on 4 ranks own 3, 3, 3, 4 nodes and are
    gathered, where JAX's blocked layout gives 4 each); an axis the mesh
    does not divide is within a rank."""
    from emg3d_tpu_torch.parallel import halo
    shape = (n, n, n)
    mesh = _fake_mesh(axes, dims)
    parts = halo.partition(mesh, [shape])[0]
    for d in range(int(np.prod(dims))):
        coord = np.unravel_index(d, dims)
        slab = halo.Slab(shape, _fake_mesh(axes, dims, coord), parts)
        assert not slab.split(0)
        for name in axes:
            ax = {'y': 1, 'z': 2}[name]
            assert slab.split(ax)
            assert slab.line_supported(ax) == supported
            assert supported == (min(np.diff(parts[ax])) >= 4)


@pytest.mark.parametrize('shape,axes,dims,min_planes', [
    ((16, 16, 16), ('z',), (4,), 2), ((16, 16, 16), ('y', 'z'), (2, 2), 2),
    ((64, 64, 64), ('z',), (2,), 4), ((64, 48, 40), ('y', 'z'), (2, 2), 4),
    ((32, 48, 24), ('y', 'z'), (2, 2), 2)])
def test_semicoarsening_partitions_nest(shape, axes, dims, min_planes):
    """One finest partition for the hierarchies of every semicoarsening
    direction (solver.level_shapes; sc 0-3): each hierarchy nests into
    it (every coarse boundary a fine one, halved along the axes the
    level coarsens, kept along the others), every rank keeps two node
    planes on every sharded level, and the finest boundaries are those
    of the hierarchy that coarsens each axis most."""
    from emg3d_tpu_torch import solver
    from emg3d_tpu_torch.parallel import halo
    mesh = _fake_mesh(axes, dims)
    var = solver.MGParameters(verb=0, cycle='F', sslsolver=False,
                              semicoarsening=True, linerelaxation=False,
                              shape_cells=shape)
    hier = {}
    for sc in range(4):
        shapes = solver.level_shapes(shape, sc, int(var.clevel[sc]))
        hier[sc] = shapes[:halo.sharded_count(shapes, mesh, min_planes)]
    assert all(h for h in hier.values())
    finest = halo.joint_partition(mesh, list(hier.values()))
    for sc, shapes in hier.items():
        parts = halo.partition(mesh, shapes, finest)
        assert parts[0] == finest
        for (fine, coarse), (pf, pc) in zip(zip(shapes, shapes[1:]),
                                            zip(parts, parts[1:])):
            for ax, t in pc.items():
                k = 2 if fine[ax] == 2 * coarse[ax] else 1
                assert tuple(k * v for v in t[:-1]) == pf[ax][:-1], sc
                assert t[-1] == coarse[ax] + 1
        for part in parts:
            assert all(min(np.diff(t)) >= 2 for t in part.values())
    for name in axes:
        ax = {'y': 1, 'z': 2}[name]
        deepest = max(hier.values(), key=lambda s: sum(
            a[ax] != b[ax] for a, b in zip(s, s[1:])))
        assert finest[ax] == halo.partition(mesh, deepest)[0][ax]


if __name__ == '__main__':
    _worker(sys.argv[1])
