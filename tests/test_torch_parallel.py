"""Port vs JAX package: multi-process solves (``emg3d_tpu_torch.parallel``).

The port runs SPMD over processes.  Two jobs of ranks on gloo (2 and 4
processes, configured only through ``EMG3D_TPU_*`` and ``auto_init``)
run this file as a script; rank 0 writes what the ranks gathered into a
``.npz``.  The pytest process meanwhile runs the JAX package on its 8
virtual CPU devices (tests/conftest.py), and the tests hold the two
against each other on tests/test_parallel.py's 16³ problem in
complex128:

- the mesh and field layout (``make_mesh``, ``distribute_field``) and
  the scaffold (``process_count``/``process_index``, an ``all_reduce``
  over ``global_mesh``);
- the sharded point smoother (nu = 2, random e and s) against JAX's
  single-device ``smoothers.gauss_seidel_point`` and its
  ``gauss_seidel_point_shmap``, rel 1e-12, on ('z',) with 2 and 4 ranks,
  ('y',) with 2 and ('y', 'z') 2×2;
- the sharded solve (F-cycle on 4 ranks ('z',), V-cycle on 2×2, both
  with ``min_local_planes=2``: sharded levels, then a replicated tail)
  against JAX's sharded and single solves: equal ``exit_message`` and
  ``it_mg``, fields within rel 1e-10;
- the messages per colour step of the sharded smoother.

Run as ``python tests/test_torch_parallel.py OUT.npz`` with the
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

N = 16
SMOOTH_CASES = {2: [('z',), ('y',)], 4: [('z',), ('y', 'z')]}
SOLVE_CASES = {4: [(('z',), 'F'), (('y', 'z'), 'V')]}
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


def _random_es(sfield):
    """tests/test_parallel.py's smoother inputs (seed 3): random complex
    s, then e, of the source field's shapes (numpy)."""
    rng = np.random.default_rng(3)
    s = tuple(rng.normal(size=np.shape(f)) + 1j * rng.normal(size=np.shape(f))
              for f in (sfield.fx, sfield.fy, sfield.fz))
    e = tuple(rng.normal(size=c.shape) + 1j * rng.normal(size=c.shape)
              for c in s)
    return e, s


def _key(axes, n):
    return f"{'_'.join(axes)}{n}"


# ----------------------------------------------------------------------
# One rank of a job (port only)
# ----------------------------------------------------------------------

def _worker(out):
    import torch.distributed as dist
    import emg3d_tpu_torch as pt
    from emg3d_tpu_torch import parallel, solver
    from emg3d_tpu_torch.ops import point_gs
    from emg3d_tpu_torch.parallel import distributed, halo

    assert distributed.auto_init(backend='gloo')
    world, rank = distributed.process_count(), distributed.process_index()
    res = {}
    # Scaffold: every rank is seen by a reduction over the global mesh.
    gm = distributed.global_mesh()
    t = torch.tensor([rank + 1.0])
    dist.all_reduce(t, group=gm.get_group())
    ranks = [None] * world
    dist.all_gather_object(ranks, (rank, world, float(t[0])))
    res['scaffold'] = np.array(ranks)

    for axes in (('z',), ('y', 'z')):
        res['mesh_' + '_'.join(axes)] = np.array(
            parallel.make_mesh(axes=axes).mesh.shape)

    grid, model, sfield = _problem(pt)
    if world == 4:
        fz = parallel.distribute_field(sfield, parallel.make_mesh(4))[2]
        res['dist_fz'] = fz.full_tensor().numpy()
        res['dist_fz_local'] = np.array(fz.to_local().shape)
    for axes in (('z',), ('y', 'z')):
        lay = parallel.field_sharding(parallel.make_mesh(axes=axes),
                                      (N, N, N))
        lays = [None] * world
        dist.all_gather_object(lays, [(ax, *lay['nodes'][ax],
                                       *lay['cells'][ax])
                                      for ax in lay['axes']])
        res['layout_' + '_'.join(axes)] = np.array(lays)

    vm = pt.VolumeModel(grid, model, sfield)
    lev = solver.build_levels(grid, vm, 0, 0, 'cpu', {'bytes': 0})[0]
    e_np, s_np = _random_es(sfield)
    for axes in SMOOTH_CASES[world]:
        mesh = parallel.make_mesh(axes=axes)
        slab = halo.Slab(lev.shape, mesh,
                         halo.partition(mesh, [lev.shape])[0])
        e = slab.cut_field(tuple(torch.tensor(a) for a in e_np))
        s = slab.cut_field(tuple(torch.tensor(a) for a in s_np))
        state = point_gs.point_state(slab.cut_arrays(lev.arrays),
                                     slab.local_shape)
        halo.reset_sends()
        halo.gauss_seidel_point_sharded(e, s, state, 2, slab)
        sends = [None] * world
        dist.all_gather_object(sends, dict(halo.SENDS))
        key = _key(axes, world)
        res['sends_' + key] = np.array([[d['colour'], d['halo']]
                                        for d in sends])
        for c, f in enumerate(slab.gather(e)):
            res[f'gs_{key}_{c}'] = f.numpy()

    for axes, cycle in SOLVE_CASES.get(world, []):
        mesh = parallel.make_mesh(axes=axes)
        efield, info = pt.solve(
            grid, model, sfield, cycle=cycle, verb=1, device='cpu',
            return_info=True, sharding=parallel.shard_solve_options(
                mesh, min_local_planes=MIN_PLANES))
        key = _key(axes, world)
        res['solve_' + key] = efield.field
        res['info_' + key] = np.array([info['exit_message'],
                                       str(info['it_mg'])])
        # Every rank returns the whole field, the same one.
        fields = [None] * world
        dist.all_gather_object(fields, efield.field)
        res['same_' + key] = np.array([np.array_equal(f, efield.field)
                                       for f in fields])
    if rank == 0:
        np.savez(out, **res)
    distributed.shutdown()


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
            logs = [p.communicate(timeout=300)[0] for p in self.procs]
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
    """JAX's single and sharded solves of SOLVE_CASES, started at once in
    threads of this process (their compiles overlap each other and the
    ranks' jobs): {(axes, cycle): (single, sharded)} of futures giving
    (field, info)."""
    from concurrent.futures import ThreadPoolExecutor
    from emg3d_tpu import parallel
    jt, grid, model, sfield = jax_problem

    def run(cycle, axes=None):
        kw = {} if axes is None else {
            'sharding': parallel.shard_solve_options(
                parallel.make_mesh(4, axes=axes),
                min_local_planes=MIN_PLANES)}
        e, info = jt.solve(grid, model, sfield, cycle=cycle, verb=1,
                           return_info=True, **kw)
        return e.field, info

    pool = ThreadPoolExecutor(4)
    futs = {(axes, cycle): (pool.submit(run, cycle),
                            pool.submit(run, cycle, axes))
            for axes, cycle in SOLVE_CASES[4]}
    yield futs
    pool.shutdown()


def _rel(ref, out):
    return max(np.linalg.norm(np.asarray(b) - np.asarray(a))
               / np.linalg.norm(np.asarray(a)) for a, b in zip(ref, out))


def test_scaffold_and_meshes(jobs, jax_solves):
    """auto_init from EMG3D_TPU_* alone: count and index right, and an
    all_reduce over global_mesh sees every rank (test_parallel.py:265);
    make_mesh shapes (:28)."""
    for n, job in jobs.items():
        res = job.result()
        assert res['scaffold'].tolist() == [
            [r, n, n * (n + 1) / 2] for r in range(n)]
        assert res['mesh_z'].tolist() == [n]
        assert int(np.prod(res['mesh_y_z'])) == n
    assert jobs[4].result()['mesh_y_z'].tolist() == [2, 2]


def test_field_sharding(jobs):
    """Each rank's owned node and cell planes: along every sharded axis
    the ranks' ranges tile the level's nodes and cells, two nodes or
    more each."""
    for n, job in jobs.items():
        for axes in (('z',), ('y', 'z')):
            lay = job.result()['layout_' + '_'.join(axes)]
            dims = (n,) if len(axes) == 1 else \
                tuple(job.result()['mesh_y_z'])
            for d, ax in enumerate((1, 2) if len(axes) == 2 else (2,)):
                line = [lay[r][d] for r in range(n)
                        if all(i == 0 for k, i in enumerate(
                            np.unravel_index(r, dims)) if k != d)]
                assert [row[0] for row in line] == [ax] * dims[d]
                assert line[0][1] == 0 and line[-1][2] == N + 1
                assert line[0][3] == 0 and line[-1][4] == N
                for a, b in zip(line, line[1:]):
                    assert a[2] == b[1] and a[4] == b[3] == b[1]
                assert all(row[2] - row[1] >= 2 for row in line)


def _sharded_shapes(shape, axes, dims, min_planes):
    """A fake mesh of ``dims`` ranks over ``axes`` and the cell shapes
    of the levels it shards (every axis halved per level)."""
    from types import SimpleNamespace
    from emg3d_tpu_torch.parallel import halo
    mesh = SimpleNamespace(mesh_dim_names=axes, mesh=torch.arange(
        int(np.prod(dims))).reshape(dims))
    shapes = []
    while halo.level_sharded(shape, mesh, min_planes):
        shapes.append(shape)
        shape = tuple(n // 2 for n in shape)
    return mesh, shapes


@pytest.mark.parametrize('shape,axes,dims,min_planes,finest', [
    ((64,) * 3, ('z',), (2,), 4, {2: (0, 32, 65)}),
    ((64, 48, 40), ('y', 'z'), (2, 2), 4,
     {1: (0, 24, 49), 2: (0, 20, 41)}),
    ((16,) * 3, ('z',), (4,), 2, {2: (0, 4, 8, 12, 17)})])
def test_partition_balanced(shape, axes, dims, min_planes, finest):
    """The nested partition of bench64 on 2 ranks, tri64x48x40 on 2×2
    and the 16³ problem on 4: along each sharded axis the ranks' node
    planes of a level k coarsenings finer than the coarsest sharded one
    differ by at most 1 + 2^k, each rank owns two or more, and every
    coarse boundary is a fine one."""
    from emg3d_tpu_torch.parallel import halo
    mesh, shapes = _sharded_shapes(shape, axes, dims, min_planes)
    parts = halo.partition(mesh, shapes)
    assert parts[0] == finest
    for lvl, (sh, part) in enumerate(zip(shapes, parts)):
        k = len(shapes) - 1 - lvl
        for ax, t in part.items():
            owned = np.diff(t)
            assert t[0] == 0 and t[-1] == sh[ax] + 1
            assert owned.min() >= 2
            assert owned.max() - owned.min() <= 1 + 2 ** k, (sh, t)
            if lvl:
                assert parts[lvl - 1][ax][:-1] == tuple(
                    2 * v for v in t[:-1])


def test_distribute_field(jobs, jax_problem):
    """DTensors keep the global shape and values (test_parallel.py:88);
    each rank holds a quarter of the z planes."""
    jt, grid, model, sfield = jax_problem
    res = jobs[4].result()
    np.testing.assert_array_equal(res['dist_fz'], np.asarray(sfield.fz))
    assert res['dist_fz_local'].tolist() == [N + 1, N + 1, N // 4]


def test_smoother_matches_jax(jobs, jax_problem):
    """The sharded smoother, gathered, equals JAX's single-device and
    shard_map smoothers within 1e-12 (test_parallel.py:125)."""
    import jax.numpy as jnp
    from emg3d_tpu import VolumeModel, parallel
    from emg3d_tpu import solver as S
    from emg3d_tpu.ops import smoothers
    from emg3d_tpu.parallel import shmap

    jt, grid, model, sfield = jax_problem
    lev = S.build_levels(grid, VolumeModel(grid, model, sfield), 0, 0,
                         np.complex128)[0]
    e, s = _random_es(sfield)
    e, s = tuple(map(jnp.asarray, e)), tuple(map(jnp.asarray, s))
    single = smoothers.gauss_seidel_point(*e, *s, *lev.arrays, nu=2)
    for n, cases in SMOOTH_CASES.items():
        for axes in cases:
            shm = shmap.gauss_seidel_point_shmap(
                e, s, lev.arrays, nu=2, shape=lev.shape,
                mesh=parallel.make_mesh(n, axes=axes))
            res = jobs[n].result()
            out = [res[f'gs_{_key(axes, n)}_{c}'] for c in range(3)]
            assert _rel(single, out) < TOL_SMOOTH, (axes, n)
            assert _rel(shm, out) < TOL_SMOOTH, (axes, n)


def test_colour_step_messages(jobs):
    """The analogue of test_halo_collectives_present (:64): at each rank
    boundary one message per colour step (16 steps at nu = 2), sent by
    the side whose boundary node plane has the colour's parity, so 8 per
    boundary and rank; the smoother sends no other message."""
    for n, cases in SMOOTH_CASES.items():
        for axes in cases:
            sends = jobs[n].result()['sends_' + _key(axes, n)]
            dims = (n,) if len(axes) == 1 else (2, n // 2)
            nb = [sum(int(c > 0) + int(c < d - 1) for c, d in
                      zip(np.unravel_index(r, dims), dims))
                  for r in range(n)]
            assert sends[:, 0].tolist() == [8 * b for b in nb], (axes, n)
            assert sends[:, 0].sum() == 16 * sum(nb) // 2
            assert sends[:, 1].tolist() == [0] * n


@pytest.mark.parametrize('axes,cycle', SOLVE_CASES[4])
def test_sharded_solve_matches_jax(jobs, jax_solves, axes, cycle):
    """F-cycle on 4 ranks ('z',) and V-cycle on 2×2 ('y', 'z'), both with
    min_local_planes=2: equal exit and it_mg to JAX's sharded and single
    solves (test_parallel.py:35, :300), fields within 1e-10; every rank
    returns the same whole field."""
    (e0, i0), (e1, i1) = (f.result() for f in jax_solves[(axes, cycle)])
    res = jobs[4].result()
    key = _key(axes, 4)
    exit_msg, it_mg = res['info_' + key]
    assert exit_msg == i0['exit_message'] == i1['exit_message'] \
        == 'CONVERGED'
    assert int(it_mg) == i0['it_mg'] == i1['it_mg']
    for ref in (e0, e1):
        assert _rel((ref,), (res['solve_' + key],)) < TOL_SOLVE
    assert res['same_' + key].all()


if __name__ == '__main__':
    _worker(sys.argv[1])
