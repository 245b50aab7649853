"""emg3d_tpu_torch: imports without JAX, device policy, launch geometry."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import emg3d_tpu_torch as pt
from emg3d_tpu_torch.ops import _build, point_gs

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / 'emg3d_tpu_torch'


def test_import_without_jax():
    # Every module of the port, by name (dtypes with its x64 switch too).
    mods = sorted('.'.join(('emg3d_tpu_torch',) + f.relative_to(
        PKG).with_suffix('').parts) for f in PKG.rglob('*.py')
        if f.name != '__init__.py')
    assert 'emg3d_tpu_torch.dtypes' in mods and len(mods) > 20
    code = (
        "import sys, importlib\n"
        "import emg3d_tpu_torch\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from emg3d_tpu_torch import solve, convert, surveys, simulations, "
        "optimize, diff, io, time, dtypes\n"
        "from emg3d_tpu_torch.cli import main, parser, run\n"
        "import emg3d_tpu_torch.__main__\n"
        "from emg3d_tpu_torch.ops import point_gs, line_gs, _build, "
        "smoothers, probes, dsres\n"
        "from emg3d_tpu_torch.parallel import distributed, halo, lines, "
        "sharding\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'jax' or m.startswith('jax.') or m == 'emg3d_tpu'\n"
        "       or m.startswith('emg3d_tpu.')]\n"
        "assert not bad, bad\n"
        "assert callable(solve) and dtypes.x64_enabled()\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                   check=True, timeout=300)


def test_no_module_imports_jax_or_emg3d_tpu():
    pat = re.compile(r'^\s*(import|from)\s+(jax|emg3d_tpu)(\.|\s|$)',
                     re.MULTILINE)
    files = sorted(PKG.rglob('*.py')) + [REPO / 'chip_smoke.py',
                                          REPO / 'profile_solve.py']
    assert len(files) > 10
    names = {f.relative_to(REPO).as_posix() for f in files}
    for mod in ('diff.py', 'dtypes.py', 'io.py', 'time.py', '__main__.py',
                'cli/__init__.py', 'cli/main.py', 'cli/parser.py',
                'cli/run.py', 'ops/probes.py', 'ops/dsres.py',
                'parallel/__init__.py', 'parallel/distributed.py',
                'parallel/sharding.py', 'parallel/halo.py',
                'parallel/lines.py'):
        assert f'emg3d_tpu_torch/{mod}' in names, mod
    for f in files:
        assert not pat.search(f.read_text()), f


def _tiny_problem():
    grid = pt.TensorMesh([np.full(4, 100.)] * 3, origin=(-200.,) * 3)
    model = pt.Model(grid, property_x=1.0)
    sfield = pt.get_source_field(grid, (0, 0, 0, 0, 0), 1.0)
    return grid, model, sfield


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    grid, model, sfield = _tiny_problem()
    with pytest.raises(RuntimeError, match='CUDA'):
        pt.solve(grid, model, sfield, verb=0)
    with pytest.raises(RuntimeError, match='CUDA'):
        pt.solve(grid, model, sfield, verb=0, device='cuda')


def test_unported_options_raise(tmp_path):
    """Options of modules still to port name their slice; sslsolver
    'gcrotmk' is ported and solves.  (Files, once refused here, are
    ported: tests/test_torch_io.py; ``sharding=`` with point smoothing
    solves: tests/test_torch_parallel.py, with line relaxation,
    semicoarsening and the Krylov solvers:
    tests/test_torch_parallel_lines.py, with a complex64 source:
    tests/test_torch_parallel_c64.py.)  Here on a one-rank gloo group
    those options solve as the unsharded solve does, a complex64 source
    too; ``solve_batched`` takes no ``sharding`` in either package
    (``emg3d_tpu/solver.py:2988-2993``): both raise TypeError."""
    import torch.distributed as dist
    from emg3d_tpu_torch import parallel
    grid, model, sfield = _tiny_problem()
    dist.init_process_group('gloo', init_method=f'file://{tmp_path}/pg',
                            world_size=1, rank=0)
    try:
        opts = parallel.shard_solve_options(parallel.make_mesh(1),
                                            min_local_planes=2)
        for kw in ({'linerelaxation': True}, {'semicoarsening': True},
                   {'sslsolver': True}):
            e0, i0 = pt.solve(grid, model, sfield, verb=0, device='cpu',
                              return_info=True, **kw)
            e1, i1 = pt.solve(grid, model, sfield, verb=0, device='cpu',
                              return_info=True, sharding=opts, **kw)
            assert i1['exit_message'] == i0['exit_message'] == 'CONVERGED'
            assert (i1['it_mg'], i1['it_ssl']) == (i0['it_mg'], i0['it_ssl'])
            assert np.linalg.norm(e1.field - e0.field) <= \
                1e-12 * np.linalg.norm(e0.field), kw
        s64 = pt.SourceField(*(f.astype(np.complex64) for f in
                               (sfield.fx, sfield.fy, sfield.fz)),
                             frequency=1.0)
        e0, i0 = pt.solve(grid, model, s64, verb=0, device='cpu',
                          return_info=True)
        e1, i1 = pt.solve(grid, model, s64, verb=0, device='cpu',
                          return_info=True, sharding=opts)
        assert i1['exit_message'] == i0['exit_message'] == 'CONVERGED'
        assert i1['it_mg'] == i0['it_mg']
        assert e1.field.dtype == e0.field.dtype == np.complex128
        assert np.linalg.norm(e1.field - e0.field) <= \
            1e-12 * np.linalg.norm(e0.field)
        with pytest.raises(TypeError, match='sharding'):
            pt.solve_batched(grid, model, [sfield], verb=0, device='cpu',
                             sharding=opts)
    finally:
        dist.destroy_process_group()
    jt = pytest.importorskip('emg3d_tpu')
    jgrid = jt.TensorMesh([np.full(4, 100.)] * 3, origin=(-200.,) * 3)
    with pytest.raises(TypeError, match='sharding'):
        jt.solve_batched(jgrid, jt.Model(jgrid, property_x=1.0),
                         [jt.get_source_field(jgrid, (0, 0, 0, 0, 0), 1.0)],
                         verb=0, sharding=jt.parallel.shard_solve_options(
                             jt.parallel.make_mesh(1)))
    _, info = pt.solve(grid, model, sfield, verb=0, device='cpu',
                       sslsolver='gcrotmk', return_info=True)
    assert info['exit_message'] == 'CONVERGED' and info['it_ssl'] > 0


def test_profile_writes_trace(tmp_path):
    """``profile=dir`` traces the whole solve with torch.profiler into
    dir: its set-up and result spans too."""
    grid, model, sfield = _tiny_problem()
    e0 = pt.solve(grid, model, sfield, verb=0, device='cpu')
    e1 = pt.solve(grid, model, sfield, verb=0, device='cpu',
                  profile=tmp_path)
    assert np.array_equal(e0.field, e1.field)
    written = list(tmp_path.glob('*.json'))
    assert written
    text = written[0].read_text()
    for name in ('emg3d.solve.setup', 'emg3d.solve.result'):
        assert f'"{name}"' in text
    pt.trace.reset()


def test_prebuilt_vmodel():
    """``_vmodel`` (prebuilt η/ζ) replaces the model."""
    grid, model, sfield = _tiny_problem()
    e0 = pt.solve(grid, model, sfield, verb=0, device='cpu')
    vm = pt.VolumeModel(grid, model, sfield)
    e1 = pt.solve(grid, None, sfield, verb=0, device='cpu', _vmodel=vm)
    assert np.array_equal(e0.field, e1.field)


def test_exports_every_ported_name():
    """Each name of the JAX package's ``__all__`` is exported by the
    port but ``cx`` (the TPU's split complex pairs, not carried over)."""
    jt = pytest.importorskip('emg3d_tpu')
    missing = set(jt.__all__) - set(pt.__all__)
    assert missing == {'cx'}
    assert pt.Fourier is pt.time.Fourier
    for name in pt.__all__:
        assert getattr(pt, name) is not None


def _cpu_state(shape, factored=True):
    rng = np.random.default_rng(0)
    cells = rng.uniform(1, 2, shape)
    arrays = (torch.tensor(cells + 1j * cells),) * 3 + (
        torch.tensor(cells), *(torch.tensor(rng.uniform(50, 150, n))
                               for n in shape))
    st = point_gs.point_state(arrays, shape, factored=factored)
    e = tuple(torch.zeros(sh, dtype=torch.complex128)
              for sh in ((shape[0], shape[1] + 1, shape[2] + 1),
                         (shape[0] + 1, shape[1], shape[2] + 1),
                         (shape[0] + 1, shape[1] + 1, shape[2])))
    s = tuple(torch.ones_like(t) for t in e)
    return st, e, s


def test_cpu_wrapper_never_builds(monkeypatch):
    """On CPU tensors the wrapper runs the plain version only."""
    def boom():
        raise AssertionError("kernel library requested for CPU tensors")
    monkeypatch.setattr(_build, 'library', boom)
    point_gs.reset_launches()
    st, e, s = _cpu_state((4, 4, 4))
    out = point_gs.gauss_seidel_point(e, s, st, 1)
    assert out[0] is e[0]                      # updated in place
    assert float(e[0].abs().max()) > 0
    assert point_gs.LAUNCHES == {'factored': 0, 'fused': 0}


def test_wrapper_checks(monkeypatch):
    st, e, s = _cpu_state((4, 4, 4), factored=False)
    with pytest.raises(ValueError, match='factored'):
        point_gs.gauss_seidel_point(e, s, st, 1, _mode='factored')
    with pytest.raises(ValueError, match='shape'):
        point_gs.gauss_seidel_point(e[::-1], s, st, 1)
    meta = tuple(t.to('meta') for t in e)
    with pytest.raises(ValueError):
        point_gs.gauss_seidel_point(meta, tuple(t.to('meta') for t in s),
                                    st, 1)


@pytest.mark.parametrize('group', ['arrays', 'st', 'w', 'ih', 'factors'])
def test_wrapper_checks_state_shapes(group):
    """A state whose tensors disagree with its shape is refused."""
    st, e, s = _cpu_state((4, 4, 4))
    other, _, _ = _cpu_state((4, 5, 4))
    bad = st._replace(**{group: getattr(other, group)})
    with pytest.raises(ValueError, match=f'{group}: shape'):
        point_gs.gauss_seidel_point(e, s, bad, 1)


def test_wrapper_checks_node_data_shape():
    """A fused state whose packed node data disagrees with its shape is
    refused; fused states with their own packed data and without any
    (direct reads; a CPU state packs none) run."""
    st, e, s = _cpu_state((4, 4, 4), factored=False)
    other, _, _ = _cpu_state((4, 5, 4), factored=False)
    assert st.factors is None and st.nodes is None
    bad = point_gs.pack_node_data(other.st, other.w, other.shape)
    with pytest.raises(ValueError, match='nodes: shape'):
        point_gs.gauss_seidel_point(e, s, st._replace(nodes=bad), 1)
    packed = point_gs.pack_node_data(st.st, st.w, st.shape)
    point_gs.gauss_seidel_point(e, s, st._replace(nodes=packed), 1)
    point_gs.gauss_seidel_point(e, s, st, 1)
    assert float(e[0].abs().max()) > 0


@pytest.mark.parametrize('shape', [(2, 2, 2), (3, 5, 7), (4, 4, 4),
                                   (64, 64, 64)])
def test_launch_geometry(shape):
    n_interior = np.prod([n - 1 for n in shape])
    seen = 0
    for color in range(8):
        first, counts, blocks, threads = point_gs.launch_geometry(shape,
                                                                  color)
        parity = (color % 2, (color // 2) % 2, color // 4)
        total = int(np.prod(counts))
        seen += total
        for f, c, n, p in zip(first, counts, shape, parity):
            assert f % 2 == p and f >= 1
            if c:                              # clamped to the level
                assert f + 2 * (c - 1) <= n - 1 < f + 2 * c
        if total == 0:
            assert (blocks, threads) == (0, 0)
        else:
            assert threads % 32 == 0 and 32 <= threads <= 256
            assert blocks * threads >= total > (blocks - 1) * threads
    assert seen == n_interior
    if shape == (2, 2, 2):
        # One interior node, of colour 7.
        assert point_gs.launch_geometry(shape, 7)[1] == (1, 1, 1)


def test_build_flags():
    assert 'arch=compute_90a,code=sm_90a' in _build.FLAGS
    assert [p.name for p in _build._sources()] == ['line_gs.cu',
                                                   'point_gs.cu',
                                                   'dsres.cu']
    assert '-shared' not in _build.FLAGS        # one object per source
