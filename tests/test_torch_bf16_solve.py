"""Port vs JAX package: complex64 solves with bfloat16 storage.

The solves of tests/test_torch_bf16.py's checklist:

- (d) complex64 solves with bfloat16 storage forced on
  (``solver.BF16_STORAGE``; every line-factor stack in bfloat16 for
  sc+lr: ``solver.FSTACK_BYTES`` 0) against the JAX package's complex64
  CPU solve (whose XLA path stores in float32; its accelerator
  configuration for sc+lr, as tests/test_torch_complex64.py): the 16³
  fullspace with point F-cycles and 8³ sc+lr standalone here, 8³ sc+lr
  under BiCGSTAB in tests/test_torch_bf16_krylov.py (each file's JAX
  compiles stay within 90 s of one worker).  The same exit message, it_mg ±1 (ROADMAP §3 records any
  ±1), fields within 2e-5 of the JAX package's and of the complex128
  solve (the fixed point is the float32 one), every smoothing call on
  bfloat16 states, and a field that is not the float32-storage one;
- (e) the defaults: float32 storage on the CPU unless forced, bfloat16
  on a card, never for complex128 or batched solves, and the stack
  threshold of the JAX package.
"""
import pytest

pytest.importorskip('jax')

import numpy as np  # noqa: E402
import torch  # noqa: E402

import emg3d_tpu as jt  # noqa: E402

import emg3d_tpu_torch as pt  # noqa: E402
from emg3d_tpu_torch import convert, dtypes, solver  # noqa: E402
from emg3d_tpu_torch.ops import line_gs, point_gs  # noqa: E402

torch.set_num_threads(1)

BF16 = dtypes.BF16
C64 = torch.complex64
REL_FIELD = 2e-5           # complex64 fields (tests/test_torch_complex64.py)


def _fullspace(n):
    grid = jt.TensorMesh([np.full(n, 100.)] * 3, origin=(-n * 50.,) * 3)
    return grid, jt.Model(grid, property_x=1.0)


def _c64(sf, mod):
    return mod.SourceField(*(np.asarray(getattr(sf, c)).astype(np.complex64)
                             for c in ('fx', 'fy', 'fz')),
                           frequency=sf._frequency)


def _rel(a, b):
    a, b = np.asarray(a.field), np.asarray(b.field)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


class _Spy:
    """Records the storage of every state a smoothing call runs on."""

    def __init__(self, monkeypatch):
        self.seen = set()
        for mod, name in ((point_gs, 'gauss_seidel_point'),
                          (line_gs, 'line_relaxation')):
            monkeypatch.setattr(mod, name, self._wrap(getattr(mod, name)))

    def _wrap(self, fn):
        def run(e, s, state, nu, **kw):
            fac = getattr(state, 'factors', None)
            self.seen.add((state.storage, state.st[0].dtype,
                           getattr(state, 'fstorage', None),
                           None if fac is None else fac.dtype))
            return fn(e, s, state, nu, **kw)
        return run


SCLR = {'semicoarsening': 1, 'linerelaxation': 1}
# (cells per axis, options, the JAX package's accelerator configuration).
SOLVES = {
    'point-16': (16, {}, False),
    'sclr-8': (8, SCLR, True),
}


@pytest.mark.parametrize('case', list(SOLVES))
def test_solve_bf16_matches_jax(monkeypatch, case):
    check_solve(monkeypatch, *SOLVES[case])


def check_solve(monkeypatch, n, opts, accel):
    """(d) for one case: the JAX package's complex64 solve, the port's in
    complex128, in complex64 with float32 storage and with bfloat16."""
    gj, mj = _fullspace(n)
    sj = jt.get_source_field(gj, (0., 0., 0., 0., 0.), 1.0)
    gp, mp = convert.mesh_to_torch(gj), convert.model_to_torch(mj)
    sp = pt.get_source_field(gp, (0., 0., 0., 0., 0.), 1.0)
    kw = dict(cycle='F', verb=1, return_info=True, **opts)
    with monkeypatch.context() as m:
        if accel:
            m.setenv('EMG3D_TPU_SPLIT', '1')
            m.setenv('EMG3D_TPU_PIPELINE', '1')
        ej, ij = jt.solve(gj, mj, _c64(sj, jt), **kw)
    e2, _ = pt.solve(gp, mp, sp, device='cpu', **kw)
    ef, _ = pt.solve(gp, mp, _c64(sp, pt), device='cpu', **kw)
    with monkeypatch.context() as m:
        m.setattr(solver, 'BF16_STORAGE', True)
        m.setattr(solver, 'FSTACK_BYTES', 0)
        spy = _Spy(m)
        ep, ip = pt.solve(gp, mp, _c64(sp, pt), device='cpu', **kw)
    # The readings ROADMAP §3 records (pytest -s shows them).
    print(f"\n{n}³ {opts}: JAX it_mg {ij['it_mg']} / it_ssl {ij['it_ssl']}, "
          f"rel_error {ij['rel_error']:.4e}; port bf16 {ip['it_mg']} / "
          f"{ip['it_ssl']}, {ip['rel_error']:.4e}; field against JAX's "
          f"{_rel(ep, ej):.3e}")
    assert ip['exit_message'] == ij['exit_message'] == 'CONVERGED'
    assert abs(ip['it_mg'] - ij['it_mg']) <= 1, (ip['it_mg'], ij['it_mg'])
    assert ip['rel_error'] < 1e-6
    assert _rel(ep, ej) < REL_FIELD and _rel(ep, e2) < REL_FIELD
    assert ep.field.dtype == np.complex128
    # Every smoothing call ran on bfloat16 streams (and, for sc+lr,
    # bfloat16 stacks: the threshold is 0).
    assert spy.seen and all(st == BF16 and dt == BF16
                            for st, dt, _, _ in spy.seen), spy.seen
    if opts:
        assert all(fs == BF16 and fd == BF16 for _, _, fs, fd in spy.seen)
    assert not np.array_equal(np.asarray(ep.field), np.asarray(ef.field))


# ----------------------------------------------------------------------
# (e) defaults
# ----------------------------------------------------------------------

def test_default_storage():
    cpu, cuda = torch.device('cpu'), torch.device('cuda')
    c128 = torch.complex128
    assert solver.BF16_STORAGE is None
    assert solver.FSTACK_BYTES == 256_000_000
    assert solver._storage(C64, cpu) is None
    assert solver._storage(C64, cuda) is BF16
    for dev in (cpu, cuda):
        assert solver._storage(c128, dev) is None
    # 256³ and 128³ stacks exceed the threshold in float32, 64³ not.
    for n, big in ((256, True), (128, True), (64, False)):
        nbytes = line_gs.factor_bytes((n,) * 3, 0, C64)
        assert (nbytes > solver.FSTACK_BYTES) is big


def test_batched_and_complex128_never_bf16(monkeypatch):
    monkeypatch.setattr(solver, 'BF16_STORAGE', True)
    monkeypatch.setattr(solver, 'FSTACK_BYTES', 0)
    spy = _Spy(monkeypatch)
    gj, mj = _fullspace(8)
    gp, mp = convert.mesh_to_torch(gj), convert.model_to_torch(mj)
    srcs = [(-100. + 200 * i, 0., 0., 0., 0.) for i in range(2)]
    sp = [_c64(pt.get_source_field(gp, x, 1.0), pt) for x in srcs]
    _, info = pt.solve_batched(gp, mp, sp, device='cpu', cycle='F',
                               verb=1, **SCLR)
    assert info['exit_message'] == 'CONVERGED'
    _, info = pt.solve(gp, mp, pt.get_source_field(gp, srcs[0], 1.0),
                       device='cpu', cycle='F', verb=1, return_info=True,
                       **SCLR)
    assert info['exit_message'] == 'CONVERGED'
    assert spy.seen and all(st is None and fs is None and dt != BF16
                            for st, dt, fs, _ in spy.seen), spy.seen
