"""One rule picks kernel or plain PyTorch (``ops._build.kernels``).

Every op with a hand kernel and a plain version asks the rule, and
nothing else, which of the two runs.  Each case below is one site: with
the rule answering "kernel" for the CPU tensors of the test (as it does
for tensors on the card), the site takes its kernel branch, which
refuses the CPU tensors before any plain version runs; with the override
``_build.PLAIN`` on, the same call takes the plain branch and runs.
A site that still decided by the tensor's device would run its plain
version in the first half.  ``point_gs.point_kernel`` launches nothing:
it names K2 for a large level where kernels run, K1 under the override.
"""
import numpy as np
import pytest
import torch

import emg3d_tpu_torch as pt
from emg3d_tpu_torch import solver
from emg3d_tpu_torch.ops import (_build, dsres, line_gs, point_gs, probes,
                                 smoothers)
from emg3d_tpu_torch.parallel import halo, lines

torch.set_num_threads(1)

SHAPE = (4, 6, 4)
# A level whose largest colour has FUSED_NODES nodes or more: K2's.
LARGE = (64, 64, 64)


class _Slab:
    """A one-rank stand-in of :class:`.parallel.halo.Slab`: the whole
    level, no neighbours, nothing to send."""

    def __init__(self, arrays, shape):
        self.whole, self.shape = arrays, shape
        self.owned, self.lo = {}, {}
        self.nbr = {ax: (None, None) for ax in range(3)}
        self.coord = {ax: 0 for ax in range(3)}

    def split(self, axis):
        return False

    def local_colour(self, colour):
        return colour

    def colour_exchange(self, e, colour):
        pass

    def exchange(self, e, par, line_axis=None):
        pass

    def gather(self, f):
        return tuple(t.clone() for t in f)

    def cut_field(self, f):
        return f

    def line_gather(self, x, axis):
        return [x]


def _level(dtype=torch.complex128):
    """The finest level of a small random model, its fields and a lev
    of the solver's kind whose slab is a :class:`_Slab`."""
    rng = np.random.default_rng(5)
    grid = pt.TensorMesh([np.full(n, 100.) for n in SHAPE])
    model = pt.Model(grid, property_x=rng.uniform(0.5, 5, SHAPE))
    sfield = pt.SourceField.zeros(grid, frequency=1.0)
    vm = pt.VolumeModel(grid, model, sfield)
    lev = solver.build_levels(grid, vm, 0, 0, 'cpu', {'bytes': 0},
                              dtype=dtype)[0]
    lev.slab = _Slab(lev.arrays, SHAPE)
    edges = ((4, 7, 5), (5, 6, 5), (5, 7, 4))
    e = tuple(torch.tensor(rng.normal(size=sh) + 1j * rng.normal(size=sh),
                           dtype=dtype) for sh in edges)
    s = tuple(torch.tensor(rng.normal(size=sh) + 1j * rng.normal(size=sh),
                           dtype=dtype) for sh in edges)
    return lev, e, s


def _lstate(lev, axis=1, factors=True):
    return line_gs.line_state(lev.arrays, SHAPE, axis, factors=factors)


def _pstate(lev):
    return point_gs.point_state(lev.arrays, SHAPE, factored=True)


def _sweep(lev, e, s):
    state = _lstate(lev)

    def run():
        sweep = line_gs.Sweep(e, s, state)
        sweep.residual(0)
        sweep.solve(0)
        return sweep.finish()
    return run


def _residual_ds(lev, e, s):
    lev, e, s = _level(torch.complex64)
    lo = tuple(torch.zeros_like(t) for t in e)
    return lambda: dsres.residual_ds(e, lo, s, lev.arrays)


def _gathered(lev, e, s):
    def run():
        lev.lstate, lev.meter = {}, {'bytes': 0}
        return lines._gathered(e, s, lev, 1, 1)
    return run


def _relax(lev, e, s):
    state = _lstate(lev, factors=False)
    return lambda: lines.relax(e, s, lev, 1, 1, local_state=lambda: state)


def _with(make_state, call):
    """A case whose state is built before the call: ``call(state)``."""
    def prep(lev, e, s):
        state = make_state(lev)
        return lambda: call(state, e, s, lev)
    return prep


# Each site's case: inputs made on the CPU under the plain rule, then the
# call (a closure) that asks the rule.
SITES = {
    'point_gs.gauss_seidel_point': _with(
        _pstate, lambda st, e, s, lev: point_gs.gauss_seidel_point(
            e, s, st, 1)),
    'point_gs.point_kernel': lambda lev, e, s: (
        lambda: point_gs.point_kernel(LARGE, 'cpu')),
    'line_gs.line_relaxation': _with(
        _lstate, lambda st, e, s, lev: line_gs.line_relaxation(e, s, st, 1)),
    'line_gs.line_state': lambda lev, e, s: (
        lambda: line_gs.line_state(lev.arrays, SHAPE, 1)),
    'line_gs.segment_stack': _with(
        lambda lev: _lstate(lev, 0, False),
        lambda st, e, s, lev: line_gs.segment_stack(st, 3)),
    'line_gs.Sweep': _sweep,
    'dsres.residual_ds': _residual_ds,
    'lines.relax': _relax,
    'lines.schur_state': lambda lev, e, s: (
        lambda: lines.schur_state(lev, 1)),
    'lines._gathered': _gathered,
    'lines._steps': _with(
        _lstate, lambda st, e, s, lev: lines._steps(e, s, lev.slab, st, 1)),
    'halo.gauss_seidel_point_sharded': _with(
        _pstate, lambda st, e, s, lev: halo.gauss_seidel_point_sharded(
            e, s, st, 1, lev.slab)),
    'probes.tile_copy': lambda lev, e, s: lambda: probes.tile_copy(
        torch.zeros(2, 3, 8, 16), (0, 0, 0, 0), (1, 2, 8, 16)),
    'probes.smem_sum': lambda lev, e, s: lambda: probes.smem_sum(
        torch.zeros(4, 3, 8, 16), 2, 1),
    'probes.tile_roll': lambda lev, e, s: lambda: probes.tile_roll(
        torch.zeros(8, 16), 3, 1),
    'probes.dyn_slice': lambda lev, e, s: lambda: probes.dyn_slice(
        torch.zeros(2, 2, 8, 16), torch.tensor([0, 2], dtype=torch.int32), 4),
    'probes.station_solve': lambda lev, e, s: lambda: probes.station_solve(
        torch.ones(40, 4, 8)),
}
# The plain versions a site may fall to (module, name).
PLAIN = [(point_gs, 'gauss_seidel_point_plain'),
         (line_gs, 'line_relaxation_plain'), (line_gs, 'residual_plain'),
         (line_gs, 'thomas_plain'), (smoothers, 'line_factor_stack'),
         (dsres, 'residual_ds_plain'), (probes, 'tile_copy_plain'),
         (probes, 'smem_sum_plain'), (torch, 'roll'),
         (probes, 'dyn_slice_plain'), (probes, 'station_solve_plain')]


def _no_library(name='solve'):
    raise ValueError(f"no kernel for cpu: library {name!r} not built")


@pytest.mark.parametrize('site', sorted(SITES))
def test_site_asks_the_rule(monkeypatch, site):
    lev, e, s = _level()
    run = SITES[site](lev, e, s)
    called = []
    for mod, name in PLAIN:
        def spy(*a, _real=getattr(mod, name), _name=name, **k):
            called.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)

    # The rule answers "kernel" for every tensor, as for the card's.
    monkeypatch.setattr(_build, 'kernels', lambda x: not _build.PLAIN)
    monkeypatch.setattr(_build, 'library', _no_library)
    monkeypatch.setattr(_build, 'PLAIN', False)
    if site == 'point_gs.point_kernel':
        assert run() == 'fused'
    else:
        # The kernel branch refuses CPU tensors: a kernel's guard, a CUDA
        # stream or device query, or the library.
        with pytest.raises((ValueError, AssertionError),
                           match='kernel for cpu|cuda device|with CUDA'):
            run()
    assert called == [], called

    # The override: the same call runs its plain version.
    monkeypatch.setattr(_build, 'PLAIN', True)
    out = run()
    if site == 'point_gs.point_kernel':
        assert out == 'factored'
    else:
        assert called, site


def test_rule():
    """Kernels for CUDA tensors and devices unless the override is on."""
    t = torch.zeros(1)
    assert not _build.kernels(t) and not _build.kernels('cpu')
    assert _build.kernels('cuda') and _build.kernels(torch.device('cuda:0'))
    saved, _build.PLAIN = _build.PLAIN, True
    try:
        assert not _build.kernels('cuda')
    finally:
        _build.PLAIN = saved
