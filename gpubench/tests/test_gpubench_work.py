"""The frozen work functions: counts from the shape and the colouring,
equal to the bring-up's kernel tables where those do not depend on a
launch plan, and never above what a call that reads its inputs once
moves."""
import numpy as np
import pytest

from emg3d_tpu_torch.ops import line_gs, point_gs
from gpubench import work
from gpubench.metrics import _roofline

SHAPES = [(64, 64, 64), (256, 256, 256), (7, 5, 9), (16, 32, 8), (2, 2, 2)]


@pytest.mark.parametrize('shape', SHAPES)
def test_line_and_node_counts_from_the_shape(shape):
    for color in range(4):
        jl, kl = work.line_colour_lines(shape, color)
        rng = line_gs.colour_edges(shape, color)[0]
        assert (list(jl), list(kl)) == (list(rng[1]), list(rng[2]))
        g = line_gs.launch_geometry(shape, color)
        assert len(jl) * len(kl) == g.counts[0] * g.counts[1]
    for color in range(8):
        counts = point_gs.launch_geometry(shape, color)[1]
        assert work.point_colour_nodes(shape, color) == int(np.prod(counts))


@pytest.mark.parametrize('shape', [(64, 64, 64), (256, 256, 256)])
def test_equal_to_the_kernel_tables(shape):
    # The bring-up's tables, at the repo root, where they were copied from.
    chip_smoke = pytest.importorskip('chip_smoke')
    for color in range(4):
        assert work.colour_residual_work(shape, color) == \
            chip_smoke.colour_residual_work(shape, color)
        assert work.thomas_work(shape, color) == \
            chip_smoke.thomas_work(shape, color)
    fused = chip_smoke.point_work(shape, 'fused')
    mine = [work.point_colour_work(shape, c) for c in range(8)]
    assert sum(b for b, _ in mine) == pytest.approx(8 * fused[0], rel=1e-12)
    assert sum(f for _, f in mine) == pytest.approx(8 * fused[1], rel=1e-12)
    # The bring-up's K5 count writes every line of its stack layout, 4 ×
    # (ny/2)(nz/2); the work of the inputs is the interior lines only.
    nx, ny, nz = shape
    b, f = work.factor_work(shape)
    cb, cf = chip_smoke.factor_work(shape)
    extra = 4 * (ny // 2) * (nz // 2) - (ny - 1) * (nz - 1)
    assert cb - b == extra * nx * 23 * 16
    assert cf - f == extra * (430 + 1550 * (nx - 1) + 100 * nx)


def _level_bytes(shape, size, lanes=1, groups=1):
    """Every array of a smoothing call read once and e written once: e
    (read and written), s and r per lane, η edge sums per group, ζ face
    weights and the widths once."""
    nx, ny, nz = shape
    edges = (nx * (ny + 1) * (nz + 1) + (nx + 1) * ny * (nz + 1)
             + (nx + 1) * (ny + 1) * nz)
    faces = (nx + 1) * ny * nz + nx * (ny + 1) * nz + nx * ny * (nz + 1)
    return (lanes * 4 * edges * size + groups * edges * size
            + faces * size // 2 + (nx + ny + nz) * size // 2)


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('lanes,groups', [(1, 1), (8, 2), (19, 19)])
def test_counts_never_above_reading_every_input_once(shape, lanes, groups):
    """A step's bytes stay within the whole level read once (and the
    factor stack read once), so a step that moves its inputs once at
    the peak bandwidth reads 100 % at most."""
    nx, ny, nz = shape
    whole = _level_bytes(shape, 16, lanes, groups)
    stack = groups * (ny - 1) * (nz - 1) * nx * 23 * 16
    for color in range(4):
        assert work.colour_residual_work(shape, color, 16, lanes,
                                         groups)[0] <= whole
        assert work.thomas_work(shape, color, 16, lanes, groups)[0] <= \
            whole + stack
    assert work.factor_work(shape, 16, groups)[0] <= whole + stack
    for color in range(8):
        assert work.point_colour_work(shape, color)[0] <= \
            _level_bytes(shape, 16)


def test_share_of_a_call_at_its_bound_is_100():
    """The reader's arithmetic: calls whose device time is their bound
    read 100 %, twice their bound 50 %, whatever the split."""
    from types import SimpleNamespace
    calls = [{'kind': 'line', 'shape': (64, 32, 32), 'nu': 1, 'size': 16,
              'lanes': 8, 'groups': 2, 'builds': False},
             {'kind': 'line', 'shape': (8, 4, 4), 'nu': 2, 'size': 16,
              'lanes': 8, 'groups': 2, 'builds': True},
             {'kind': 'point', 'shape': (16, 16, 16), 'nu': 2, 'size': 16,
              'lanes': 1, 'groups': 1, 'builds': False}]
    bounds = [work.line_call_bound(c['shape'], c['nu'], 16, c['lanes'],
                                   c['groups'], c['builds'])
              if c['kind'] == 'line' else
              work.point_call_bound(c['shape'], c['nu']) for c in calls]
    for scale, want in ((1.0, 100.0), (2.0, 50.0)):
        run = SimpleNamespace(recorder=SimpleNamespace(calls=calls),
                              trace={'call_device_s': [scale * b
                                                       for b in bounds]})
        assert _roofline.share(run, 'line') == pytest.approx(want)
        assert _roofline.share(run, 'point') == pytest.approx(want)
    run = SimpleNamespace(recorder=SimpleNamespace(calls=calls[:2]),
                          trace={'call_device_s': bounds[:2]})
    assert _roofline.share(run, 'point') is None


def test_bound_follows_the_peaks():
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 34e12) == pytest.approx(1.0)
    assert work.bound_s(0, 67e12, size=8) == pytest.approx(1.0)
    assert work.line_colours(2) == [0, 1, 2, 3, 3, 2, 1, 0]
    assert work.point_colours(1) == list(range(8))
