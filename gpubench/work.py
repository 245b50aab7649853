"""The yardstick of the smoother rooflines: the H100's published peaks,
and the bytes and operations that one smoothing call needs, counted
from the level's shape, the colouring, the lanes, the frequency groups
and the element size alone.

Each input is counted read once and each output written once per
kernel step of the algorithm (a colour step of line relaxation is a
residual on the colour's edges, then the block-Thomas solve of the
colour's lines; a colour step of point relaxation solves each node
block of the colour), whatever a kernel reads again or however the
steps are split into launches.  Operations count a complex product as
6, a complex sum as 2 and a complex reciprocal as 7.  A roofline share
is the sum of these bounds over the sum of the device time of every
kernel launched inside the calls, so it cannot pass 100 % unless a
count is too high.

The counts are those of the kernel tables of the port's bring-up
(``chip_smoke.py``: ``colour_residual_work``, ``thomas_work``,
``factor_work``, ``point_work``), frozen here, with the lines and nodes
of a colour counted from the shape and the colouring instead of from a
launch plan, and per-lane streams apart from the per-frequency-group
ones.
"""
import functools

import numpy as np

__all__ = ['PEAK_BYTES', 'PEAK_FP64', 'PEAK_FP32', 'bound_s',
           'line_colours', 'point_colours', 'line_colour_lines',
           'colour_residual_work', 'thomas_work', 'factor_work',
           'point_colour_nodes', 'point_colour_work', 'line_call_bound',
           'point_call_bound']

# Published peaks of one H100 SXM (NVIDIA's data sheet, 700 W): memory
# bandwidth, and fp64 and fp32 outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_FP64 = 34e12
PEAK_FP32 = 67e12


def bound_s(nbytes, flops, size=16):
    """Least seconds to move ``nbytes`` and do ``flops`` at the peaks of
    the element ``size`` (16: complex128 at the fp64 rate, 8: complex64
    at the fp32 rate)."""
    peak = PEAK_FP64 if size == 16 else PEAK_FP32
    return max(nbytes / PEAK_BYTES, flops / peak)


def line_colours(nu):
    """Colour sequence of one line-relaxation call of ``nu`` sweeps:
    0..3 on even sweeps, 3..0 on odd ones."""
    return [c for it in range(nu)
            for c in (range(4) if it % 2 == 0 else range(3, -1, -1))]


def point_colours(nu):
    """Colour sequence of one point-relaxation call: 0..7, 7..0, ..."""
    return [c for it in range(nu)
            for c in (range(8) if it % 2 == 0 else range(7, -1, -1))]


def line_colour_lines(shape, color):
    """(j, k) index ranges of the lines of ``color`` on a level whose
    lines run along x: the interior lines j in 1..ny−1, k in 1..nz−1
    with (j − 1) % 2 == color % 2 and (k − 1) % 2 == color // 2."""
    _, ny, nz = shape
    cy, cz = color % 2, color // 2
    return range(1 + cy, ny, 2), range(1 + cz, nz, 2)


@functools.lru_cache(maxsize=None)
def _colour_residual_counts(shape, color):
    """(edges whose residual the colour's solve takes, e values and ζ
    face weights those residuals read): rx on the lines at every
    station, ry at (1..nx−1, j−1 | j, k) and rz at (1..nx−1, j, k−1 | k)
    for each line (j, k)."""
    nx, ny, nz = shape
    jl, kl = line_colour_lines(shape, color)
    jset = np.zeros(ny + 1, bool)
    jset[list(jl)] = True
    kset = np.zeros(nz + 1, bool)
    kset[list(kl)] = True
    jadj = jset[1:] | jset[:-1]          # y-cells beside a line (ny)
    kadj = kset[1:] | kset[:-1]          # z-cells beside a line (nz)
    xin = np.zeros(nx + 1, bool)
    xin[1:nx] = True
    xall = np.ones(nx, bool)
    mx = xall[:, None, None] & jset[None, :, None] & kset[None, None, :]
    my = xin[:, None, None] & jadj[None, :, None] & kset[None, None, :]
    mz = xin[:, None, None] & jset[None, :, None] & kadj[None, None, :]
    n = int(mx.sum() + my.sum() + mz.sum())
    # Faces whose weighted curls those residuals take.
    f1 = np.zeros((nx + 1, ny, nz), bool)
    f2 = np.zeros((nx, ny + 1, nz), bool)
    f3 = np.zeros((nx, ny, nz + 1), bool)
    f3 |= mx[:, :ny] | mx[:, 1:]
    f2 |= mx[:, :, :nz] | mx[:, :, 1:]
    f1 |= my[:, :, :nz] | my[:, :, 1:]
    f3 |= my[:nx] | my[1:]
    f2 |= mz[:nx] | mz[1:]
    f1 |= mz[:, :ny] | mz[:, 1:]
    # The e values of those curls.
    ex = np.zeros((nx, ny + 1, nz + 1), bool)
    ey = np.zeros((nx + 1, ny, nz + 1), bool)
    ez = np.zeros((nx + 1, ny + 1, nz), bool)
    for a, b in ((ez[:, :ny], f1), (ez[:, 1:], f1), (ey[:, :, :nz], f1),
                 (ey[:, :, 1:], f1), (ex[:, :, :nz], f2), (ex[:, :, 1:], f2),
                 (ez[:nx], f2), (ez[1:], f2), (ey[:nx], f3), (ey[1:], f3),
                 (ex[:, :ny], f3), (ex[:, 1:], f3)):
        a |= b
    reads = int(ex.sum() + ey.sum() + ez.sum())
    faces = int(f1.sum() + f2.sum() + f3.sum())
    return n, reads, faces


def colour_residual_work(shape, color, size=16, lanes=1, groups=1):
    """(bytes, flops) of the residual of one colour step: per lane r
    written, s read at the colour's edges and the e values their
    residuals need; per frequency group the η edge sums at those edges;
    the ζ face weights (real) once; ~76 FLOP per edge and lane."""
    n, reads, faces = _colour_residual_counts(tuple(shape), color)
    return (lanes * (2 * n + reads) * size + groups * n * size
            + faces * size // 2, lanes * n * 76)


def thomas_work(shape, color, size=16, lanes=1, groups=1):
    """(bytes, flops) of the block-Thomas solve of one colour: per line
    and station the 23 factor entries of its group's stack, and per lane
    5 residuals read and 5 field values read and written (1 at the last
    station); ~530 FLOP per line-station and lane."""
    nx = shape[0]
    jl, kl = line_colour_lines(shape, color)
    lines = len(jl) * len(kl)
    return (lines * (groups * 23 * nx * size
                     + lanes * 3 * (5 * (nx - 1) + 1) * size),
            lanes * lines * nx * 530)


def factor_work(shape, size=16, groups=1):
    """(bytes, flops) of building the factor stacks of a level (one per
    frequency group): its η sums (per group), ζ weights and inverse
    widths read once, the 23 entries of every interior line-station
    written once; ~430 FLOP at station 0, ~1550 at the others and ~100
    for each station's assembly."""
    nx, ny, nz = shape
    lines = (ny - 1) * (nz - 1)
    sums = (nx * (ny - 1) * (nz - 1) + (nx - 1) * ny * (nz - 1)
            + (nx - 1) * (ny - 1) * nz)
    faces = (nx + 1) * ny * nz + nx * (ny + 1) * nz + nx * ny * (nz + 1)
    return (groups * (sums + lines * nx * 23) * size
            + (faces + nx + ny + nz) * size // 2,
            groups * lines * (430 + 1550 * (nx - 1) + 100 * nx))


def point_colour_nodes(shape, color):
    """Nodes of point colour ``color``: interior nodes 1..n−1 per axis
    whose index has the colour's parity there."""
    parity = (color % 2, (color // 2) % 2, color // 4)
    out = 1
    for n, p in zip(shape, parity):
        first = 2 - p
        out *= max(0, (n - 1 - first) // 2 + 1)
    return out


def point_colour_work(shape, color, size=16):
    """(bytes, flops) of one point colour step from the level's own
    inputs: per node the six block edges' e read and written, s and the
    six η edge sums read, twelve ζ face weights (real) read; ~1590 FLOP
    to assemble, factor and solve the 6 × 6 block.  A kernel that reads
    stored factors instead moves more bytes for the same step."""
    nodes = point_colour_nodes(shape, color)
    return nodes * (12 * size + 12 * size + 12 * size // 2), nodes * 1590


def line_call_bound(shape, nu, size=16, lanes=1, groups=1, builds=False):
    """Least seconds of one line-relaxation call on a level whose lines
    run along x (``shape`` in that frame): every colour step's residual
    and solve, and the factor stacks where the call builds them."""
    t = 0.0
    for color in line_colours(nu):
        t += bound_s(*colour_residual_work(shape, color, size, lanes,
                                           groups), size)
        t += bound_s(*thomas_work(shape, color, size, lanes, groups), size)
    if builds:
        t += bound_s(*factor_work(shape, size, groups), size)
    return t


def point_call_bound(shape, nu, size=16):
    """Least seconds of one point-relaxation call of one lane."""
    return sum(bound_s(*point_colour_work(shape, c, size), size)
               for c in point_colours(nu))
