"""Double-single (two-float) residual and accumulation for complex64 solves.

Counterpart of ``emg3d_tpu/ops/dsres.py`` and of the JAX package's
``_ds_accumulate`` (``emg3d_tpu/solver.py:1432-1456``).  Near tol=1e-6
a float32 evaluation of r = s − A·e is itself the accuracy floor: the
curl-curl rows sum O(‖s‖) terms whose roundings leave ~2⁻²⁴·‖s‖ of noise.
A complex64 solve therefore carries its solution as a (hi, lo) pair of
complex64 streams (:func:`ds_accumulate`, Knuth's two-sum per real and
imaginary part) and evaluates its convergence residual on the SAME
float32 operator the smoothers relax (the level's float32 η edge sums,
ζ face weights and inverse widths, computed from its float32 arrays) in
double-single arithmetic (:func:`residual_ds`): every sum a two-sum,
every coefficient product an error-free two-product, the result folded
to complex64 (hi + lo per channel).

:func:`residual_ds` runs the CUDA kernel K6 (``csrc/dsres.cu``, through
:func:`residual`) where :func:`._build.kernels` says so, else
:func:`residual_ds_plain`, the plain torch version of the JAX package's
arithmetic (Dekker's split for the two-product: torch ops never fuse).
Both produce the same exact error terms in the same order, so they agree
bit for bit.  Fields may carry a leading lane axis (a batched solve), as
may η (one frequency per lane).  K6's launch plan is :func:`tile_plan`
(a y-z tile marching along x over a chunk of planes, each face curl
once).
"""
import ctypes
from typing import NamedTuple

import torch

from . import _build, stencil

__all__ = ['residual_ds', 'residual_ds_plain', 'residual', 'ds_params',
           'ds_accumulate', 'two_sum', 'LAUNCHES', 'reset_launches',
           'TilePlan', 'tile_plan', 'tile_smem']

# Launches of K6 since the last reset_launches().
LAUNCHES = {'residual_ds': 0}
# The tiled plan: tile rows (y, at most; blockDim.y) and columns (z, one
# warp; csrc/dsres.cu kMaxTJ, kTK); x planes per block at most, and the
# blocks, over all lanes, below which a level takes fewer planes per
# block (two per SM of an H100, about): the fastest chunks of the card's
# tables at 256³ (16), 64³ (4) and 8 lanes of 64³ (16; chip_smoke.py
# phase 15a).
TILE_J = 8
TILE_K = 32
MAX_CHUNK = 16
MIN_BLOCKS = 256


class TilePlan(NamedTuple):
    """K6's launch plan: ``tile`` (tj, tk) indices along y and z and
    ``chunk`` x planes per block; CUDA ``block`` and ``grid`` dimensions
    (grid y = lanes) and the dynamic shared-memory bytes."""
    tile: tuple
    chunk: int
    block: tuple
    grid: tuple
    smem: int


def tile_smem(tj):
    """Shared bytes of a tile of ``tj`` rows (csrc/dsres.cu tile_smem):
    a ring of three edge stages (ex, ey, ez, hi and lo, each (tj+2) ×
    (TILE_K+2) complex64) and eight face planes of (tj+1) × (TILE_K+1)
    complex double-single values (16 B)."""
    return (3 * 6 * (tj + 2) * (TILE_K + 2) * 8
            + 8 * (tj + 1) * (TILE_K + 1) * 16)


def tile_plan(shape, lanes=1, chunk=None):
    """K6's tiled plan for a level of ``shape`` cells and ``lanes`` lanes.

    A block owns a (tj × 32) tile of y-z indices, tj = min(TILE_J, ny),
    and marches along x over ``chunk`` planes; the last tile along y (z)
    also owns index ny (nz) where the tiles end there.  Without a
    ``chunk``, a block takes MAX_CHUNK planes, or fewer where the level
    would otherwise launch under MIN_BLOCKS blocks.
    """
    nx, ny, nz = shape
    tj = min(TILE_J, ny)
    tiles = -(-ny // tj) * -(-nz // TILE_K)
    if chunk is None:
        chunk = max(1, min(MAX_CHUNK, nx * tiles * lanes // MIN_BLOCKS))
    chunks = -(-nx // chunk)
    return TilePlan((tj, TILE_K), chunk, (TILE_K, tj, 1),
                    (tiles * chunks, lanes, 1), tile_smem(tj))


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------------
# Error-free transformations (elementwise, float32)
# ----------------------------------------------------------------------

def two_sum(a, b):
    """Knuth's two-sum: (s, e) with s = fl(a + b) and s + e = a + b."""
    s = a + b
    bp = s - a
    return s, (a - (s - bp)) + (b - bp)


def _split(a):
    # Dekker/Veltkamp split for binary32 (p=24): factor 2^12 + 1.
    c = a * 4097.0
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


# Double-single values: x = (hi, lo); a complex one (re pair, im pair).

def _dadd(x, y):
    s, e = two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return two_sum(s, e)


def _dsub(x, y):
    return _dadd(x, (-y[0], -y[1]))


def _dscale(x, c):
    """x · c with a plain float32 coefficient c."""
    p, e = _two_prod(x[0], c)
    return two_sum(p, e + x[1] * c)


def _dpow2(x, c):
    """x · c for an exact power of two (0.5, 0.25)."""
    return (x[0] * c, x[1] * c)


def _ddiff(x, axis):
    n = x[0].shape[axis]
    return _dsub(tuple(t.narrow(axis, 1, n - 1) for t in x),
                 tuple(t.narrow(axis, 0, n - 1) for t in x))


def _cadd(a, b):
    return (_dadd(a[0], b[0]), _dadd(a[1], b[1]))


def _csub(a, b):
    return (_dsub(a[0], b[0]), _dsub(a[1], b[1]))


def _cscale(a, c):
    return (_dscale(a[0], c), _dscale(a[1], c))


def _cpow2(a, c):
    return (_dpow2(a[0], c), _dpow2(a[1], c))


def _cmul_plain(a, wre, wim):
    """Complex DS × plain complex (wre, wim)."""
    return (_dsub(_dscale(a[0], wre), _dscale(a[1], wim)),
            _dadd(_dscale(a[0], wim), _dscale(a[1], wre)))


def _cdiff(a, axis):
    return (_ddiff(a[0], axis), _ddiff(a[1], axis))


def _cslice(a, idx):
    return tuple((x[0][idx], x[1][idx]) for x in a)


def _cds(hi, lo):
    """Complex DS from (hi, lo) complex64 tensors (lo may be None)."""
    if lo is None:
        z = torch.zeros_like(hi.real)
        return ((hi.real, z), (hi.imag, z))
    return ((hi.real, lo.real), (hi.imag, lo.imag))


def _collapse(c):
    """DS result -> complex64 (hi + lo folded per channel)."""
    return torch.complex(c[0][0] + c[0][1], c[1][0] + c[1][1])


# ----------------------------------------------------------------------
# The residual
# ----------------------------------------------------------------------

def ds_params(arrays):
    """The float32 operator of a level from its ``(eta_x, eta_y, eta_z,
    zeta, hx, hy, hz)``: η edge sums, ζ face weights and inverse widths,
    contiguous, computed as the smoothers' states compute them (η may
    carry a lane axis)."""
    eta_x, eta_y, eta_z, zeta, hx, hy, hz = arrays
    st = tuple(t.contiguous() for t in
               stencil.eta_edge_sums(eta_x, eta_y, eta_z))
    w = tuple(t.contiguous() for t in stencil.zeta_face_weights(zeta))
    ih = tuple((1.0 / h).contiguous() for h in (hx, hy, hz))
    return st, w, ih


def residual_ds_plain(ehi, elo, s, arrays, params=None):
    """r = s − A·(ehi + elo) in double-single float32 (plain torch).

    ``ehi``/``elo``/``s`` are complex64 edge tuples (``elo`` may be
    None), optionally with a leading lane axis; ``arrays`` the level's
    float32 arrays (η complex64), ``params`` their :func:`ds_params`.
    Returns complex64 components: the folded double-single value at
    interior edges, s on the PEC rows.  The operations, and their
    order, are those of ``emg3d_tpu.ops.dsres.residual_ds``.
    """
    st, w, ih = ds_params(arrays) if params is None else params
    wx, wy, wz = w
    ihx = ih[0][:, None, None]
    ihy = ih[1][None, :, None]
    ihz = ih[2][None, None, :]
    ex, ey, ez = (_cds(h, None if elo is None else lo)
                  for h, lo in zip(ehi, (None,) * 3 if elo is None
                                   else elo))

    # First curl on faces, ζ-weighted (u = (ζl + ζr)·(∇×e)).
    v1 = _csub(_cscale(_cdiff(ez, -2), ihy), _cscale(_cdiff(ey, -1), ihz))
    v2 = _csub(_cscale(_cdiff(ex, -1), ihz), _cscale(_cdiff(ez, -3), ihx))
    v3 = _csub(_cscale(_cdiff(ey, -3), ihx), _cscale(_cdiff(ex, -2), ihy))
    u1 = _cscale(v1, wx)
    u2 = _cscale(v2, wy)
    u3 = _cscale(v3, wz)

    # Second curl at interior edges + η term (amat_interior layout).
    i3 = (Ellipsis, slice(1, -1))
    i2 = (Ellipsis, slice(1, -1), slice(None))
    i1 = (Ellipsis, slice(1, -1), slice(None), slice(None))
    rrx = _csub(_cdiff(_cscale(_cslice(u3, i3), ihy), -2),
                _cdiff(_cscale(_cslice(u2, i2), ihz), -1))
    rry = _csub(_cdiff(_cscale(_cslice(u1, i1), ihz), -1),
                _cdiff(_cscale(_cslice(u3, i3), ihx), -3))
    rrz = _csub(_cdiff(_cscale(_cslice(u2, i2), ihx), -3),
                _cdiff(_cscale(_cslice(u1, i1), ihy), -2))

    ix = (Ellipsis, slice(1, -1), slice(1, -1))
    iy = (Ellipsis, slice(1, -1), slice(None), slice(1, -1))
    iz = (Ellipsis, slice(1, -1), slice(1, -1), slice(None))
    out = []
    for rr, e, sum_, sl, src in ((rrx, ex, st[0], ix, s[0]),
                                 (rry, ey, st[1], iy, s[1]),
                                 (rrz, ez, st[2], iz, s[2])):
        a = _csub(_cpow2(rr, 0.5),
                  _cpow2(_cmul_plain(_cslice(e, sl), sum_.real, sum_.imag),
                         0.25))
        r = _csub(_cslice(_cds(src, None), sl), a)
        # PEC rows keep r = s (amat's rows are zero there).
        full = src.clone()
        full[sl] = _collapse(r)
        out.append(full)
    return tuple(out)


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def residual(ehi, elo, s, params, out=None, _plan=None):
    """``out`` ← s − A·(ehi + elo), folded, by K6 (complex64 CUDA
    tensors, optionally with a leading lane axis; ``elo`` may be None);
    returns ``out`` (new tensors like ``s`` if None).  ``params`` is the
    level's :func:`ds_params` (η sums with or without the lane axis).
    The launch plan is :func:`tile_plan` of the level; ``_plan`` forces
    another chunk (chip_smoke.py's chunk table).  The plain version is
    :func:`residual_ds_plain`; CPU tensors raise.
    """
    if s[0].device.type != 'cuda':
        raise ValueError(f"no residual_ds kernel for {s[0].device}")
    st, w, ih = params
    nx, ny, nz = (len(h) for h in ih)
    lead = tuple(s[0].shape[:-3])
    if len(lead) > 1:
        raise ValueError(f"residual_ds: at most one lane axis; got "
                         f"{tuple(s[0].shape)}")
    lanes = lead[0] if lead else 1
    edges = ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
             (nx + 1, ny + 1, nz))
    sums = ((nx, ny - 1, nz - 1), (nx - 1, ny, nz - 1),
            (nx - 1, ny - 1, nz))
    faces = ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))
    st_lanes = int(st[0].ndim == 4)
    if st_lanes and tuple(st[0].shape[:1]) != (lanes,):
        raise ValueError(f"residual_ds: η sums of {st[0].shape[0]} lanes "
                         f"for fields of {lanes}")
    if out is None:
        out = tuple(torch.empty_like(t) for t in s)
    dev = s[0].device
    checks = [('s', s, edges, torch.complex64, lead),
              ('ehi', ehi, edges, torch.complex64, lead),
              ('out', out, edges, torch.complex64, lead),
              ('st', st, sums, torch.complex64, lead if st_lanes else ()),
              ('w', w, faces, torch.float32, ()),
              ('ih', ih, ((nx,), (ny,), (nz,)), torch.float32, ())]
    if elo is not None:
        checks.append(('elo', elo, edges, torch.complex64, lead))
    for name, trio, shapes, dtype, pre in checks:
        for t, sh in zip(trio, shapes):
            if (tuple(t.shape) != pre + sh or t.dtype != dtype
                    or t.device != dev or not t.is_contiguous()):
                raise ValueError(
                    f"residual_ds: {name} must be contiguous {dtype} "
                    f"{pre + sh} on {dev}; got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
    plan = _plan or tile_plan((nx, ny, nz), lanes)
    if plan.grid[1] != lanes:
        raise ValueError(f"residual_ds: a plan for {plan.grid[1]} lanes "
                         f"for fields of {lanes}")
    tj, tk = plan.tile
    lo = (None,) * 3 if elo is None else elo
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = _build.library().emg3d_residual_ds_c64(
        *(_ptr(t) for t in (*out, *ehi, *lo, *s, *st, *w, *ih)),
        nx, ny, nz, lanes, st_lanes, tj, tk, plan.chunk, plan.grid[0],
        plan.block[0] * plan.block[1], plan.smem, stream)
    if err != 0:
        raise RuntimeError(f"residual_ds kernel launch failed: cudaError "
                           f"{err} (level {(nx, ny, nz)}, {lanes} lanes, "
                           f"{plan})")
    LAUNCHES['residual_ds'] += 1
    return out


def residual_ds(ehi, elo, s, arrays, params=None):
    """r = s − A·(ehi + elo) of a complex64 level in double-single
    arithmetic, folded to complex64 (the JAX package's ``residual_ds``).

    K6 (:func:`residual`) where :func:`._build.kernels` says so, else
    :func:`residual_ds_plain`.  ``params`` are the level's
    :func:`ds_params` (computed from ``arrays`` when None).  A leading
    lane axis on the fields (and on η) is the batched form.
    """
    if params is None:
        params = ds_params(arrays)
    if _build.kernels(s[0]):
        return residual(ehi, elo, s, params)
    return residual_ds_plain(ehi, elo, s, arrays, params)


def ds_accumulate(ehi, elo, delta):
    """(ehi, elo) += delta with Knuth's two-sum on the real and the
    imaginary part of every element: hi stays the float32 rounding of
    the accumulated solution, lo carries the remainders.  Returns the
    new (hi, lo) tuples (the JAX package's ``_ds_accumulate``)."""
    hi_out, lo_out = [], []
    for h, lo, d in zip(ehi, elo, delta):
        hr, lr = two_sum(h.real, d.real + lo.real)
        hi_, li = two_sum(h.imag, d.imag + lo.imag)
        hi_out.append(torch.complex(hr, hi_))
        lo_out.append(torch.complex(lr, li))
    return tuple(hi_out), tuple(lo_out)
