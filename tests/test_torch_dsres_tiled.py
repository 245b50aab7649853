"""K6's tiled launch plan (``emg3d_tpu_torch.ops.dsres.tile_plan``).

The CUDA kernel runs only on the card; here its plan and its data flow
are held on the CPU:

- the edges every block of a plan writes, as ``csrc/dsres.cu``'s tiled
  kernel assigns them (its (tj × 32) tile of y-z indices over its chunk
  of x planes, the extra index row ny / column nz of the last tiles, node
  plane nx in the last chunk), cover every edge of every component
  exactly once, PEC rows included, at shapes from 1³ to 256³ with one
  and three lanes;
- the plan's shared memory fits the H100's 232 448-byte opt-in, its
  threads are whole warps, and 64³ launches at least one block per SM;
- :func:`tiled_residual`, a torch evaluation of the residual block by
  block from the plan (edges loaded with the kernel's one-cell halo and
  zeros outside the arrays, each face curl computed and scaled once per
  tile and plane, the halo faces and one extra plane per chunk as the
  kernel computes them), equals ``residual_ds_plain`` bit for bit
  (``torch.equal``) on random complex64 data from a numpy seed, with
  and without the lo stream and with η per lane, and is within rel
  1e-12 of ``emg3d_tpu.ops.dsres.residual_ds`` (run on the CPU, not
  jitted, as tests/test_torch_complex64.py runs it).
"""
import numpy as np
import pytest

pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from emg3d_tpu.ops.dsres import residual_ds as j_residual_ds  # noqa: E402

from emg3d_tpu_torch.ops import dsres  # noqa: E402
from emg3d_tpu_torch.ops.dsres import (_cdiff, _cds, _cmul_plain,  # noqa
                                       _collapse, _cpow2, _cscale, _csub)

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

SMEM_OPTIN = 232448      # the H100's opt-in shared memory per block
SMS = 132                # the H100's streaming multiprocessors
COVER_SHAPES = ((1, 1, 1), (2, 3, 5), (12, 10, 8), (16, 16, 16),
                (37, 23, 19), (64, 64, 64), (256, 256, 256))


# ----------------------------------------------------------------------
# The kernel's assignment of edges to blocks
# ----------------------------------------------------------------------

def _blocks(plan, shape):
    """(i0, i1, j0, k0) of every block of a tiled plan, in the kernel's
    order (tile column fastest, then tile row, then chunk)."""
    nx, ny, nz = shape
    tj, tk = plan.tile
    tiles_j, tiles_k = -(-ny // tj), -(-nz // tk)
    for b in range(plan.grid[0]):
        ck, cj, ch = b % tiles_k, (b // tiles_k) % tiles_j, \
            b // (tiles_k * tiles_j)
        i0 = ch * plan.chunk
        yield i0, min(i0 + plan.chunk, nx), cj * tj, ck * tk


def _limits(shape):
    """Largest (j, k) index of ex, ey, ez."""
    _, ny, nz = shape
    return (ny, nz), (ny - 1, nz), (ny, nz - 1)


def _boxes(plan, shape, block):
    """The edges a block writes, per component (0 ex, 1 ey, 2 ez), as
    boxes ('main' | 'copy', planes, j range, k range): its threads'
    (j, k) over its planes (computed where interior, s on PEC rows;
    node plane 0 all PEC), the extra index row ny and column nz where
    the last tile ends at them (all PEC; the corner in the row), and
    node plane nx in the last chunk (all PEC)."""
    nx, ny, nz = shape
    tj, tk = plan.tile
    i0, i1, j0, k0 = block
    xrow, xcol = j0 + tj == ny, k0 + tk == nz
    out = []
    for c, (jm, km) in enumerate(_limits(shape)):
        def box(kind, planes, jr, kr):
            jr = (jr[0], min(jr[1], jm + 1))
            kr = (kr[0], min(kr[1], km + 1))
            if planes[1] > planes[0] and jr[1] > jr[0] and kr[1] > kr[0]:
                out.append((c, kind, planes, jr, kr))
        main = ((j0, j0 + tj), (k0, k0 + tk))
        extras = []
        if xrow:
            extras.append(((ny, ny + 1), (k0, k0 + tk + xcol)))
        if xcol:
            extras.append(((j0, j0 + tj), (nz, nz + 1)))
        if c == 0:
            box('main', (i0, i1), *main)
        else:
            box('copy', (i0, min(i1, 1)), *main)
            box('main', (max(i0, 1), i1), *main)
        for e in extras:
            box('copy', (i0, i1), *e)
        if c > 0 and i1 == nx:
            box('copy', (nx, nx + 1), *main)
            for e in extras:
                box('copy', (nx, nx + 1), *e)
    return out


@pytest.mark.parametrize('lanes', [1, 3])
@pytest.mark.parametrize('shape', COVER_SHAPES)
def test_tile_plan_covers_every_edge_once(shape, lanes):
    plan = dsres.tile_plan(shape, lanes)
    assert plan.grid[1] == lanes
    count = [np.zeros(sh, np.uint8) for sh in tp.edge_shapes(shape)]
    for block in _blocks(plan, shape):
        for c, _, pl, jr, kr in _boxes(plan, shape, block):
            count[c][pl[0]:pl[1], jr[0]:jr[1], kr[0]:kr[1]] += 1
    for c in count:
        assert c.min() == 1 and c.max() == 1


@pytest.mark.parametrize('lanes', [1, 3])
@pytest.mark.parametrize('shape', COVER_SHAPES)
def test_tile_plan_fits_the_card(shape, lanes):
    plan = dsres.tile_plan(shape, lanes)
    nx, ny, nz = shape
    tj, tk = plan.tile
    assert tk == dsres.TILE_K == 32 and 1 <= tj <= dsres.TILE_J
    assert plan.block == (tk, tj, 1)
    threads = plan.block[0] * plan.block[1]
    assert threads % 32 == 0 and threads <= 256
    assert plan.smem == dsres.tile_smem(tj) <= SMEM_OPTIN
    # Two blocks per SM fit the shared memory (228 KB per SM, 1 KB
    # reserved per block).
    assert 2 * (plan.smem + 1024) <= 228 * 1024
    tiles = -(-ny // tj) * -(-nz // tk)
    assert plan.grid[0] == tiles * -(-nx // plan.chunk)
    assert 1 <= plan.chunk <= nx
    if shape == (64, 64, 64):
        assert plan.grid[0] * plan.grid[1] >= SMS
    # Every forced chunk (chip_smoke.py's chunk table) fills the
    # entry's plan ints as the chosen one does.
    for chunk in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        forced = dsres.tile_plan(shape, lanes, chunk=chunk)
        assert forced.grid == (tiles * -(-nx // chunk), lanes, 1)
        assert (forced.tile, forced.block, forced.smem, forced.chunk) == \
            (plan.tile, plan.block, plan.smem, chunk)


# ----------------------------------------------------------------------
# The residual evaluated tile by tile
# ----------------------------------------------------------------------

def _pad(x, tj, tk):
    """Zero-padded copy: index j → j + 1 along y and k → k + 1 along z,
    with a tile's room beyond the end (the kernel's zero fill)."""
    return torch.nn.functional.pad(x, (1, tk + 1, 1, tj + 1))


def _dpad(c, tj, tk):
    return tuple(tuple(_pad(t, tj, tk) for t in d) for d in c)


def _tile(c, planes, j0, k0, rows, cols):
    """Planes ``planes`` and padded rows j0.., columns k0.. of a padded
    complex DS value."""
    return tuple(tuple(t[:, planes[0]:planes[1], j0:j0 + rows,
                         k0:k0 + cols] for t in d) for d in c)


def tiled_residual(ehi, elo, s, params, plan):
    """r = s − A·(ehi + elo) evaluated block by block from a tiled plan,
    as the kernel does: per block the edge tiles of its planes with a
    one-cell halo (zeros outside the arrays), every face curl of the
    tile computed once per plane (its halo row and column included, and
    plane i0-1 again where the chunk starts inside the level) and scaled
    once by each width its second curls take, then the edges of
    :func:`_boxes` from those faces (s on PEC rows).  Fields
    carry a lane axis when ``plan`` has several lanes; every edge must
    be written once."""
    st, w, ih = params
    nx, ny, nz = (len(h) for h in ih)
    shape = (nx, ny, nz)
    tj, tk = plan.tile
    one = s[0].ndim == 3

    def lane(t):
        return None if t is None else (t[None] if one else t)
    src = [lane(t) for t in s]
    stl = [t[None] if t.ndim == 3 else t for t in st]
    e = [_dpad(_cds(lane(h), None if elo is None else lane(x)), tj, tk)
         for h, x in zip(ehi, (None,) * 3 if elo is None else elo)]
    sp = [_pad(t, tj, tk) for t in src]
    stp = [_pad(t, tj, tk) for t in stl]
    wp = [_pad(t, tj, tk) for t in w]
    ihx = ih[0]
    ihy = torch.nn.functional.pad(ih[1], (1, tj + 1))
    ihz = torch.nn.functional.pad(ih[2], (1, tk + 1))
    out = [torch.full_like(t, complex('nan')) for t in src]
    count = [torch.zeros(t.shape[1:], dtype=torch.int32) for t in src]
    for block in _blocks(plan, shape):
        i0, i1, j0, k0 = block
        q0 = max(i0 - 1, 0)      # first plane of faces
        ex = _tile(e[0], (q0, i1), j0, k0, tj + 2, tk + 2)
        ey = _tile(e[1], (q0, i1 + 1), j0, k0, tj + 2, tk + 2)
        ez = _tile(e[2], (q0, i1 + 1), j0, k0, tj + 2, tk + 2)
        hy = ihy[j0:j0 + tj + 2][:, None]
        hz = ihz[k0:k0 + tk + 2]
        hx = ihx[q0:i1][:, None, None]
        wx, wy, wz = (t[None, q0:i1, j0:j0 + tj + 1, k0:k0 + tk + 1]
                      for t in wp)

        def cut(c, rows=tj + 1, cols=tk + 1, planes=None):
            pl = slice(None) if planes is None else slice(*planes)
            return tuple(tuple(t[:, pl, :rows, :cols] for t in d)
                         for d in c)
        n = i1 - q0
        u1 = _cscale(_csub(
            _cscale(cut(_cdiff(ez, -2), planes=(0, n)), hy[:tj + 1]),
            _cscale(cut(_cdiff(ey, -1), planes=(0, n)), hz[:tk + 1])), wx)
        u2 = _cscale(_csub(_cscale(cut(_cdiff(ex, -1)), hz[:tk + 1]),
                           _cscale(cut(_cdiff(ez, -3)), hx)), wy)
        u3 = _cscale(_csub(_cscale(cut(_cdiff(ey, -3)), hx),
                           _cscale(cut(_cdiff(ex, -2)), hy[:tj + 1])), wz)
        # Each face times the two widths its second curls take, once.
        u1z, u1y = _cscale(u1, hz[:tk + 1]), _cscale(u1, hy[:tj + 1])
        u2z, u2x = _cscale(u2, hz[:tk + 1]), _cscale(u2, hx)
        u3y, u3x = _cscale(u3, hy[:tj + 1]), _cscale(u3, hx)

        def face(u, planes, dj=0, dk=0):
            """Face tile entries at this block's (j - dj, k - dk)."""
            return tuple(tuple(t[:, planes[0] - q0:planes[1] - q0,
                                 1 - dj:tj + 1 - dj, 1 - dk:tk + 1 - dk]
                               for t in d) for d in u)

        def edge_at(c, planes):
            lo = planes[0] - q0
            return tuple(tuple(t[:, lo:lo + planes[1] - planes[0],
                                 1:tj + 1, 1:tk + 1] for t in d)
                         for d in (ex, ey, ez)[c])

        def fold(rr, c, planes, dj, dk):
            stt = stp[c][:, planes[0] - (c > 0):planes[1] - (c > 0),
                         j0 + dj:j0 + dj + tj, k0 + dk:k0 + dk + tk]
            a = _csub(_cpow2(rr, 0.5), _cpow2(_cmul_plain(
                edge_at(c, planes), stt.real, stt.imag), 0.25))
            sc = sp[c][:, planes[0]:planes[1], j0 + 1:j0 + tj + 1,
                       k0 + 1:k0 + tk + 1]
            return _collapse(_csub(_cds(sc, None), a))

        for c, kind, pl, jr, kr in _boxes(plan, shape, block):
            idx = (slice(None), slice(*pl), slice(*jr), slice(*kr))
            count[c][idx[1:]] += 1
            if kind == 'copy':
                out[c][idx] = src[c][idx]
                continue
            prev = (pl[0] - 1, pl[1] - 1)
            if c == 0:
                rr = _csub(_csub(face(u3y, pl), face(u3y, pl, dj=1)),
                           _csub(face(u2z, pl), face(u2z, pl, dk=1)))
                val = fold(rr, 0, pl, 0, 0)
            elif c == 1:
                rr = _csub(_csub(face(u1z, pl), face(u1z, pl, dk=1)),
                           _csub(face(u3x, pl), face(u3x, prev)))
                val = fold(rr, 1, pl, 1, 0)
            else:
                rr = _csub(_csub(face(u2x, pl), face(u2x, prev)),
                           _csub(face(u1y, pl), face(u1y, pl, dj=1)))
                val = fold(rr, 2, pl, 0, 1)
            val = val[:, :, :jr[1] - jr[0], :kr[1] - kr[0]]
            # PEC rows keep r = s.
            jj = torch.arange(*jr)[:, None]
            kk = torch.arange(*kr)[None, :]
            pec = ((jj == 0) | (jj == ny) | (kk == 0) | (kk == nz),
                   (kk == 0) | (kk == nz) | (jj < 0),
                   (jj == 0) | (jj == ny) | (kk < 0))[c]
            out[c][idx] = torch.where(pec, src[c][idx], val)
    assert all(int(n.min()) == 1 and int(n.max()) == 1 for n in count)
    return tuple(o[0] if one else o for o in out)


def _setup(shape, lanes, seed, eta_lanes):
    """Random complex64 streams and a random float32 level (η per lane
    if ``eta_lanes``) from a numpy seed."""
    rng = np.random.default_rng(seed)
    lead = (lanes,) if lanes > 1 else ()

    def cplx(sh, scale=1.0):
        return (scale * (rng.normal(size=sh) + 1j * rng.normal(size=sh))
                ).astype(np.complex64)
    eta = tuple(cplx(((lanes,) if eta_lanes else ()) + shape)
                for _ in range(3))
    par = (*eta, rng.uniform(0.5, 2.0, shape).astype(np.float32),
           *(rng.uniform(50.0, 150.0, n).astype(np.float32)
             for n in shape))
    edges = tp.edge_shapes(shape)
    hi = tuple(cplx(lead + sh) for sh in edges)
    lo = tuple(cplx(lead + sh, 1e-7) for sh in edges)
    s = tuple(cplx(lead + sh) for sh in edges)
    return par, hi, lo, s


# (shape, lanes, η per lane, chunk): the plan's own chunk (None) and
# chunks that end inside the level; 16 and 64 rows/columns reach the
# extra index row/column, 37×23×19 partial tiles both ways, 37×23×45 a
# partial z tile after a full one.
EMULATION_CASES = (((12, 10, 8), 1, False, None),
                   ((12, 10, 8), 1, False, 5),
                   ((9, 16, 64), 2, True, 4),
                   ((37, 23, 19), 1, False, None),
                   ((37, 23, 45), 2, True, None),
                   ((5, 17, 33), 3, True, None))


@pytest.mark.parametrize('with_lo', [True, False])
@pytest.mark.parametrize('shape,lanes,eta_lanes,chunk', EMULATION_CASES)
def test_tiled_residual_bitwise(shape, lanes, eta_lanes, chunk, with_lo):
    par, hi, lo, s = _setup(shape, lanes, sum(shape) + lanes, eta_lanes)
    arrays = tuple(torch.tensor(a) for a in par)
    th, tl, ts = (tuple(torch.tensor(x) for x in g) for g in (hi, lo, s))
    tl = tl if with_lo else None
    params = dsres.ds_params(arrays)
    plan = dsres.tile_plan(shape, lanes, chunk=chunk)
    got = tiled_residual(th, tl, ts, params, plan)
    ref = dsres.residual_ds_plain(th, tl, ts, arrays, params)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    # The JAX package's double-single residual, lane by lane.
    for b in range(lanes):
        def pick(x):
            return x[b] if lanes > 1 else x
        jpar = tuple(jnp.asarray(a[b] if (i < 3 and eta_lanes) else a)
                     for i, a in enumerate(par))
        jout = j_residual_ds(tuple(jnp.asarray(pick(h)) for h in hi),
                             None if not with_lo else
                             tuple(jnp.asarray(pick(x)) for x in lo),
                             tuple(jnp.asarray(pick(x)) for x in s), jpar)
        mine = tuple(pick(g).numpy().astype(np.complex128) for g in got)
        assert tp.rel(mine, tuple(np.asarray(j).astype(np.complex128)
                                  for j in jout)) <= 1e-12


def test_entry_point_signature():
    """The C entry's parameters (pointers, then ints, then the stream)
    are those ctypes passes, and the plan's fields fill its ints."""
    import re
    from emg3d_tpu_torch.ops import _build
    text = (_build.CSRC / 'dsres.cu').read_text()
    sig = re.search(r'extern "C" int emg3d_residual_ds_c64\((.*?)\)',
                    text, re.S).group(1)
    kinds = [_build.ctypes.c_void_p if '*' in p else _build.ctypes.c_int
             for p in sig.split(',')]
    assert kinds == _build.ARGTYPES['emg3d_residual_ds_c64']
    assert len(kinds) == 21 + 11 + 1
    names = [p.split()[-1].lstrip('*') for p in sig.split(',')][21:-1]
    assert names == ['nx', 'ny', 'nz', 'lanes', 'st_lanes', 'tj', 'tk',
                     'chunk', 'blocks', 'threads', 'smem']
