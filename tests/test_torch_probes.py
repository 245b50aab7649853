"""The probes' plain versions (``emg3d_tpu_torch.ops.probes``) on the CPU.

The kernels of ``csrc/probes.cu`` run on the card only (chip_smoke.py,
phase 14, holds each against these plain versions); here the wrappers
take their plain versions for CPU tensors, and the plain versions are
held to what the Pallas probes compute: a copy +1 of a sub-box, x[0]
+= 1 (``smem_limit``'s plain version; its wrapper refuses a CPU tensor:
whether the card admits a size only the card says), a sum over
stations, ``torch.roll``, a clamped dynamic slice and the 5×5
complex-symmetric LDLᵀ substitution of the JAX package's
``blocksolve.ldl_solve_factored``.  The kernels' plans are held here
too: ``tile_copy``'s boxes walked as its persistent blocks take them
(every element of the sub-box gets +1 once, nothing else, no box past
the map's z end, the ring within the card's shared memory),
``smem_limit``'s layout of its shared-memory buffer (``smem_plan``),
``tile_roll``'s index map, evaluated in torch, against ``torch.roll``,
``smem_sum``'s boxes walked the same way (every output stored once, the
stations summed in order: bitwise the plain sum) and
``station_solve``'s thread→points map (every point once).
"""
import re

import numpy as np
import pytest
import torch

import chip_smoke
from emg3d_tpu_torch.ops import _build, probes

torch.set_num_threads(1)

SMEM_OPTIN = 232448      # the H100's opt-in shared memory per block
SMEM_SM = 228 * 1024     # and per SM (1 KB of it reserved per block)
SMEM_STAGED = 8 * 512 * 4    # probe_vmem's 8 staged rows of 512 floats


def test_tile_copy_boxes():
    """Overlapping boxes at odd offsets count every cover, as the Pallas
    probes' in-place grid does."""
    x = torch.zeros((2, 3, 4, 16))
    boxes = [((0, 0, 0, 3 * t), (2, 3, 4, 8)) for t in range(3)] + \
        [((1, 1, 2, 5), (1, 2, 2, 11))]
    for off, ln in boxes:
        assert probes.tile_copy(x, off, ln) is x
    cover = np.zeros(x.shape)
    for off, ln in boxes:
        cover[tuple(slice(o, o + n) for o, n in zip(off, ln))] += 1
    assert np.array_equal(x.numpy(), cover)
    with pytest.raises(ValueError, match='outside'):
        probes.tile_copy(x, (0, 0, 0, 10), (1, 1, 1, 8))
    with pytest.raises(ValueError, match='float32'):
        probes.tile_copy(x.double(), (0, 0, 0, 0), (1, 1, 1, 1))


@pytest.mark.parametrize('lengths', [(6, 20, 32, 128), (4, 46, 16, 256),
                                     (6, 6, 64, 384), (1, 1, 3, 7),
                                     (300, 1, 1, 1)])
def test_tile_box(lengths):
    """TMA boxes: ≤ 256 a dim, 16-byte rows, within TILE_BYTES, and no
    larger than the sub-box (but for rows rounded up to 4)."""
    box = probes.tile_box(lengths)
    assert box[3] % 4 == 0 and max(box) <= 256
    assert 4 * int(np.prod(box)) <= probes.TILE_BYTES
    assert all(b <= n for b, n in zip(box[:3], lengths[:3]))
    assert (-(-lengths[3] // 4) * 4) % box[3] == 0


@pytest.mark.parametrize('offset, length', [(0, 128), (13, 128), (3, 1),
                                            (250, 6), (8, 120)])
def test_tile_span(offset, length):
    """The z span of a box: 16-byte aligned ends around the sub-box's."""
    size = 256
    span = probes.tile_span(offset, length, size)
    start = offset // 4 * 4
    assert span % 4 == 0 and start % 4 == 0
    assert start <= offset and offset + length <= start + span <= size


def _tile_cases():
    """(name, array shape, sub-boxes): probe12's timed box, every
    probe_boxes() case, the whole probe3 array and a sub-box of it at z
    offset 13 (chip_smoke.py phase 14's cases)."""
    cases = chip_smoke.probe_boxes()
    shape12, boxes12 = cases['probe12']
    yield 'probe12 box', shape12, [boxes12[5]]
    yield from ((k, sh, b) for k, (sh, b) in cases.items())
    full = (32, 46, 64, 384)
    yield 'probe3 whole', full, [((0, 0, 0, 0), full)]
    yield 'offset 13', full, [((1, 1, 3, 13), (30, 44, 60, 360))]


def _tile_walk(shape, off, ln, plan):
    """The kernel's walk of ``plan`` in torch: per block its run of
    boxes, each moved once (``moved``, over the tensor map's region from
    the first corner) and +1 where the kernel adds it (``added``)."""
    a3 = off[3] // 4 * 4
    e3 = min(shape[3], -(-(off[3] + ln[3]) // 4) * 4)
    start = (*off[:3], a3)
    end = tuple(o + n for o, n in zip(off[:3], ln[:3])) + (e3,)
    region = tuple(e - s for s, e in zip(start, end))
    moved = torch.zeros(region, dtype=torch.uint8)
    added = torch.zeros(region, dtype=torch.uint8)
    n0, n1, n2, n3 = plan.counts
    boxes = n0 * n1 * n2 * n3
    lo3, hi3 = off[3], off[3] + ln[3]
    for b in range(plan.blocks):
        run = range(b, boxes, plan.blocks)
        assert plan.stages >= 2 or len(run) <= 1
        for t in run:
            t, t3 = divmod(t, n3)
            t, t2 = divmod(t, n2)
            t0, t1 = divmod(t, n1)
            c = [s + i * bx for s, i, bx in zip(start, (t0, t1, t2, t3),
                                                 plan.box)]
            assert c[3] + plan.box[3] <= e3          # never past z's end
            sl = [slice(ci - s, min(ci + bx, e) - s) for ci, bx, s, e in
                  zip(c, plan.box, start, end)]
            moved[tuple(sl)] += 1
            if not (c[3] >= lo3 and c[3] + plan.box[3] <= hi3):
                sl[3] = slice(max(c[3], lo3) - a3,
                              min(c[3] + plan.box[3], hi3) - a3)
            added[tuple(sl)] += 1
    return moved, added, a3


@pytest.mark.parametrize('case', [c[0] for c in _tile_cases()])
def test_tile_plan_walk(case):
    """tile_copy's plan walked as its blocks take the boxes: every
    element of the sub-box gets +1 exactly once, nothing outside it
    does, every box moves a part of the map no other box moves, no z box
    reaches past the map's end, and the ring fits the card (the stages
    within one block's opt-in, two blocks on an SM)."""
    _, shape, subs = next(c for c in _tile_cases() if c[0] == case)
    for off, ln in subs:
        plan = probes.tile_plan(shape[3], off, ln, sms=132)
        box = plan.box
        assert box[3] % 4 == 0 and max(box) <= 256
        assert 4 * int(np.prod(box)) <= probes.TILE_BYTES
        assert 1 <= plan.stages <= probes.TILE_STAGES
        assert plan.blocks == min(int(np.prod(plan.counts)),
                                  probes.TILE_BLOCKS_PER_SM * 132)
        assert plan.smem <= SMEM_OPTIN
        assert probes.TILE_BLOCKS_PER_SM * (plan.smem + 1024) <= SMEM_SM
        moved, added, a3 = _tile_walk(shape, off, ln, plan)
        assert moved.min() == 1 and moved.max() == 1
        own = tuple(slice(0, n) for n in ln[:3]) + (
            slice(off[3] - a3, off[3] - a3 + ln[3]),)
        assert bool((added[own] == 1).all())
        added[own] = 0
        assert int(added.max()) == 0


def test_tile_box_probe12():
    """probe12's 384-float z span goes in two boxes of 192, none
    half-empty; its 6×6×64×384 box and the whole probe3 array fill
    every block of the grid (two per SM)."""
    plan = probes.tile_plan(384, (0, 3, 56, 0), (6, 6, 64, 384), sms=132)
    assert plan.box == (1, 1, 16, 192) and plan.counts == (6, 6, 4, 2)
    assert plan.blocks == 264 and plan.stages == 2
    large = probes.tile_plan(384, (0,) * 4, (32, 46, 64, 384), sms=132)
    assert large.blocks == 264 and large.stages == 3


def test_tile_copy_entry_signature():
    """The C entry's parameters are those ctypes passes: the tensor, its
    dims, offsets, lengths, the box, the ring's stages and the blocks,
    then the stream."""
    text = _build._sources('probes')[0].read_text()
    sig = re.search(r'extern "C" int emg3d_probe_tile_copy\((.*?)\)',
                    text, re.S).group(1)
    kinds = [_build.ctypes.c_void_p if '*' in p else _build.ctypes.c_int
             for p in sig.split(',')]
    assert kinds == _build.PROBE_ARGTYPES['emg3d_probe_tile_copy']
    names = [p.split()[-1].lstrip('*') for p in sig.split(',')]
    assert names[-3:] == ['stages', 'blocks', 'stream']


def test_smem_limit_plain():
    """probe_vmem's function: x[0] += 1 in place, the other rows as
    they came."""
    x = torch.randn((16, 512), generator=torch.Generator().manual_seed(3))
    x0 = x.clone()
    assert probes.smem_limit_plain(x) is x
    assert torch.equal(x[0], x0[0] + 1.0) and torch.equal(x[1:], x0[1:])


def _misaligned():
    return torch.zeros(8 * 512 + 1)[1:].view(8, 512)


@pytest.mark.parametrize('x, nbytes, match', [
    (lambda: torch.zeros((8, 512)), 48 * 1024, 'CUDA'),
    (lambda: torch.zeros((7, 512)), 48 * 1024, 'no kernel'),
    (lambda: torch.zeros((8, 256)), 48 * 1024, 'no kernel'),
    (_misaligned, 48 * 1024, 'no kernel'),
    (lambda: torch.zeros((512, 8)).T, 48 * 1024, 'contiguous'),
    (lambda: torch.zeros((8, 512), dtype=torch.float64), 48 * 1024,
     'float32'),
    (lambda: torch.zeros((8, 512)), SMEM_STAGED + 127, 'cannot hold')],
    ids=['cpu', 'rows', 'width', 'aligned', 'strided', 'dtype', 'nbytes'])
def test_smem_limit_refusals(x, nbytes, match):
    """The wrapper raises for what its kernel does not take, never
    handing it to the card as a launch error; a CPU tensor too (only
    the card can say whether it admits ``nbytes``)."""
    with pytest.raises(ValueError, match=match):
        probes.smem_limit(x(), nbytes)


@pytest.mark.parametrize('nbytes', [SMEM_STAGED + 128, 48 * 1024, 50001,
                                    160 * 1024, SMEM_OPTIN, SMEM_OPTIN + 16])
@pytest.mark.parametrize('pieces', [1, 8])
def test_smem_plan(nbytes, pieces):
    """csrc/probes.cu smem_stage's layout of ``nbytes``: the staged rows
    128-byte aligned at the buffer's top, the mbarriers below them, and
    the pieces' bulk copies covering x's first 16 384 bytes once, each
    16-byte aligned and a multiple of 16 bytes long."""
    plan = probes.smem_plan(nbytes, pieces)
    assert plan.pieces == pieces and plan.bars == 8 * pieces
    assert plan.offset % 128 == 0 and plan.bars <= plan.offset
    assert plan.offset + SMEM_STAGED <= nbytes < plan.offset + \
        SMEM_STAGED + 128
    use = np.zeros(nbytes, dtype=int)
    use[:plan.bars] += 1
    src = np.zeros(SMEM_STAGED, dtype=int)
    size = SMEM_STAGED // pieces
    for k in range(pieces):
        assert size % 16 == 0 and (plan.offset + k * size) % 16 == 0
        use[plan.offset + k * size:plan.offset + (k + 1) * size] += 1
        src[k * size:(k + 1) * size] += 1
    assert use.max() == 1 and use[plan.offset:].sum() == SMEM_STAGED
    assert (src == 1).all()


def test_smem_plan_refusals():
    assert probes.smem_plan(SMEM_STAGED + 128).offset == 128
    for nbytes in (0, SMEM_STAGED, SMEM_STAGED + 127):
        with pytest.raises(ValueError, match='cannot hold'):
            probes.smem_plan(nbytes)
    with pytest.raises(ValueError, match='pieces'):
        probes.smem_plan(48 * 1024, 2)
    assert probes.SMEM_PIECES in (1, 8)


def test_smem_sum():
    f = torch.randn((10, 46, 8, 16), generator=torch.Generator()
                    .manual_seed(2))
    out = probes.smem_sum(f, 8, 3)
    assert torch.equal(out, probes.smem_sum_plain(f, 8, 3))
    assert torch.allclose(out, f[:8, 3].sum(0), rtol=1e-6, atol=1e-6)
    # Zp must be a positive multiple of 4 (the map's 16-byte rows).
    for shape in ((10, 46, 8, 18), (10, 46, 8, 0)):
        with pytest.raises(ValueError, match='no kernel'):
            probes.smem_sum(torch.zeros(shape), 8, 3)
    with pytest.raises(ValueError, match='chx'):
        probes.smem_sum(f, 11, 3)


def _sum_walk(plan, chx, ty, zp, f=None, plane=0):
    """csrc/probes.cu smem_sum's walk of ``plan`` in torch: per block
    its run of output tiles (z fastest), each from its station chunks in
    order (a box past the map's end zero-filled), every output stored
    where the kernel stores it.  Returns (stores per output, the sums
    from ``f`` (nx, nf, ty, zp) or None)."""
    bz, by, bc = plan.box
    nz, ny, nc = plan.counts
    tiles = nz * ny
    stores = torch.zeros((ty, zp), dtype=torch.int32)
    out = None if f is None else torch.full((ty, zp), float('nan'))
    if f is not None:      # the map's view, zero past its ends
        pad = torch.zeros((nc * bc, ny * by, nz * bz))
        pad[:chx, :ty, :zp] = f[:chx, plane]
    for b in range(plan.blocks):
        run = range(b, tiles, plan.blocks)
        assert plan.stages >= 2 or len(run) * nc <= 1
        for t in run:
            z, y = t % nz * bz, t // nz * by
            acc = torch.zeros((by, bz))
            for c in range(0, nc * bc, bc):
                for i in range(min(bc, chx - c)):
                    if f is not None:
                        acc = acc + pad[c + i, y:y + by, z:z + bz]
            h, w = min(by, ty - y), min(bz, zp - z)
            stores[y:y + h, z:z + w] += 1
            if f is not None:
                out[y:y + h, z:z + w] = acc[:h, :w]
    return stores, out


SUM_CASES = {'probe': chip_smoke.SUM_PROBE, 'large': chip_smoke.SUM_LARGE,
             'odd': chip_smoke.SUM_ODD, 'one station': ((2, 1, 3, 4), 1, 0),
             'three chunks': ((600, 2, 3, 12), 513, 1)}


@pytest.mark.parametrize('case', list(SUM_CASES))
def test_sum_plan_walk(case):
    """smem_sum's plan walked as its blocks take the boxes: every output
    stored exactly once; TMA boxes (≤ 256 a dim, 16-byte rows) of at
    most one float4 a thread, within SUM_BYTES where the stations allow;
    the ring within one block's opt-in and two blocks an SM; stations
    in chunks of at most 256, summed in order: the walk's sums equal the
    plain version's bit for bit (all but the 3 GB large case)."""
    shape, chx, plane = SUM_CASES[case]
    ty, zp = shape[2:]
    plan = probes.sum_plan(chx, ty, zp, sms=132)
    bz, by, bc = plan.box
    assert bz % 4 == 0 and max(plan.box) <= 256 and bc <= probes.SUM_CHUNK
    assert by * bz <= 4 * probes.SUM_THREADS
    assert 4 * bz * by * bc <= max(probes.SUM_BYTES, 16 * bc)
    assert by <= ty and bz <= zp and bc <= chx
    assert plan.counts[2] == -(-chx // probes.SUM_CHUNK)
    assert plan.blocks == min(plan.counts[0] * plan.counts[1],
                              probes.TILE_BLOCKS_PER_SM * 132)
    assert 1 <= plan.stages <= probes.SUM_STAGES
    assert plan.smem <= SMEM_OPTIN
    assert probes.TILE_BLOCKS_PER_SM * (plan.smem + 1024) <= SMEM_SM
    f = None
    if case != 'large':
        f = torch.tensor(np.random.default_rng(16).standard_normal(shape),
                         dtype=torch.float32)
    stores, out = _sum_walk(plan, chx, ty, zp, f, plane)
    assert stores.min() == 1 and stores.max() == 1
    if f is not None:
        assert torch.equal(out, probes.smem_sum_plain(f, chx, plane))


def test_sum_plan_shapes():
    """The probe's sum goes in four 16 KB boxes of (256, 2, 8), one a
    block; SUM_LARGE's in 4096, 264 blocks (two an SM) with a 3-stage
    ring; 300 stations in two chunks of 150."""
    plan = probes.sum_plan(8, 8, 256, sms=132)
    assert plan.box == (256, 2, 8) and plan.counts == (1, 4, 1)
    assert plan.blocks == 4 and plan.stages == 1
    large = probes.sum_plan(8, 256, 8192, sms=132)
    assert large.box == (256, 2, 8) and large.counts == (32, 128, 1)
    assert large.blocks == 264 and large.stages == 3
    assert probes.sum_plan(300, 5, 36).box[2] == 150


@pytest.mark.parametrize('axis', [0, 1])
def test_tile_roll(axis):
    x = torch.arange(8 * 64, dtype=torch.float32).reshape(8, 64)
    for shift in (1, 3, -5):
        assert torch.equal(probes.tile_roll(x, shift, axis),
                           torch.roll(x, shift, axis))


def _roll_gather(x, shift, axis):
    """csrc/probes.cu tile_roll's index map in torch: thread t writes
    flat outputs 4t .. 4t + 3, stepping its column and wrapping to the
    next row, each from x[(r − sr) mod rows, (c − sc) mod cols] with the
    shift reduced as the wrapper reduces it."""
    rows, cols = x.shape
    n = rows * cols
    s = int(shift) % x.shape[axis]
    sr, sc = (s, 0) if axis == 0 else (0, s)
    i = torch.arange(0, n, 4)
    r, c = i // cols, i % cols
    flat = x.reshape(-1)
    out = torch.empty(n, dtype=x.dtype)
    for k in range(4):
        live = i + k < n
        rs = torch.where(r >= sr, r - sr, r - sr + rows)
        cs = torch.where(c >= sc, c - sc, c - sc + cols)
        out[(i + k)[live]] = flat[(rs * cols + cs)[live]]
        c = c + 1
        wrap = c == cols
        c = torch.where(wrap, 0, c)
        r = torch.where(wrap, r + 1, r)
    return out.reshape(rows, cols)


@pytest.mark.parametrize('axis', [0, 1])
@pytest.mark.parametrize('shape', [(8, 256), (5, 1000), (46, 384), (3, 7)])
def test_roll_index_map(shape, axis):
    """The kernel's gather equals torch.roll bit for bit, at shapes the
    shuffle plans refused too."""
    x = torch.tensor(np.random.default_rng(15).standard_normal(shape),
                     dtype=torch.float32)
    rows, cols = shape
    for shift in (0, 1, -5, cols + 3, -(rows + 1)):
        assert torch.equal(_roll_gather(x, shift, axis),
                           torch.roll(x, shift, axis))


def test_dyn_slice():
    x = torch.randn((2, 3, 20, 8))
    y0 = torch.tensor([0, 6, 15, -2], dtype=torch.int32)
    out = probes.dyn_slice(x, y0, 8)
    assert out.shape == (4, 2, 3, 8, 8)
    for t, y in enumerate((0, 6, 12, 0)):          # clamped into range
        assert torch.equal(out[t], x[:, :, y:y + 8])


def _ldl_solve_factored(x):
    """blocksolve.ldl_solve_factored of the JAX package (n = 5), in
    numpy complex64 as the kernel computes it."""
    c = (x[0::2] + 1j * x[1::2]).astype(np.complex64)
    L, k = {}, 0
    for i in range(1, 5):
        for j in range(i):
            L[(i, j)] = c[k]
            k += 1
    y = [c[15 + i] for i in range(5)]
    for i in range(5):
        for k in range(i):
            y[i] = y[i] - L[(i, k)] * y[k]
    y = [y[i] * c[10 + i] for i in range(5)]
    for i in range(3, -1, -1):
        for k in range(i + 1, 5):
            y[i] = y[i] - L[(k, i)] * y[k]
    return np.stack([p for v in y for p in (v.real, v.imag)])


def test_station_solve():
    """The plain version (torch.linalg.solve in complex128) against the
    substitution in complex64: within 1e-6 of max|z|, the tolerance the
    kernel is held to on the card."""
    rng = np.random.default_rng(3)
    tile = (8, 32)
    x = np.empty((40,) + tile, dtype=np.float32)
    x[0:20] = rng.uniform(-0.2, 0.2, (20,) + tile)
    ang = rng.uniform(-0.5, 0.5, (5,) + tile)
    mod = rng.uniform(0.5, 1.0, (5,) + tile)
    x[20:30:2], x[21:30:2] = mod * np.cos(ang), mod * np.sin(ang)
    x[30:40] = rng.uniform(-1, 1, (10,) + tile)
    z = probes.station_solve(torch.tensor(x))
    assert z.dtype == torch.float32 and z.shape == (10,) + tile
    ref = _ldl_solve_factored(x)
    assert np.max(np.abs(z.numpy() - ref)) <= 1e-6 * np.max(np.abs(ref))
    with pytest.raises(ValueError, match='40 planes'):
        probes.station_solve(torch.zeros((38,) + tile))


def _station_walk(plan, points):
    """csrc/probes.cu station_solve's grid-stride walk: thread g of the
    grid takes groups g, g + G, ... of ``plan.vec`` points (G the grid's
    threads).  Returns the visits per point."""
    groups = points // plan.vec
    grid = plan.blocks * plan.threads
    visits = np.zeros(points, dtype=np.int64)
    for start in range(0, groups, grid):
        g = np.arange(start, min(start + grid, groups))
        for v in range(plan.vec):
            np.add.at(visits, g * plan.vec + v, 1)
    return visits


@pytest.mark.parametrize('per_sm', [None, 3])
@pytest.mark.parametrize('points', [2048, 64 * 65536, 5 * 1001, 1, 4, 7,
                                    4 * 128 * 132, 4 * 128 * 132 - 4,
                                    132 * 3 * 128 * 4 * 5 + 4])
def test_station_plan_walk(points, per_sm):
    """station_solve's thread→points map covers every point once: four
    points a thread where 4 divides the count and they fill a block an
    SM, one otherwise (and always where forced, as for an input off 16
    bytes).  By default one group a thread; with ``per_sm`` a grid of
    at most that many blocks an SM whose sweeps split the groups evenly:
    the last sweep leaves fewer threads idle than a block for each
    sweep."""
    sms = 132
    plan = probes.station_plan(points, sms=sms, per_sm=per_sm)
    assert plan.vec == (4 if points % 4 == 0 and
                        points >= 4 * probes.STATION_THREADS * sms else 1)
    assert plan.threads == probes.STATION_THREADS
    groups = points // plan.vec
    assert plan.vec * groups == points
    need = -(-groups // plan.threads)
    if per_sm is None:
        assert plan.blocks == need
    else:
        assert plan.blocks <= min(need, per_sm * sms)
    sweeps = -(-groups // (plan.blocks * plan.threads))
    assert sweeps * plan.blocks * plan.threads - groups < \
        sweeps * plan.threads
    visits = _station_walk(plan, points)
    assert visits.min() == 1 and visits.max() == 1
    odd = probes.station_plan(points, sms=sms, per_sm=per_sm, vec=1)
    assert odd.vec == 1 and (_station_walk(odd, points) == 1).all()


@pytest.mark.parametrize('entry, tail', [
    ('emg3d_probe_smem_limit', ['x', 'rows', 'nbytes', 'pieces',
                                'attr_err', 'stream']),
    ('emg3d_probe_smem_sum', ['bz', 'by', 'bc', 'stages', 'blocks',
                              'stream']),
    ('emg3d_probe_station_solve', ['points', 'vec', 'blocks', 'stream'])])
def test_probe_entry_signatures(entry, tail):
    """smem_limit's, smem_sum's and station_solve's C entries take their
    tensors, extents and plan: the parameters ctypes passes, in
    order."""
    text = _build._sources('probes')[0].read_text()
    sig = re.search(rf'extern "C" int {entry}\((.*?)\)', text,
                    re.S).group(1)
    kinds = [_build.ctypes.c_void_p if '*' in p else _build.ctypes.c_int
             for p in sig.split(',')]
    assert kinds == _build.PROBE_ARGTYPES[entry]
    names = [p.split()[-1].lstrip('*') for p in sig.split(',')]
    assert names[-len(tail):] == tail


def test_probe_library_apart():
    """The probes build into a library of their own: the solve library's
    sources and entry points hold none of them, and the probe library's
    entry points are those csrc/probes.cu defines."""
    import re
    from emg3d_tpu_torch.ops import _build
    assert [p.name for p in _build._sources('probes')] == ['probes.cu']
    assert 'probes.cu' not in [p.name for p in _build._sources()]
    assert not set(_build.ARGTYPES) & set(_build.PROBE_ARGTYPES)
    assert _build.LIBRARIES['solve'][0] != _build.LIBRARIES['probes'][0]
    text = _build._sources('probes')[0].read_text()
    defined = set(re.findall(r'extern "C" int (emg3d_\w+)\(', text))
    assert defined == set(_build.PROBE_ARGTYPES)
