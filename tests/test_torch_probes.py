"""The probes' plain versions (``emg3d_tpu_torch.ops.probes``) on the CPU.

The kernels of ``csrc/probes.cu`` run on the card only (chip_smoke.py,
phase 14, holds each against these plain versions); here the wrappers
take their plain versions for CPU tensors, and the plain versions are
held to what the Pallas probes compute: a copy +1 of a sub-box, a sum
over stations, ``torch.roll``, a clamped dynamic slice and the 5×5
complex-symmetric LDLᵀ substitution of the JAX package's
``blocksolve.ldl_solve_factored``.
"""
import numpy as np
import pytest
import torch

from emg3d_tpu_torch.ops import probes

torch.set_num_threads(1)


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
    assert box[3] < lengths[3] + 4


@pytest.mark.parametrize('offset, length', [(0, 128), (13, 128), (3, 1),
                                            (250, 6), (8, 120)])
def test_tile_span(offset, length):
    """The z span of a box: 16-byte aligned ends around the sub-box's."""
    size = 256
    span = probes.tile_span(offset, length, size)
    start = offset // 4 * 4
    assert span % 4 == 0 and start % 4 == 0
    assert start <= offset and offset + length <= start + span <= size


def test_smem_checksum():
    for nbytes in (4, 1024, 232448):
        n = nbytes // 4
        words = (np.arange(n, dtype=np.uint64) * 2654435761) % 2**32
        assert probes.smem_checksum(nbytes) == int(words.sum() % 2**32)
    with pytest.raises(ValueError, match='CUDA'):
        probes.smem_limit(1024, device='cpu')


def test_smem_sum():
    f = torch.randn((10, 46, 8, 16), generator=torch.Generator()
                    .manual_seed(2))
    out = probes.smem_sum(f, 8, 3)
    assert torch.equal(out, probes.smem_sum_plain(f, 8, 3))
    assert torch.allclose(out, f[:8, 3].sum(0), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('axis', [0, 1])
def test_tile_roll(axis):
    x = torch.arange(8 * 64, dtype=torch.float32).reshape(8, 64)
    for shift in (1, 3, -5):
        assert torch.equal(probes.tile_roll(x, shift, axis),
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
