"""The line factor stack's station entries, its plain in-place
elimination (the plain version of the kernel K5), and the launch plans
of K5 and of the Thomas kernel K4.

- ``pack_line_entries`` holds the JAX package's station entries
  (``_line_entries_x``) at their planes; ``factor_line_stack_`` on it
  equals the dict-based elimination (``block_tridiag_factor_entries``
  on the same entries) bit for bit, and the JAX package's factors plane
  by plane at rel 1e-12 (fp64; the complex division differs in the
  last bits).
- ``line_station_entries``, the same entries from the η sums, ζ weights
  and inverse widths K5 reads, in its formulas, equals
  ``pack_line_entries`` at rel 1e-15 and the JAX package's parity-split
  entries (``_line_entries_x_parity``) at rel 1e-12, padded lines and
  the ex-only last station included.
- The launch geometries at the test shapes, 64³, 256³ and every level
  of sclr64 and sclr256: threads, blocks, shared bytes within the
  card's 232,448 per block, and no block for a colour or a stack
  without lines; K4's forced plans (lines per block, z in shared or
  global memory) at 64³, 32×256² and 256³; K5's forced geometries.
- CPU tensors take the plain path without building the kernel library;
  the kernel entry points refuse CPU tensors.
"""
import pytest

pytest.importorskip('jax')

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import emg3d_tpu as jt  # noqa: E402
from emg3d_tpu.ops import smoothers as jsm  # noqa: E402
from emg3d_tpu.ops.blocksolve import block_tridiag_factor_entries  # noqa
from emg3d_tpu.ops.coeffs import node_coefficients  # noqa: E402
from emg3d_tpu.ops.pallas_lr import rotate_arrays  # noqa: E402

import chip_smoke  # noqa: E402
from emg3d_tpu_torch import convert, solver  # noqa: E402
from emg3d_tpu_torch.ops import _build, line_gs  # noqa: E402
from emg3d_tpu_torch.ops import blocksolve as pbs  # noqa: E402
from emg3d_tpu_torch.ops import smoothers as psm  # noqa: E402

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-12
SHAPES = [(3, 3, 3), (7, 5, 9), (9, 7, 9), (16, 8, 12)]
LARGE = [(64, 64, 64), (256, 256, 256)]


@jax.jit
def _j_factors(arrays):
    nx = arrays[0].shape[0]
    return block_tridiag_factor_entries(
        5, *jsm._line_entries_x(node_coefficients(*arrays), nx))


def _rotated(shape, axis, seed):
    _, par = tp.level(jt, shape, seed=seed)
    ar = psm.rotate_arrays(convert.params_to_torch(par), axis)
    return par, ar, psm.rotate_shape(shape, axis)


@pytest.mark.parametrize('axis', [0, 1, 2])
@pytest.mark.parametrize('shape', SHAPES)
def test_packed_plain_elimination(shape, axis):
    par, ar, rs = _rotated(shape, axis, seed=sum(shape) + axis)
    rot = rotate_arrays(tp.to_jax(par), axis)
    D_j, B_j = jsm._line_entries_x(node_coefficients(*rot), rs[0])
    packed = psm.pack_line_entries(ar, rs)
    # The packed layout: D at its factor planes, zeros at the absent
    # (2, 1) and (4, 3), B as in the finished stack; padded lines carry
    # identity diagonals.
    L_p, d_p, B_p = convert.line_factors_to_numpy(packed, rs)
    for (a, b), v in D_j.items():
        got = d_p[a] if a == b else L_p[a * (a - 1) // 2 + b]
        assert tp.rel((got,), (np.broadcast_to(np.asarray(v), got.shape),)
                      ) < TOL
    assert not packed[:, 2].any() and not packed[:, 9].any()
    for k in psm.LINE_BKEYS:
        assert tp.rel((B_p[k],), (np.broadcast_to(np.asarray(B_j[k]),
                                                  B_p[k].shape),)) < TOL
    ny2, nz2 = rs[1] // 2, rs[2] // 2
    pad = torch.ones((2 * ny2, 2 * nz2), dtype=torch.bool)
    pad[:rs[1] - 1, :rs[2] - 1] = False
    pad = pad.reshape(ny2, 2, nz2, 2).permute(1, 3, 0, 2)
    assert torch.equal(packed[:, 10:15, pad], torch.ones_like(
        packed[:, 10:15, pad]))

    # The plain in-place elimination, against the dict-based one on the
    # same entries and against the JAX package's factors.
    Dent = {(a, b): packed[:, 10 + a if a == b else a * (a - 1) // 2 + b]
            .clone() for (a, b) in D_j}
    Bent = {k: packed[:, 15 + p].clone()
            for p, k in enumerate(psm.LINE_BKEYS)}
    ref = packed.clone()
    pbs.block_tridiag_factor_entries(5, Dent, Bent, out=ref[:, :15])
    fac = psm.factor_line_stack_(packed)
    assert fac is packed                                 # in place
    assert torch.equal(fac, ref)
    assert torch.equal(psm.line_factor_stack(ar, rs), fac)
    assert torch.equal(line_gs.line_factors(convert.params_to_torch(par),
                                            shape, axis), fac)

    L_j, d_j = _j_factors(rot)
    L_p, d_p, B_p = convert.line_factors_to_numpy(fac, rs)
    got = [*L_p, *d_p, *(B_p[k] for k in psm.LINE_BKEYS)]
    want = [*L_j, *d_j, *(B_j[k] for k in psm.LINE_BKEYS)]
    for n, (a, b) in enumerate(zip(got, want)):
        b = np.broadcast_to(np.asarray(b), a.shape)
        assert tp.rel((a,), (b,)) < TOL, f"plane {n}"


def _check_factor_geometry(shape):
    nx, ny, nz = shape
    g = line_gs.factor_geometry(shape)
    assert g.lines == 4 * (ny // 2) * (nz // 2)
    # One line per thread, blocks of one warp (the card's table).
    assert g.threads == line_gs.FACTOR_WARP == 32
    assert g.blocks * g.threads >= g.lines > (g.blocks - 1) * g.threads
    return g


@pytest.mark.parametrize('shape', SHAPES + LARGE)
def test_factor_geometry(shape):
    nx, ny, nz = shape
    _check_factor_geometry(shape)
    assert line_gs.factor_geometry((nx, 1, nz)) == (0, 0, 0)


@pytest.mark.parametrize('size', [64, 256])
def test_factor_geometry_sclr_levels(size):
    """Every line state of the sc+lr solve of a size³ fullspace (sclr64:
    27 states, 4-64 stations; sclr256: 39)."""
    states = chip_smoke.line_stack_shapes((size,) * 3)
    assert len(states) == {64: 27, 256: 39}[size]
    for shape, axis in states:
        rs = psm.rotate_shape(shape, axis)
        g = _check_factor_geometry(rs)
        assert g.blocks >= 1 and rs[0] >= 4


def test_forced_factor_geometry():
    """Larger blocks can be forced (the card's table of geometries);
    anything but a multiple of 32 up to FACTOR_THREADS is refused."""
    shape = (64, 64, 64)
    for threads in (32, 64, 128, 256):
        g = line_gs.factor_geometry(shape, threads)
        assert (g.threads, g.lines) == (threads, 4096)
        assert g.blocks * threads >= 4096 > (g.blocks - 1) * threads
    assert line_gs.factor_geometry(shape) == line_gs.factor_geometry(
        shape, line_gs.FACTOR_WARP)
    for bad in (0, 16, 48, 512):
        with pytest.raises(ValueError, match='threads per block'):
            line_gs.factor_geometry(shape, bad)


@pytest.mark.parametrize('axis', [0, 1, 2])
@pytest.mark.parametrize('shape', [(3, 3, 3), (7, 5, 9), (9, 7, 9),
                                   (8, 6, 4)])
def test_line_station_entries(shape, axis):
    """The packed entries from st, w and ih (K5's inputs and formulas)
    against the torch-op packing and the JAX package's entries, padded
    lines (identity diagonals) and the ex-only last station included."""
    par, ar, rs = _rotated(shape, axis, seed=sum(shape) + 2 * axis + 1)
    st = line_gs.line_state(convert.params_to_torch(par), shape, axis,
                            factors=False)
    got = psm.line_station_entries(st.st, st.w, st.ih, rs)
    packed = psm.pack_line_entries(ar, rs)
    assert tp.rel((got,), (packed,)) < 1e-15
    nx, ny, nz = rs
    ny2, nz2 = ny // 2, nz // 2
    rot = rotate_arrays(tp.to_jax(par), axis)
    D_j, B_j = jsm._line_entries_x_parity(node_coefficients(*rot), nx, ny2,
                                          nz2)
    for (a, b), v in D_j.items():
        p = 10 + a if a == b else a * (a - 1) // 2 + b
        assert tp.rel((got[:, p],), (np.asarray(v),)) < TOL, (a, b)
    for n, k in enumerate(psm.LINE_BKEYS):
        assert tp.rel((got[:, 15 + n],), (np.asarray(B_j[k]),)) < TOL, k
    assert not got[:, 2].any() and not got[:, 9].any()   # absent D
    assert torch.equal(got[-1, 11:15], torch.ones_like(got[-1, 11:15]))
    # Padded lines (an odd count of interior nodes across: (8, 6, 4)):
    # identity diagonals, nothing else.
    pad = torch.ones((2 * ny2, 2 * nz2), dtype=torch.bool)
    pad[:ny - 1, :nz - 1] = False
    pad = pad.reshape(ny2, 2, nz2, 2).permute(1, 3, 0, 2)
    assert bool(pad.any()) == (shape == (8, 6, 4))
    assert torch.equal(got[:, 10:15, pad], torch.ones_like(
        got[:, 10:15, pad]))
    assert not got[:, :10, pad].any() and not got[:, 15:, pad].any()


@pytest.mark.parametrize('shape', SHAPES + LARGE + [(2, 2, 2), (5, 2, 3)])
def test_thomas_geometry(shape):
    nx, ny, nz = shape
    for color in range(4):
        g = line_gs.launch_geometry(shape, color)
        total = g.counts[0] * g.counts[1]
        if total == 0:
            assert (g.blocks, g.threads, g.smem_bytes) == (0, 0, 0)
            continue
        lpb = g.lines_per_block
        assert g.threads == line_gs.THOMAS_WARP == 32
        assert lpb in (1, 2, 4, 8, 16, 32)
        assert g.blocks * lpb >= total > (g.blocks - 1) * lpb
        # Ring of station slots (factors + r/e [+ z]), then z if on chip.
        planes = psm.NLINE + (5 if g.z_shared else 10)
        assert g.planes == planes
        zbytes = nx * 5 * lpb * 16 if g.z_shared else 0
        assert g.smem_bytes == (line_gs.THOMAS_STAGES * planes * lpb * 16
                                + zbytes)
        assert 0 < g.smem_bytes <= line_gs.SMEM_MAX == 232448
        if g.z_shared:
            assert g.smem_bytes <= line_gs.THOMAS_ZSHARED
    if shape == (64, 64, 64):
        # A colour fills the card (132 SMs) and keeps z on chip.
        gs = [line_gs.launch_geometry(shape, c) for c in range(4)]
        assert all(g.blocks >= 132 and g.z_shared for g in gs)
        assert gs[0].lines_per_block == 4
    if shape == (256, 256, 256):
        g = line_gs.launch_geometry(shape, 0)
        assert (g.blocks, g.lines_per_block, g.z_shared) == (512, 32, False)
    if shape == (2, 2, 2):
        # One interior line, of colour 0.
        assert [line_gs.launch_geometry(shape, c).blocks
                for c in range(4)] == [1, 0, 0, 0]


@pytest.mark.parametrize('shape', [(64, 64, 64), (32, 256, 256),
                                   (256, 256, 256)])
def test_forced_thomas_plans(shape):
    """Every lines-per-block choice with z in global memory, and with z
    in shared memory where it fits the block (else ValueError)."""
    nx = shape[0]
    auto = line_gs.launch_geometry(shape, 0)
    for lpb in (1, 2, 4, 8, 16, 32):
        g = line_gs.launch_geometry(shape, 0, lpb, False)
        assert (g.lines_per_block, g.z_shared) == (lpb, False)
        assert g.planes == psm.NLINE + 10
        assert g.smem_bytes == line_gs.THOMAS_STAGES * g.planes * lpb * 16
        assert g.counts == auto.counts
        assert g.blocks == -(-g.counts[0] * g.counts[1] // lpb)
        need = line_gs.THOMAS_STAGES * (psm.NLINE + 5) * lpb * 16 + (
            nx * 5 * lpb * 16)
        if need <= line_gs.SMEM_MAX:
            g = line_gs.launch_geometry(shape, 0, lpb, True)
            assert g.z_shared and g.smem_bytes == need
        else:
            with pytest.raises(ValueError, match='shared memory'):
                line_gs.launch_geometry(shape, 0, lpb, True)
        free = line_gs.launch_geometry(shape, 0, lpb)
        assert free.z_shared == (need <= line_gs.THOMAS_ZSHARED)
    assert auto == line_gs.launch_geometry(shape, 0, auto.lines_per_block,
                                           auto.z_shared)
    for bad in (0, 3, 64):
        with pytest.raises(ValueError, match='lines_per_block'):
            line_gs.launch_geometry(shape, 0, bad)


def test_cpu_plain_path_never_builds(monkeypatch):
    """CPU tensors take the plain elimination; no library, no count."""
    def boom():
        raise AssertionError("kernel library requested for CPU tensors")
    monkeypatch.setattr(_build, 'library', boom)
    line_gs.reset_launches()
    shape = (6, 5, 4)
    par, ar, rs = _rotated(shape, 1, seed=3)
    arrays = convert.params_to_torch(par)
    st = line_gs.line_state(arrays, shape, 1)
    assert torch.equal(st.factors, psm.line_factor_stack(ar, rs))
    monkeypatch.setattr(_build, 'PLAIN', True)
    plain = line_gs.line_state(arrays, shape, 1)
    assert torch.equal(plain.factors, st.factors)
    assert line_gs.line_state(arrays, shape, 1, factors=False).factors is None
    assert all(v == 0 for v in line_gs.LAUNCHES.values())


def test_factor_refuses_cpu(monkeypatch):
    """K5's wrapper launches or raises: no plain path for CPU tensors."""
    def boom():
        raise AssertionError("kernel library requested for CPU tensors")
    monkeypatch.setattr(_build, 'library', boom)
    par, _, rs = _rotated((5, 4, 3), 0, seed=4)
    st = line_gs.line_state(convert.params_to_torch(par), (5, 4, 3), 0,
                            factors=False)
    with pytest.raises(ValueError, match='no line-relaxation kernel'):
        line_gs.factor(st.st, st.w, st.ih, rs)


def test_launch_counters():
    assert set(line_gs.LAUNCHES) == {'line_factor', 'line_residual',
                                     'line_thomas'}
    line_gs.LAUNCHES['line_factor'] = 3
    line_gs.reset_launches()
    assert line_gs.LAUNCHES['line_factor'] == 0
    names = {'emg3d_line_factor', 'emg3d_line_residual',
             'emg3d_line_thomas'}
    assert names <= set(_build.ARGTYPES)
    # K4: 8 pointers and the lane table, 16 ints (shape, stations,
    # colour, plan, launch, lanes), the stream.
    assert len(_build.ARGTYPES['emg3d_line_thomas']) == 26
    # K5: the stack and 9 parameter pointers, shape, stations, launch,
    # the stream.
    assert len(_build.ARGTYPES['emg3d_line_factor']) == 17


@pytest.mark.parametrize('plain', [False, True])
def test_solver_line_state_mode(monkeypatch, plain):
    """Under the override (``_build.PLAIN``) the solver's stacks are built
    with the plain elimination; without it, with K5 where the tensors
    run kernels (here every tensor, as on the card)."""
    _, par = tp.level(jt, (4, 4, 4), seed=9)
    arrays = convert.params_to_torch(par)
    want = line_gs.line_state(arrays, (4, 4, 4), 2).factors
    seen = []

    def k5(st, w, ih, rs, storage=None, out=None, stations=None):
        seen.append(tuple(rs))
        return want.clone()
    monkeypatch.setattr(line_gs, 'factor', k5)
    monkeypatch.setattr(_build, 'kernels', lambda x: not _build.PLAIN)
    monkeypatch.setattr(_build, 'PLAIN', plain)

    class Lev:
        pass
    lev = Lev()
    lev.arrays = arrays
    lev.shape = (4, 4, 4)
    lev.lstate = {}
    lev.meter = {'bytes': 0}
    lev.lanes = None
    lev.bf16 = False
    st = solver._line_state(lev, 2)
    assert torch.equal(st.factors, want)
    assert seen == ([] if plain else [(4, 4, 4)])
    assert solver._line_state(lev, 2) is st              # built once
