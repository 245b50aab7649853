"""Port vs JAX package: the bfloat16 storage of the float32 solve.

The JAX package's Pallas path stores the smoothers' s/params streams in
bfloat16 in correction-form smoothing (``_smooth_spdt``) and every
line-factor stack above ``_FSTACK_CACHE_BYTES`` in bfloat16
(``_level_fstacks``); the port stores the same (``solver.BF16_STORAGE``,
``solver.FSTACK_BYTES``).  Inputs come from a seed with numpy
(tests/test_pallas_gs.py:_setup, tests/torch_parity.py) and reach both
packages through ``emg3d_tpu_torch.convert``:

- (a) the port's bfloat16 η sums, ζ weights and source are bit for bit
  the unpadded planes of the JAX package's ``pack_params(pdtype=)`` /
  ``pack_fields(sdtype=)``;
- (b) the point smoother (nu = 2) with bfloat16 streams: the port's
  plain K2 path against the JAX package's streaming kernel, its plain K1
  path against the resident kernel (both in interpret mode), within
  ``REL_ORDER`` (float32 accumulation order only), and at most a tenth
  as far from the JAX bfloat16 result as that is from the JAX float32
  one;
- (c) lines: the port's bfloat16 factor stack against
  ``line_factors(..., fdtype=jnp.bfloat16)`` (bitwise where the float32
  entries agree bitwise, else within one bfloat16 ulp); line relaxation
  on the JAX package's bfloat16 stack and bfloat16 streams against
  ``line_relaxation_pallas(..., _sp_dt=jnp.bfloat16)``, held as (b);
- (f) the bfloat16 entry points refuse CPU tensors, and mixed storage is
  refused; the byte accounting takes the storage size.

The solves, (d) and (e), are in tests/test_torch_bf16_solve.py (the JAX
package's compiles of both halves would hold one worker beyond 90 s).
"""
import pytest

pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import emg3d_tpu as jt  # noqa: E402
from emg3d_tpu import cx  # noqa: E402
from emg3d_tpu.ops import pallas_gs as jpg  # noqa: E402
from emg3d_tpu.ops.pallas_gs import gauss_seidel_point_pallas  # noqa: E402
from emg3d_tpu.ops.pallas_lr import (line_factors,  # noqa: E402
                                     line_relaxation_pallas)

from emg3d_tpu_torch import convert, dtypes  # noqa: E402
from emg3d_tpu_torch.ops import _build, line_gs, point_gs  # noqa: E402
from emg3d_tpu_torch.ops import smoothers as psm  # noqa: E402

import torch_parity as tp  # noqa: E402
from test_pallas_gs import _setup  # noqa: E402

torch.set_num_threads(1)

BF16 = dtypes.BF16
C64 = torch.complex64
SHAPE = (12, 10, 8)        # tests/test_pallas_gs.py's bfloat16 case
LINE_SHAPE = (12, 8, 8)    # tests/test_pallas_lr.py's
# The port's bfloat16 results against the JAX package's, max|Δ|/max|ref|:
# the same bfloat16 inputs, float32 arithmetic in another order.
REL_ORDER = 2e-5
# ... and at most this share of the JAX package's own bfloat16-vs-float32
# distance (‖·‖₂ over all components).
SHARE = 0.1


def _t(a):
    """A JAX split pair or float32 array as a complex64/float32 tensor."""
    if isinstance(a, cx.C2):
        return torch.tensor(np.asarray(cx.tocomplex(a)), dtype=C64)
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _np(fields):
    return [np.asarray(cx.tocomplex(f)) if isinstance(f, cx.C2)
            else f.detach().numpy() for f in fields]


def _norm(a, b):
    return np.sqrt(sum(np.linalg.norm(x - y) ** 2 for x, y in zip(a, b)))


def _held(port, jax_bf, jax_f32):
    """(b)'s two conditions; returns the readings."""
    port, jax_bf, jax_f32 = _np(port), _np(jax_bf), _np(jax_f32)
    rel = tp.rel(port, jax_bf)
    share = _norm(port, jax_bf) / _norm(jax_bf, jax_f32)
    assert rel < REL_ORDER, rel
    assert share <= SHARE, share
    return rel, share


def _bits(t):
    """The bit patterns of a bfloat16 tensor or JAX array (uint16)."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


# ----------------------------------------------------------------------
# (a) stored planes
# ----------------------------------------------------------------------

def test_stored_planes_bitwise():
    e, s, par = _setup(SHAPE, seed=6)
    pstack = jpg.pack_params(par, SHAPE, pdtype=jnp.bfloat16)[0]
    sstack = jpg.pack_fields(e, s, SHAPE, sdtype=jnp.bfloat16)[1]
    assert pstack.dtype == sstack.dtype == jnp.bfloat16
    state = point_gs.point_state(tuple(_t(a) for a in par), SHAPE,
                                 factored=False, storage=BF16)
    assert state.storage is BF16
    # pack_params' offsets (r0, j0, k0) of stx, sty, stz, and of w.
    offs = ((0, 1, 1), (1, 0, 1), (1, 1, 0))
    for c, (st, (r0, j0, k0)) in enumerate(zip(state.st, offs)):
        X, A, B = st.shape[:3]
        sl = (slice(r0, r0 + X), slice(j0, j0 + A), slice(k0, k0 + B))
        for part in range(2):
            assert np.array_equal(_bits(st[..., part]),
                                  _bits(pstack[2 * c + part][sl]))
    for c, w in enumerate(state.w):
        X, A, B = w.shape
        assert np.array_equal(_bits(w), _bits(pstack[6 + c][:X, :A, :B]))
    for c, f in enumerate(s):
        sb = dtypes.to_storage(_t(f), BF16)
        X, A, B = sb.shape[:3]
        for part in range(2):
            assert np.array_equal(_bits(sb[..., part]),
                                  _bits(sstack[2 * c + part][:X, :A, :B]))
    # The inverse widths stay float32 (pack_params' 1/h arrays).
    assert all(t.dtype == torch.float32 for t in state.ih)


# ----------------------------------------------------------------------
# (b) point smoother
# ----------------------------------------------------------------------

def _jax_point(e, s, par, sp_dt, resident):
    shape = SHAPE
    if resident:
        return gauss_seidel_point_pallas(e, s, par, nu=2, shape=shape,
                                         interpret=True, _sp_dt=sp_dt)
    try:
        jpg._RESIDENT_OFF.add(shape)
        gauss_seidel_point_pallas.clear_cache()
        return gauss_seidel_point_pallas(e, s, par, nu=2, shape=shape,
                                         interpret=True, _sp_dt=sp_dt)
    finally:
        jpg._RESIDENT_OFF.discard(shape)
        gauss_seidel_point_pallas.clear_cache()


@pytest.mark.parametrize('mode', ['fused', 'factored'])
def test_point_matches_jax_bf16(mode):
    """K2's plain path against the streaming kernel, K1's against the
    resident one (whose factors are float32 at this size, as the port
    keeps them)."""
    e, s, par = _setup(SHAPE, seed=6)
    resident = mode == 'factored'
    if resident:
        assert jpg._resident_plan(SHAPE, sp_bytes=2)[2] is None
    ref_bf = _jax_point(e, s, par, jnp.bfloat16, resident)
    ref_32 = _jax_point(e, s, par, None, resident)
    state = point_gs.point_state(tuple(_t(a) for a in par), SHAPE,
                                 factored=resident, storage=BF16)
    out = tuple(_t(a) for a in e)
    point_gs.gauss_seidel_point(out, tuple(_t(a) for a in s), state, 2,
                                _mode=mode)
    _held(out, ref_bf, ref_32)


# ----------------------------------------------------------------------
# (c) lines
# ----------------------------------------------------------------------

def _ulp_bf16(x):
    """The spacing of bfloat16 values at |x| (8 significant bits)."""
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize('axis', [0, 1])
def test_factor_stack_matches_jax_bf16(axis):
    _, _, par = _setup(LINE_SHAPE, seed=9)
    rs = psm.rotate_shape(LINE_SHAPE, axis)
    jf32 = np.asarray(line_factors(par, LINE_SHAPE, axis))
    jbf = np.asarray(line_factors(par, LINE_SHAPE, axis,
                                  fdtype=jnp.bfloat16)).astype(np.float32)
    ours = psm.line_factor_stack(psm.rotate_arrays(
        tuple(_t(a) for a in par), axis), rs)
    ours_bf = dtypes.to_storage(ours, BF16)
    theirs = convert.line_factors_to_torch(
        *convert.line_stack_entries(jf32, rs)).to(C64)
    theirs_bf = convert.line_factors_to_torch(
        *convert.line_stack_entries(jbf, rs), storage=BF16)
    a32 = torch.view_as_real(ours).numpy()
    b32 = torch.view_as_real(theirs).numpy()
    same = a32.view(np.uint32) == b32.view(np.uint32)
    abf, bbf = ours_bf.float().numpy(), theirs_bf.float().numpy()
    assert np.array_equal(_bits(ours_bf)[same], _bits(theirs_bf)[same])
    # Elsewhere (the last stations, where the elimination cancels, put
    # the two packages' float32 entries apart by up to a few bfloat16
    # ulps of a component much smaller than its entry): within one ulp of
    # the float32 entries' own distance.
    diff = np.abs(abf - bbf)
    ulp = _ulp_bf16(np.maximum(np.abs(abf), np.abs(bbf)))
    # The readings ROADMAP §3 records (pytest -s shows them).
    print(f"\naxis {axis}: float32 components bitwise equal {same.mean():.4f}"
          f", bfloat16 components apart {int((abf != bbf).sum())} of "
          f"{abf.size}, by more than one ulp {int((diff > ulp).sum())}")
    assert np.all(diff <= np.abs(a32 - b32) + ulp)
    assert same.mean() > 0.5


@pytest.mark.parametrize('axis', [0, 1])
def test_line_relaxation_matches_jax_bf16(axis):
    e, s, par = _setup(LINE_SHAPE, seed=8)
    rs = psm.rotate_shape(LINE_SHAPE, axis)
    fbf = line_factors(par, LINE_SHAPE, axis, fdtype=jnp.bfloat16)
    f32 = line_factors(par, LINE_SHAPE, axis)
    ref_bf = line_relaxation_pallas(e, s, par, nu=2, shape=LINE_SHAPE,
                                    axis=axis, fstack=fbf, interpret=True,
                                    _sp_dt=jnp.bfloat16)
    ref_32 = line_relaxation_pallas(e, s, par, nu=2, shape=LINE_SHAPE,
                                    axis=axis, fstack=f32, interpret=True)
    stack = convert.line_factors_to_torch(
        *convert.line_stack_entries(np.asarray(fbf).astype(np.float32), rs),
        storage=BF16)
    state = line_gs.line_state(tuple(_t(a) for a in par), LINE_SHAPE, axis,
                               storage=BF16, fstorage=BF16, stack=stack)
    assert state.factors is stack and state.st[0].dtype == BF16
    out = tuple(_t(a) for a in e)
    line_gs.line_relaxation(out, tuple(_t(a) for a in s), state, 2)
    _held(out, ref_bf, ref_32)


# ----------------------------------------------------------------------
# (f) refusals and byte accounting
# ----------------------------------------------------------------------

def _level(shape, seed, dtype=C64):
    _, par = tp.level(jt, shape, seed=seed)
    return convert.params_to_torch(par, dtype=dtype)


def test_bf16_entry_points_refuse_cpu_and_mixed_storage():
    shape = (6, 6, 6)
    par = _level(shape, 5)
    e = tuple(torch.zeros(sh, dtype=C64) for sh in tp.edge_shapes(shape))
    ls = line_gs.line_state(par, shape, 0, storage=BF16, fstorage=BF16)
    assert ls.factors.dtype == BF16 and ls.factors.shape[-1] == 2
    with pytest.raises(ValueError, match='no line-relaxation kernel'):
        line_gs.factor(*line_gs._params(ls.arrays)[:2], ls.ih, ls.shape,
                       storage=BF16)
    with pytest.raises(ValueError, match='no line-relaxation kernel'):
        line_gs.residual(e, tuple(dtypes.to_storage(t, BF16) for t in e),
                         ls, 0, e)
    with pytest.raises(ValueError, match='no line-relaxation kernel'):
        line_gs.thomas(e, e, ls.factors, ls, 0)
    # Every kernel has its bfloat16 entry point, and only complex64 takes
    # it: a bfloat16 request never runs another instance.
    for name in ('emg3d_point_gs_step', 'emg3d_point_gs_sweep',
                 'emg3d_point_gs_grid_capacity', 'emg3d_line_residual',
                 'emg3d_line_thomas', 'emg3d_line_factor'):
        assert _build.ARGTYPES[name + _build.BF16] == _build.ARGTYPES[name]
        src = 'point_gs.cu' if 'point' in name else 'line_gs.cu'
        assert f'extern "C" int {name}_bf16(' in \
            (_build.CSRC / src).read_text()
        with pytest.raises(ValueError, match='bfloat16 storage'):
            _build.entry(name, torch.complex128, BF16)
        with pytest.raises(ValueError, match='bfloat16 storage'):
            _build.entry(name, C64, torch.float16)
    # Mixed storage: refused on every device.
    ps = point_gs.point_state(par, shape, storage=BF16)
    point_gs.gauss_seidel_point(_clone(e), e, ps, 1)        # consistent
    with pytest.raises(ValueError, match='state'):
        point_gs.gauss_seidel_point(_clone(e), e, ps._replace(
            w=tuple(t.float() for t in ps.w)), 1)
    with pytest.raises(ValueError, match='expected'):
        point_gs.gauss_seidel_point(_clone(e), e,
                                    ps._replace(storage=None), 1)
    with pytest.raises(ValueError, match='complex64'):
        point_gs.point_state(_level(shape, 5, torch.complex128), shape,
                             storage=BF16)
    line_gs.line_relaxation(_clone(e), e, ls, 1)            # consistent
    f32 = psm.line_factor_stack(ls.arrays, ls.shape)
    for bad, msg in ((ls._replace(factors=f32), 'factors'),
                     (ls._replace(w=tuple(dtypes.from_storage(t)
                                          for t in ls.w)), 'w:'),
                     (ls._replace(storage=None), 'st:')):
        with pytest.raises(ValueError, match=msg):
            line_gs.line_relaxation(_clone(e), e, bad, 1)
    with pytest.raises(ValueError, match='batched'):
        line_gs.line_state(tuple(t.unsqueeze(0) if i < 3 else t
                                 for i, t in enumerate(par)), shape, 0,
                           lanes=torch.zeros(1, dtype=torch.int32),
                           storage=BF16)


def _clone(f):
    return tuple(t.clone() for t in f)


@pytest.mark.parametrize('shape', [(8, 8, 8), (64, 64, 64), (256,) * 3])
def test_byte_accounting_at_storage_size(shape):
    for axis in range(3):
        assert 2 * line_gs.factor_bytes(shape, axis, C64, BF16) == \
            line_gs.factor_bytes(shape, axis, C64)
    nx, ny, nz = shape
    edges = sum(np.prod(sh) for sh in tp.edge_shapes(shape))
    faces = (nx + 1) * ny * nz + nx * (ny + 1) * nz + nx * ny * (nz + 1)
    sums = (nx * (ny - 1) * (nz - 1) + (nx - 1) * ny * (nz - 1)
            + (nx - 1) * (ny - 1) * nz)
    for kernel in point_gs.KERNELS:
        # s and the η sums at 4 B a complex value, ζ weights at 2 B.
        assert point_gs._shared_bytes(shape, kernel, C64) - \
            point_gs._shared_bytes(shape, kernel, C64, BF16) == \
            4 * (edges + sums) + 2 * faces
    rs = psm.rotate_shape(shape, 1)
    for color in range(4):
        for lpb in (1, 2, 4, 8, 16, 32):
            g = line_gs.launch_geometry(rs, color, lines_per_block=lpb,
                                        z_shared=False, dtype=C64)
            gb = line_gs.launch_geometry(rs, color, lines_per_block=lpb,
                                         z_shared=False, dtype=C64,
                                         fstorage=BF16)
            if g.blocks == 0:
                continue
            slot = line_gs._slot_bytes(gb.planes, lpb, 8, 4)
            assert slot % 8 == 0
            assert gb.smem_bytes == line_gs.THOMAS_STAGES * slot
            assert g.smem_bytes - gb.smem_bytes == line_gs.THOMAS_STAGES * (
                psm.NLINE * lpb * 8 - (-(-psm.NLINE * lpb * 4 // 8) * 8))
