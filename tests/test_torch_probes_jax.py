"""The port's probes against the JAX package's Pallas probes themselves.

Each Pallas probe of ``scripts/`` is rebuilt here from its kernel body
(the script's lines cited; the scripts are not imported) at a small
size and run in interpret mode on the CPU, on inputs made with numpy
from a seed; the port's side is its wrapper on a CPU tensor, which
takes its plain version (the version the kernel is held to on the card,
chip_smoke.py phase 14), or for ``smem_limit``, which refuses a CPU
tensor, ``smem_limit_plain``.  All bitwise but ``station_solve``:

- ``probe_vmem`` (``hw_probe_ztile.py:193-221``): x[0] += 1 through a
  VMEM scratch, against ``smem_limit_plain``;
- ``fbuf5d`` (``hw_bisect_zp256.py:37-58``): Σ_{i<chx} f[i, 3], against
  ``smem_sum``;
- ``rolllane``/``rollsub`` (:60-72): against ``tile_roll``, shift 1;
- ``dynslice``, ``dynslice_al``, ``dynslice_al12`` (:74-118): the last
  grid step's ``buf[0, 0, :ty]``, against ``dyn_slice`` at the probe's
  first rows;
- ``probe`` at z alignment 120 and ``probe12`` (``hw_probe_ztile.py:
  29-65, 153-191``): copy +1 of one sub-box a grid step, in place,
  against ``tile_copy`` applied to ``chip_smoke.probe_boxes()``'s boxes
  in order.  Their grid steps overlap, and the probes alias x to their
  output: on the TPU a step reads what the steps before it wrote.  The
  generic interpreter (``interpret=True``) reads an aliased input as it
  came, so overlaps would count once; these two run in the TPU
  interpret mode (``pltpu.InterpretParams()``), which simulates HBM and
  its DMAs, aliasing included.  The others run with ``interpret=True``.
- ``station`` (:120-148): packed LDLᵀ factors and a right-hand side as
  float pairs, solved with ``emg3d_tpu.ops.blocksolve.
  ldl_solve_factored`` (n = 5) into Σ_i (re z_i + im z_i); the same
  inputs go through ``ldl_solve_factored`` on complex64 ``jnp`` arrays,
  the probe's own split-pair arithmetic (``cx.C2``) and
  ``probes.station_solve``: z within 1e-6 of max|z|, and the probe's sum
  within ten times that (ten terms).
"""
import numpy as np
import pytest
import torch

pytest.importorskip('jax')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import chip_smoke  # noqa: E402
from emg3d_tpu import cx  # noqa: E402
from emg3d_tpu.ops.blocksolve import ldl_solve_factored  # noqa: E402
from emg3d_tpu_torch.ops import probes  # noqa: E402

TOL = 1e-6
F32 = jnp.float32


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _hbm_call(kernel, shape, scratch, grid=(1,), interpret=True):
    """A probe of hw_probe_ztile.py: x in HBM, aliased to the output,
    copied through ``scratch`` with one DMA semaphore."""
    return pl.pallas_call(
        kernel, grid=grid,
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        out_shape=jax.ShapeDtypeStruct(shape, F32),
        scratch_shapes=[pltpu.VMEM(scratch, F32), pltpu.SemaphoreType.DMA],
        input_output_aliases={0: 0}, interpret=interpret)


# -- probe_vmem, hw_probe_ztile.py:193-221 ---------------------------------

def _probe_vmem(x):
    def kernel(x_hbm, o_hbm, buf, sem):
        cp = pltpu.make_async_copy(x_hbm.at[pl.ds(0, 8)],
                                   buf.at[pl.ds(0, 8)], sem)
        cp.start()
        cp.wait()
        buf[0] = buf[0] + 1.0
        cp2 = pltpu.make_async_copy(buf.at[pl.ds(0, 8)],
                                    o_hbm.at[pl.ds(0, 8)], sem)
        cp2.start()
        cp2.wait()
    return np.asarray(_hbm_call(kernel, x.shape, x.shape)(jnp.asarray(x)))


@pytest.mark.parametrize('rows', [8, 16, 64])
def test_smem_limit_against_probe_vmem(rows):
    x = _rand((rows, 512), rows)
    ref = _probe_vmem(x)
    ours = probes.smem_limit_plain(torch.tensor(x)).numpy()
    assert np.array_equal(ours, ref)
    assert not np.array_equal(ref[0], x[0]) and \
        np.array_equal(ref[1:], x[1:])


# -- fbuf5d, hw_bisect_zp256.py:37-58 --------------------------------------

@pytest.mark.parametrize('nx, nf, ty, zp, chx', [(10, 5, 8, 16, 8),
                                                 (6, 4, 3, 12, 5)])
def test_smem_sum_against_fbuf5d(nx, nf, ty, zp, chx):
    def kern(f_hbm, o_ref, fbuf, sems):
        cp = pltpu.make_async_copy(
            f_hbm.at[pl.ds(0, chx)], fbuf.at[0], sems.at[0])
        cp.start()
        cp.wait()
        acc = jnp.zeros((ty, zp), F32)

        def body(i, acc):
            return acc + fbuf[0, i, 3]
        acc = lax.fori_loop(0, chx, body, acc)
        o_ref[:] = acc

    call = pl.pallas_call(
        kern,
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((ty, zp), F32),
        scratch_shapes=[pltpu.VMEM((2, chx, nf, ty, zp), F32),
                        pltpu.SemaphoreType.DMA((2,))],
        interpret=True)
    f = _rand((nx, nf, ty, zp), 7 + nx)
    ref = np.asarray(call(jnp.asarray(f)))
    ours = probes.smem_sum(torch.tensor(f), chx, 3).numpy()
    assert np.array_equal(ours, ref)


# -- rolllane / rollsub, hw_bisect_zp256.py:60-72 --------------------------

@pytest.mark.parametrize('shape', [(8, 256), (5, 12)])
@pytest.mark.parametrize('ax', [1, 0], ids=['rolllane', 'rollsub'])
def test_tile_roll_against_roll(shape, ax):
    def kern(x_ref, o_ref):
        o_ref[:] = pltpu.roll(x_ref[:], 1, ax)

    call = pl.pallas_call(
        kern,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(shape, F32),
        interpret=True)
    x = _rand(shape, 11)
    ref = np.asarray(call(jnp.asarray(x)))
    ours = probes.tile_roll(torch.tensor(x), 1, ax).numpy()
    assert np.array_equal(ours, ref)


# -- dynslice, dynslice_al, dynslice_al12, hw_bisect_zp256.py:74-118 -------

TY_OUT = 8      # the probes' ty: the rows of their output


@pytest.mark.parametrize('case', ['dynslice', 'dynslice_al',
                                  'dynslice_al12'])
def test_dyn_slice_against_dynslice(case):
    """At NXP 3 and Zp 16 (the probe's 66 and 256), its grid of 4 and
    row counts 72 / 48; the probe keeps its last grid step's rows."""
    nxp, zp = 3, 16
    if case == 'dynslice':
        ny, TY = 72, TY_OUT
        starts = [min(max(t * (TY_OUT - 2), 0), ny - TY) for t in range(4)]
    else:
        ny, TY = 48, 16 if case == 'dynslice_al' else 12
        starts = [t * 8 for t in range(4)]

    def kern(x_hbm, o_ref, buf, sems):
        t = pl.program_id(0)
        if case == 'dynslice':
            y0 = jnp.clip(t * (TY_OUT - 2), 0, ny - TY)
        else:
            y0 = t * 8
        cp = pltpu.make_async_copy(
            x_hbm.at[:, :, pl.ds(y0, TY)], buf, sems.at[0])
        cp.start()
        cp.wait()
        o_ref[:] = buf[0, 0, :TY_OUT]

    call = pl.pallas_call(
        kern,
        grid=(4,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((TY_OUT, zp), F32),
        scratch_shapes=[pltpu.VMEM((6, nxp, TY, zp), F32),
                        pltpu.SemaphoreType.DMA((2,))],
        interpret=True)
    x = _rand((6, nxp, ny, zp), 13)
    ref = np.asarray(call(jnp.asarray(x)))
    y0 = torch.tensor(starts, dtype=torch.int32)
    ours = probes.dyn_slice(torch.tensor(x), y0, TY)[-1, 0, 0, :TY_OUT]
    assert np.array_equal(ours.numpy(), ref)


# -- probe (z 120) and probe12, hw_probe_ztile.py:29-65, 153-191 -----------

def _probe_z(x, tz, align):
    def kernel(x_hbm, o_hbm, buf, sem):
        t = pl.program_id(0)
        z0 = t * align
        cp = pltpu.make_async_copy(
            x_hbm.at[:, :, :, pl.ds(z0, tz)], buf, sem)
        cp.start()
        cp.wait()
        buf[...] = buf[...] + 1.0
        cp2 = pltpu.make_async_copy(
            buf, o_hbm.at[:, :, :, pl.ds(z0, tz)], sem)
        cp2.start()
        cp2.wait()

    ntz = (x.shape[3] - tz) // align + 1
    return _hbm_call(kernel, x.shape, x.shape[:3] + (tz,), (ntz,),
                     pltpu.InterpretParams())(jnp.asarray(x))


def _probe12(x, tyl=64, XL=6):
    nf, NXP, Yp, Zp = x.shape

    def kernel(x_hbm, o_hbm, buf, sem):
        t = pl.program_id(0)
        yt = pl.program_id(1)
        x0 = jnp.clip(t * (XL - 2) - 1, 0, NXP - XL)
        y0 = yt * (tyl - 8)
        cp = pltpu.make_async_copy(
            x_hbm.at[:, pl.ds(x0, XL), pl.ds(y0, tyl)], buf, sem)
        cp.start()
        cp.wait()
        buf[...] = buf[...] + 1.0
        cp2 = pltpu.make_async_copy(
            buf, o_hbm.at[:, pl.ds(x0, XL), pl.ds(y0, tyl)], sem)
        cp2.start()
        cp2.wait()

    ntx = -(-(NXP - 2) // (XL - 2))
    nyt = (Yp - tyl) // (tyl - 8) + 1
    return _hbm_call(kernel, x.shape, (nf, XL, tyl, Zp), (ntx, nyt),
                     pltpu.InterpretParams())(jnp.asarray(x))


@pytest.mark.parametrize('case, small', [
    ('probe z 120', {0: 2, 1: 3, 2: 4}),     # nf, nx, ny (6, 20, 32)
    ('probe12', {0: 1, 3: 8})])               # nf (6) and Zp (384)
def test_tile_copy_against_probes(case, small):
    """``case``'s array cut along the dims every one of its boxes spans
    whole (``small``: dim → length); the dims its grid steps cut keep
    probe_boxes()'s extents, so each grid step is one of its boxes."""
    shape, boxes = chip_smoke.probe_boxes()[case]
    for d in small:
        assert all(o[d] == 0 and n[d] == shape[d] for o, n in boxes)
    shape = tuple(small.get(d, n) for d, n in enumerate(shape))
    boxes = [(o, tuple(small.get(d, k) for d, k in enumerate(n)))
             for o, n in boxes]
    x = _rand(shape, 17)
    if case == 'probe12':
        ref = _probe12(x)
    else:
        ref = _probe_z(x, 128, 120)
    ours = torch.tensor(x)
    for off, ln in boxes:
        probes.tile_copy(ours, off, ln)
    assert np.array_equal(ours.numpy(), np.asarray(ref))
    assert (ours.numpy() - x).max() >= 2.0      # overlaps count twice


# -- station, hw_bisect_zp256.py:120-148 -----------------------------------

def _inputs(tile, seed):
    """chip_smoke.station_inputs in numpy: |L| ≤ 0.2, dinv of modulus
    0.5-1, right-hand sides in [-1, 1]."""
    rng = np.random.default_rng(seed)
    x = np.empty((40,) + tile, dtype=np.float32)
    x[0:20] = rng.uniform(-0.2, 0.2, (20,) + tile)
    ang = rng.uniform(-0.5, 0.5, (5,) + tile)
    mod = rng.uniform(0.5, 1.0, (5,) + tile)
    x[20:30:2], x[21:30:2] = mod * np.cos(ang), mod * np.sin(ang)
    x[30:40] = rng.uniform(-1, 1, (10,) + tile)
    return x


def _factors(entry):
    """The probe's unpacking: L (strict lower, row-major), dinv, y."""
    L, k = {}, 0
    for i in range(1, 5):
        for j in range(i):
            L[(i, j)] = entry(k)
            k += 1
    return L, [entry(10 + i) for i in range(5)], \
        [entry(15 + i) for i in range(5)]


@pytest.mark.parametrize('tile, seed', [((8, 256), 0), ((5, 7), 1),
                                        ((3, 64), 2)])
def test_station_solve_against_jax(tile, seed):
    x = _inputs(tile, seed)
    z = probes.station_solve(torch.tensor(x)).numpy()
    zc = z[0::2] + 1j * z[1::2]
    scale = np.max(np.abs(z))
    c = jnp.asarray((x[0::2] + 1j * x[1::2]).astype(np.complex64))
    ref = np.stack([np.asarray(v) for v in
                    ldl_solve_factored(5, *_factors(lambda i: c[i]))])
    assert ref.dtype == np.complex64
    assert np.max(np.abs(zc - ref)) <= TOL * scale
    # The probe's own output, in its split-pair arithmetic.
    xj = jnp.asarray(x)
    pairs = ldl_solve_factored(
        5, *_factors(lambda i: cx.C2(xj[2 * i], xj[2 * i + 1])))
    out = np.asarray(sum((v.re + v.im) for v in pairs))
    ours = sum(z[2 * i] + z[2 * i + 1] for i in range(5))
    assert out.shape == tile
    assert np.max(np.abs(ours - out)) <= 10 * TOL * scale
