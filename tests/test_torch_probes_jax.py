"""``station_solve`` of the port against the JAX package itself.

The Pallas probe ``scripts/hw_bisect_zp256.py`` station (:115-134) reads
packed LDLᵀ factors and a right-hand side as float pairs, solves with
``emg3d_tpu.ops.blocksolve.ldl_solve_factored`` (n = 5) and writes
Σ_i (re z_i + im z_i).  Here the same inputs, made with numpy, go
through ``ldl_solve_factored`` on complex64 ``jnp`` arrays and through
the probe's own split-pair arithmetic (``cx.C2``), and through
``probes.station_solve`` on CPU tensors (its plain version, which the
kernel is held to on the card): z within 1e-6 of max|z|, and the
probe's sum within ten times that (ten terms).
"""
import numpy as np
import pytest
import torch

pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402

from emg3d_tpu import cx  # noqa: E402
from emg3d_tpu.ops.blocksolve import ldl_solve_factored  # noqa: E402
from emg3d_tpu_torch.ops import probes  # noqa: E402

TOL = 1e-6


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
