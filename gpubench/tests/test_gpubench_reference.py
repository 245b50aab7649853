"""The frozen reference against the port's own set-up, on the CPU."""
import ast
from pathlib import Path

import numpy as np
import pytest

import emg3d_tpu_torch as pt
from gpubench import reference

REF = Path(__file__).resolve().parents[1] / 'reference'
BANNED = {'jax', 'jaxlib', 'emg3d_tpu', 'emg3d_tpu_torch'}


def _problem(n, seed=1):
    rng = np.random.default_rng(seed)
    h = [100 * 1.05 ** np.abs(np.arange(n) - n / 2) for _ in range(3)]
    grid = pt.TensorMesh(h, origin=tuple(-w.sum() / 2 + o for w, o in
                                         zip(h, (10., -20., 30.))))
    rho = tuple(10 ** rng.uniform(-0.5, 1.5, (n, n, n)) for _ in range(3))
    return grid, rho


def _nodes(grid):
    return grid.nodes_x, grid.nodes_y, grid.nodes_z


@pytest.mark.parametrize('n', [8, 16])
def test_eta_zeta_equal_port(n):
    grid, rho = _problem(n)
    model = pt.Model(grid, *rho, mapping='Resistivity')
    sf = pt.get_source_field(grid, (13.3, -21.7, 48.1, 0, 0), 0.7)
    vm = pt.models.VolumeModel(grid, model, sf)
    eta, zeta = reference.eta_zeta(grid.h, rho, 0.7)
    for a, b in zip(eta, (vm.eta_x, vm.eta_y, vm.eta_z)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-15, atol=0)
    np.testing.assert_allclose(zeta, vm.zeta, rtol=1e-15, atol=0)


@pytest.mark.parametrize('n', [8, 16])
@pytest.mark.parametrize('src', [
    (13.3, -21.7, 48.1, 0, 0),            # inside one cell
    (0.0, 0.0, 0.0, 0, 0),                # on a node: crosses a plane
    (10.0, 5.0, -3.0, 30, 20),            # rotated point dipole
    (-310.0, 290.0, -45.0, 60.0, 5.0, 255.0),   # finite, many cells
])
def test_source_field_equal_port(n, src):
    grid, _ = _problem(n)
    sf = pt.get_source_field(grid, src, 1.3)
    s = reference.source_field(_nodes(grid), src, 1.3)
    scale = max(np.abs(np.asarray(c)).max() for c in (sf.fx, sf.fy, sf.fz))
    for a, b in zip(s, (sf.fx, sf.fy, sf.fz)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=1e-14 * scale)


@pytest.fixture(scope='module')
def solved():
    """A 16³ tri-axial stretched problem solved by the port (sc+lr
    BiCGSTAB, tol 1e-6) on the CPU."""
    grid, rho = _problem(16)
    model = pt.Model(grid, *rho, mapping='Resistivity')
    src = (13.3, -21.7, 48.1, 0, 0)
    sf = pt.get_source_field(grid, src, 0.7)
    e, info = pt.solve(grid, model, sf, device='cpu', return_info=True,
                       verb=0, semicoarsening=True, linerelaxation=True,
                       sslsolver=True)
    eta, zeta = reference.eta_zeta(grid.h, rho, 0.7)
    s = reference.source_field(_nodes(grid), src, 0.7)
    return grid, e, info, eta, zeta, s


def test_residual_of_converged_solve(solved):
    grid, e, info, eta, zeta, s = solved
    assert info['exit_message'] == 'CONVERGED'
    (rel,) = reference.relative_residuals([(e.fx, e.fy, e.fz)], [s], eta,
                                          zeta, grid.h)
    assert rel <= info['tol']
    # The same quantity the solver reports, to rounding.
    assert rel == pytest.approx(info['rel_error'], rel=1e-9)


def test_lower_precision_control_rejected(solved):
    """The solved field rounded to complex64 fails the tolerance that the
    complex128 field meets, and lies far from the residual the solve
    reported."""
    grid, e, info, eta, zeta, s = solved
    cast = [np.asarray(c).astype(np.complex64) for c in (e.fx, e.fy, e.fz)]
    (rel,) = reference.relative_residuals([cast], [s], eta, zeta, grid.h)
    assert rel > 2 * info['tol']
    assert abs(rel - info['rel_error']) > 1e3 * 1e-9


def test_residual_sees_a_wrong_operator(solved):
    """The reference's own numbers judge: another frequency's η, or a
    source one cell away, fails the same field."""
    grid, e, info, eta, zeta, s = solved
    f = (e.fx, e.fy, e.fz)
    eta2, _ = reference.eta_zeta(grid.h, (1.0, 1.0, 1.0), 0.7)
    s2 = reference.source_field(_nodes(grid), (113.3, -21.7, 48.1, 0, 0),
                                0.7)
    assert reference.relative_residuals([f], [s], eta2, zeta, grid.h)[0] \
        > 1e3 * info['tol']
    assert reference.relative_residuals([f], [s2], eta, zeta, grid.h)[0] \
        > 1e3 * info['tol']


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize('path', sorted(REF.glob('*.py')),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name in _imports(path):
        assert name.split('.')[0] not in BANNED, (path.name, name)


def test_reference_import_check_is_by_whole_name():
    assert 'emg3d_tpu_torch'.split('.')[0] != 'emg3d_tpu'
    assert 'emg3d_tpu.ops'.split('.')[0] in BANNED
