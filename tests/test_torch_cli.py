"""Port vs JAX package: the command line (``emg3d_tpu_torch.cli``).

The cases of tests/test_cli.py (defaults, config file, unknown keys,
dry run, forward, misfit, gradient, version and report) on the port,
with ``[solver_opts] device = cpu``; the forward and gradient outputs
equal the JAX CLI's on the same 8³ files within rel 1e-9.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip('jax')

import numpy as np  # noqa: E402
import torch  # noqa: E402

import emg3d_tpu as jt  # noqa: E402
from emg3d_tpu.cli import main as jcli  # noqa: E402

import emg3d_tpu_torch as pt  # noqa: E402
from emg3d_tpu_torch import io  # noqa: E402
from emg3d_tpu_torch.cli import main as cli_main  # noqa: E402
from emg3d_tpu_torch.cli import parser as cli_parser  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _default_args(config='emg3d.cfg', **over):
    args = {'config': config, 'nproc': None, 'forward': False,
            'misfit': False, 'gradient': False, 'path': None,
            'survey': None, 'model': None, 'output': None,
            'verbosity': 0, 'dry_run': False}
    args.update(over)
    return args


def test_parser_defaults(tmp_path):
    args = _default_args(config='.')
    args['path'] = str(tmp_path)
    cfg, term = cli_parser.parse_config_file(args)
    assert term['function'] == 'forward'
    assert cfg['files']['survey'].endswith('survey.h5')
    assert cfg['files']['model'].endswith('model.h5')
    assert cfg['files']['output'].endswith('emg3d_out.h5')
    assert cfg['files']['log'].endswith('emg3d_out.log')
    assert cfg['simulation_options']['name'] == 'emg3d_tpu_torch CLI run'
    assert 'solver_opts' not in cfg['simulation_options']


def test_parser_config_file(tmp_path):
    cfgfile = tmp_path / 'test.cfg'
    cfgfile.write_text(f"""
[files]
path = {tmp_path}
survey = mysurvey.npz
model = mymodel.npz
output = out.npz

[simulation]
max_workers = 2
gridding = same
name = My Test

[solver_opts]
sslsolver = False
semicoarsening = True
cycle = V
tol = 1e-5
maxit = 10
device = cpu

[data]
sources = Tx0
frequencies = 1.0

[gridding_opts]
frequency = 2.0
properties = 0.3, 1, 1, 1, 1, 0.3, 1e8
""")
    cfg, term = cli_parser.parse_config_file(
        _default_args(config=str(cfgfile)))
    assert cfg['files']['survey'].endswith('mysurvey.npz')
    sim = cfg['simulation_options']
    assert sim['max_workers'] == 2
    assert sim['gridding'] == 'same'
    assert sim['name'] == 'My Test'
    assert sim['solver_opts'] == {'sslsolver': False, 'semicoarsening': True,
                                  'cycle': 'V', 'tol': 1e-5, 'maxit': 10,
                                  'device': 'cpu'}
    assert cfg['data']['sources'] == ['Tx0']
    assert cfg['data']['frequencies'] == [1.0]
    assert sim['gridding_opts']['frequency'] == 2.0
    assert len(sim['gridding_opts']['properties']) == 7


def test_parser_unknown_keys(tmp_path):
    cfgfile = tmp_path / 'bad.cfg'
    cfgfile.write_text("[solver_opts]\nbogus = 1\n")
    with pytest.raises(TypeError, match='solver_opts'):
        cli_parser.parse_config_file(_default_args(config=str(cfgfile)))


CONFIG = """
[files]
path = {path}
survey = survey.npz
model = model.npz
output = out.npz

[simulation]
gridding = same

[solver_opts]
sslsolver = False
semicoarsening = False
linerelaxation = False
tol = 1e-3
{device}"""


def _files(tmp_path, pkg):
    """tests/test_cli.py's 8³ files, written by ``pkg``'s io, and a
    config file for it (the port's with ``device = cpu``)."""
    grid = pkg.TensorMesh([np.ones(8) * 400] * 3, origin=(0, 0, 0))
    model = pkg.Model(grid, 1.0, mapping='Conductivity')
    survey = pkg.Survey('CLI', (850, 1600, 1600, 0, 0),
                        (2350, 1600, 1600, 0, 0), 1.0,
                        noise_floor=1e-15, relative_error=0.05)
    pkg.io.save(str(tmp_path / 'survey.npz'), survey=survey)
    pkg.io.save(str(tmp_path / 'model.npz'), model=model, mesh=grid)
    cfgfile = tmp_path / 'emg3d.cfg'
    cfgfile.write_text(CONFIG.format(
        path=tmp_path, device='device = cpu\n' if pkg is pt else ''))
    return cfgfile


def _run(main, cfgfile, flag, seed=5):
    np.random.seed(seed)            # the forward task adds noise
    main([str(cfgfile), flag])
    return io.load(str(Path(cfgfile).parent / 'out.npz'))


def _observe(tmp_path, data, factor):
    survey = io.load(str(tmp_path / 'survey.npz'))['survey']
    survey.data.observed[:] = factor * np.asarray(data)
    io.save(str(tmp_path / 'survey.npz'), survey=survey)


def test_dry_run(tmp_path):
    out = _run(cli_main.main, _files(tmp_path, pt), '-d')
    assert np.all(out['data'] == 0)


def test_misfit(tmp_path):
    cfgfile = _files(tmp_path, pt)
    fwd = _run(cli_main.main, cfgfile, '-f')
    assert os.path.isfile(tmp_path / 'out.log')
    _observe(tmp_path, fwd['data'], 1.0)
    out = _run(cli_main.main, cfgfile, '-m')
    # Noisy observed data (std ~5 %): the misfit is O(1) per datum.
    assert 0 < float(out['misfit']) < 100
    assert int(out['n_observations']) == 1


def test_forward_and_gradient_match_jax(tmp_path):
    """The same 8³ files through both CLIs: forward data (with the same
    noise seed) and the gradient's data, misfit and gradient within rel
    1e-9."""
    outs = {}
    for name, pkg, main in (('jax', jt, jcli.main), ('torch', pt,
                                                     cli_main.main)):
        path = tmp_path / name
        path.mkdir()
        cfgfile = _files(path, pkg)
        fwd = _run(main, cfgfile, '-f')
        _observe(path, fwd['data'], 1.1)
        outs[name] = (fwd, _run(main, cfgfile, '-g'))
    (fj, gj), (fp, gp) = outs['jax'], outs['torch']
    for a, b in ((fp['data'], fj['data']), (gp['data'], gj['data']),
                 (gp['gradient'], gj['gradient'])):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.isfinite(a).all()
        assert np.max(np.abs(a - b)) / np.max(np.abs(b)) < 1e-9
    assert np.asarray(gp['gradient']).shape == (8, 8, 8)
    assert abs(float(gp['misfit']) - float(gj['misfit'])) < \
        1e-9 * abs(float(gj['misfit']))


def test_version_and_report(capsys):
    cli_main.main(['--version'])
    assert 'emg3d_tpu_torch v' in capsys.readouterr().out
    cli_main.main(['--report'])
    out = capsys.readouterr().out
    assert 'torch' in out and 'jax' not in out
    # python -m emg3d_tpu_torch
    run = subprocess.run([sys.executable, '-m', 'emg3d_tpu_torch',
                          '--version'], cwd=REPO, capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert run.returncode == 0
    assert run.stdout.startswith('emg3d_tpu_torch v')


def test_cli_defaults_to_cuda(tmp_path, monkeypatch):
    """Without ``device`` the CLI solves on CUDA, and raises where there
    is none."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfgfile = _files(tmp_path, pt)
    cfgfile.write_text(CONFIG.format(path=tmp_path, device=''))
    with pytest.raises(RuntimeError, match='CUDA'):
        cli_main.main([str(cfgfile), '-f'])
