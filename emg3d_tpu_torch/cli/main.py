"""argparse front-end for the CLI.

Copy of ``emg3d_tpu/cli/main.py`` (the reference's emg3d/cli/main.py)
with the same flags:
positional config (default emg3d.cfg), -n/--nproc, mutually exclusive
-f/-m/-g, --path/--survey/--model/--output, -v/-q/--verbosity,
-d/--dry-run, --report, --version.  The solves run on CUDA unless the
config file's ``[solver_opts]`` has ``device = cpu``.
"""
import argparse
import sys

from .. import __version__
from . import run


def main(args=None):
    """Entry point for the ``emg3d-tpu-torch`` console script."""
    parser = argparse.ArgumentParser(
        description=(
            "Multigrid solver for 3D electromagnetic diffusion "
            "(PyTorch and CUDA). The CLI is driven by a configuration file "
            "(default: 'emg3d.cfg')."),
        prog='emg3d-tpu-torch',
    )

    parser.add_argument(
        'config', nargs='?', default='emg3d.cfg', type=str,
        help="name of config file; default is 'emg3d.cfg'; use '.' for "
             "no config file")
    parser.add_argument(
        '-n', '--nproc', type=int, default=None,
        help="number of processes (API parity; solves run on the card)")

    group = parser.add_mutually_exclusive_group()
    group.add_argument('-f', '--forward', action='store_true',
                       help='compute forward model (default)')
    group.add_argument('-m', '--misfit', action='store_true',
                       help='compute misfit')
    group.add_argument('-g', '--gradient', action='store_true',
                       help='compute gradient')

    parser.add_argument('--path', type=str, default=None,
                        help='path (abs or rel); default is cwd')
    parser.add_argument('--survey', type=str, default=None,
                        help="input survey file; default is 'survey.h5'")
    parser.add_argument('--model', type=str, default=None,
                        help="input model file; default is 'model.h5'")
    parser.add_argument('--output', type=str, default=None,
                        help="output file; default is 'emg3d_out.h5'")

    vgroup = parser.add_mutually_exclusive_group()
    vgroup.add_argument('-v', '--verbose', action='count', default=0,
                        help='increase verbosity')
    vgroup.add_argument('-q', '--quiet', action='count', default=0,
                        help='decrease verbosity')
    parser.add_argument('--verbosity', type=int, default=None,
                        help=argparse.SUPPRESS)

    parser.add_argument('-d', '--dry-run', action='store_true',
                        help='only display what would have been done')
    parser.add_argument('--report', action='store_true',
                        help='show version report and exit')
    parser.add_argument('--version', action='store_true',
                        help='show version and exit')

    args_dict = vars(parser.parse_args(args))

    if args_dict.pop('version'):
        print(f"emg3d_tpu_torch v{__version__}")
        return

    if args_dict.pop('report'):
        from ..utils import Report
        print(Report())
        return

    verbosity = args_dict.pop('verbosity')
    if verbosity is None:
        verbosity = args_dict['verbose'] - args_dict['quiet']
    args_dict.pop('verbose')
    args_dict.pop('quiet')
    args_dict['verbosity'] = verbosity

    run.simulation(args_dict)


if __name__ == '__main__':
    sys.exit(main())
