"""python -m emg3d_tpu_torch -> CLI."""
import sys

from .cli.main import main

if __name__ == '__main__':
    sys.exit(main())
