"""Command-line interface (console script ``emg3d-tpu-torch``)."""
from . import main, parser, run  # noqa: F401
