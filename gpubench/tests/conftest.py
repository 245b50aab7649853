"""The benchmark's own tests: ``python -m pytest gpubench/tests -q`` from
the repo root (the repo's ``pytest tests/`` does not collect them).
Tests marked ``cuda`` need the card and skip without one; each decides
inside the test."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
