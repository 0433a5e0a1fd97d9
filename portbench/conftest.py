"""pytest settings of the benchmark's own tests (``python -m pytest
portbench/tests``): the checkout's root on the path, and the ``card``
marker of tests that need a CUDA card."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (the `card` fixture skips "
        "without one)")
