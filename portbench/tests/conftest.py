"""Tests of the benchmark harness.  CPU tests run the harness at a tiny
size on the port's plain versions; tests marked ``card`` need a CUDA
device and skip without one (decided inside each test)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line('markers', 'card: needs a CUDA device; skips '
                            'without one')
