"""The benchmark's own tests (run as ``python -m pytest portbench/tests``).

Tests that need a CUDA device carry the ``card`` marker and skip inside
the test when there is none."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips inside the test without")
