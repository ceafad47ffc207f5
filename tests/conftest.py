import os
import sys

# tests import shared helpers; make the tests dir importable
sys.path.insert(0, os.path.dirname(__file__))

# NOTE: no XLA_FLAGS here on purpose — smoke tests/benches must see exactly
# 1 device.  Multi-device tests go through helpers.run_multidevice.


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skips without one")
