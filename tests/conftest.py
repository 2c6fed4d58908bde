import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))   # _fixtures imports

try:  # the container has no hypothesis; fall back to the deterministic shim
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "_shims"))

import numpy as np
import pytest

from _fixtures import FakeClock, fake_clock, seeded_rng  # noqa: F401
from repro.core import LakeSpec, generate_lake, profile_lake


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs a CUDA kernel; skips (inside a fixture) on a "
                   "host without a CUDA card")


@pytest.fixture(scope="session")
def small_lake():
    # row budget large enough that observed cardinalities track vocabulary
    # sizes (K needs discriminative cardinalities — see DESIGN.md §5.4)
    return generate_lake(LakeSpec(n_domains=10, n_tables=24, row_budget=2048,
                                  rows_log_mean=6.8, coverage_range=(0.5, 1.0),
                                  gran_ratio=(4, 8), seed=7))


@pytest.fixture(scope="session")
def small_profiles(small_lake):
    return profile_lake(small_lake.batch)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
