import os
import sys

import pytest

# src layout without install
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# NOTE: do NOT set --xla_force_host_platform_device_count here — tests and
# benches must see the 1-CPU default; only launch/dryrun.py forces 512.

# Tier-1 split: the two KD parity suites dominate the ~8-min wall clock;
# they (plus anything explicitly @pytest.mark.slow, e.g. the K=4 overlap
# parity matrix) run on main only, while the PR gate selects `-m quick`.
# Every un-slow test is auto-marked quick so `-m quick` == "not slow".
SLOW_FILES = {"test_kd_pipeline.py", "test_engine_parity.py"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (a CUDA kernel has no CPU mode); "
        "the test skips itself where torch.cuda.is_available() is false")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.fspath.basename in SLOW_FILES:
            item.add_marker(pytest.mark.slow)
        if "slow" not in item.keywords:
            item.add_marker(pytest.mark.quick)
