import os
import sys

# Tests see the normal single CPU device (the 512-device override is ONLY
# for the dry-run); keep determinism and quiet logs.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: launches a CUDA kernel; skips without a CUDA device"
    )
