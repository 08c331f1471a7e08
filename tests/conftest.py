import os
import sys

# Tests run on a virtual 8-device CPU mesh so sharding paths are exercised
# without accelerators; bench.py, chip_smoke.py and production use the GPU.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))


def pytest_report_header(config):
    return f"jax devices: {jax.device_count()} ({jax.default_backend()})"
