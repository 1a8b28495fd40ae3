"""Test configuration: JAX on the CPU with 8 virtual devices.

The suite checks numerics and the multi-device sharding paths on a
simulated 8-device CPU mesh; device timings come from bench.py and
chip_smoke.py on the GPU.  Tests marked ``gpu`` need the card: each
decides inside the test whether one is present and skips otherwise.
Run them on a GPU host with ``python -m pytest tests/ -m gpu``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips when there is none")
