"""Test configuration: run on a virtual 8-device CPU mesh.

Set platform/device-count env vars before jax initializes so sharding
tests exercise real multi-device code paths without accelerators.  Tests
marked ``gpu`` need the card: run them there with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``; elsewhere
they skip.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import sys  # noqa: E402
sys.path.insert(0, os.path.dirname(__file__))
