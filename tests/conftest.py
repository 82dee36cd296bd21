"""Test configuration: the CPU backend with 8 virtual devices by default.

Multi-device sharding paths are validated on a virtual CPU mesh; tests
that only a GPU can run carry the ``gpu`` marker and skip elsewhere.
"""

import os
import sys

# the CPU unless the caller picked a platform, as
# ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` does on a GPU host
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
