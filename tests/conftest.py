"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-chip hardware is unavailable in CI; sharding logic is validated on
XLA's host-platform virtual devices (the standard JAX way to test N-device
logic, SURVEY.md §4d).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# The tests run on the CPU backend (the GPU path is exercised by
# chip_smoke.py on the card). jax.config wins over a JAX_PLATFORMS preset
# as long as no backend has been used yet.
import jax

jax.config.update("jax_platforms", "cpu")

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

REFERENCE_PLAYER = "/tmp/refplayer/iamfplayer"


@pytest.fixture(scope="session")
def ref_player():
    """Path to the reference iamfplayer binary (goldens), or skip."""
    if not os.path.exists(REFERENCE_PLAYER):
        pytest.skip("reference iamfplayer not built")
    return REFERENCE_PLAYER
