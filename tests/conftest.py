"""Test configuration: run on a virtual 8-device CPU mesh.

Mirrors the reference's strategy of exercising multi-rank topologies on one
box with `mpirun -n N` (SURVEY.md section 4.5): here multi-device sharding is
tested with XLA's host-platform device virtualization.

Unit tests run on the CPU unless JAX_PLATFORMS says otherwise; the
`gpu`-marked tests need a card and run with
`JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu`.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu")
    return devs[0]
