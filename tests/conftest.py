"""Test configuration: the CPU platform with 8 virtual devices.

The analogue of the reference's FakeThrustRTC trick (running "GPU" code
without a GPU, reference ``PySDM/backends/impl_thrust_rtc/test_helpers/``):
sharding/multi-device tests run on an emulated 8-device CPU mesh
(``xla_force_host_platform_device_count``), kernels run in interpret mode,
and all physics tests run in float64 for exactness. The platform is the
CPU unless ``JAX_PLATFORMS`` names another: the tests marked ``gpu`` need a
card and run with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips where JAX finds none)"
    )
