"""Test harness: CPU with a virtual 8-device mesh by default.

Must run before the first `import jax` anywhere in the test process.
PACMANN_TEST_PLATFORM=cuda runs the suite on the card instead; tests marked
`gpu` skip on any other backend (decided in a fixture, never at import).
"""

import os

import pytest

_platform = os.environ.get("PACMANN_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _platform
_flags = os.environ.get("XLA_FLAGS", "")
if _platform == "cpu" and "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", _platform)

from pacmann.utils.platform import backend, enable_compile_cache  # noqa: E402

# the bitsliced AES circuit is expensive to compile; cache it across runs
enable_compile_cache()


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless JAX's backend is the GPU."""
    if request.node.get_closest_marker("gpu") and backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "PACMANN_TEST_PLATFORM=cuda python -m pytest tests/ -m gpu")
