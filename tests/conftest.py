"""Test configuration: run everything on CPU with 8 virtual devices.

Multi-device semantics without several accelerators: JAX's forced host
platform device count gives us 8 CPU devices, so Mesh/shard_map code paths
compile and execute with the same SPMD semantics they have across GPUs.
Kernels run in the Pallas interpreter here (core.platform.kernel_mode);
tests of code that runs only on the GPU carry the `gpu` marker and skip.
"""

import os

# RUSTEXP_TEST_GPU=1 keeps the default (GPU) platform for `pytest -m gpu`
# on a machine with a card; every other run is pinned to the CPU.
ON_GPU = os.environ.get("RUSTEXP_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

# The suite is XLA-compile dominated; the persistent compilation cache
# (core.platform: $JAX_COMPILATION_CACHE_DIR, else a fixed directory in the
# checkout keyed by the host's CPU features) makes warm runs much faster.
# The cache key includes the HLO, so stale hits are impossible.
import jax  # noqa: E402

from rustexp_tpu.core.platform import enable_compile_cache  # noqa: E402

enable_compile_cache()

if not ON_GPU:
    assert jax.default_backend() == "cpu", (
        f"tests must run on CPU, got {jax.default_backend()}")
    assert len(jax.devices()) == 8, (
        f"expected 8 virtual CPU devices, got {len(jax.devices())}")

import pytest  # noqa: E402

REFERENCE = "/root/reference"


@pytest.fixture(scope="session")
def reference_root():
    if not os.path.isdir(REFERENCE):
        pytest.skip("reference repo not available")
    return REFERENCE


@pytest.fixture
def gpu():
    """Skip unless a GPU is attached. Tests marked `gpu` run on the card
    with `RUSTEXP_TEST_GPU=1 python -m pytest tests/ -m gpu`."""
    if not any(d.platform == "gpu" for d in jax.devices()):
        pytest.skip("needs a GPU: the CUDA kernel has no interpret mode")
