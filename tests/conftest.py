import os

# Tests run on the CPU with 8 virtual devices so sharding/collective code
# paths are exercised without accelerator hardware. Tests marked `gpu`
# need a card: chip_smoke.py runs them with JAX_PLATFORMS=cuda.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
if os.environ["JAX_PLATFORMS"] == "cpu":
    # the CPU reports no device memory limit: the capacity gates
    # (DeviceBackend._hbm_bytes) take an explicit budget
    os.environ.setdefault("MC_HBM_BYTES", str(16 << 30))

import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mapcaller import enable_compilation_cache

enable_compilation_cache()

import numpy as np
import pytest


REF_TEST_DIR = "/root/reference/test"


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless JAX's default backend is a GPU
    (decided per test, never at import time)."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax
        if jax.default_backend() != "gpu":
            pytest.skip("needs an NVIDIA GPU; run on the card with "
                        "`python chip_smoke.py`")


@pytest.fixture(scope="session")
def toy_fasta():
    return os.path.join(REF_TEST_DIR, "ref.fa")


@pytest.fixture(scope="session")
def toy_mut_fasta():
    return os.path.join(REF_TEST_DIR, "mut.fa")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


def random_genome(rng, n):
    return rng.integers(0, 4, size=n).astype(np.uint8)
