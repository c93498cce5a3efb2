"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

Tests run on the CPU backend (with a virtual 8-device mesh for the
multi-device sharding tests) so they are hermetic and fast.  Tests marked
``gpu`` need an NVIDIA GPU and skip without one; run them on the card with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu

(``chip_smoke.py`` does).  The CPU default is only a default, so that
command can choose the card.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_max_isa" not in flags:
    # This jaxlib's XLA:CPU miscompiles some f64 kernels at AVX512/AMX:
    # flaky heap corruption -> segfaults at later allocation-heavy sites.
    # Deterministic A/B on the f64 SIFT conv
    # trigger: default ISA 3/6 crash, AVX2 cap 16/16 clean
    # (tools/repro_sift_segv.py, reports/sift_segv_r5.md).
    flags = (flags + " --xla_cpu_max_isa=AVX2").strip()
os.environ["XLA_FLAGS"] = flags

import jax

jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: the mapper's bucketed kernels compile
# once per machine, not once per test process.
from privacy_preserving_sfm_tpu.utils.jax_setup import (  # noqa: E402
    enable_persistent_cache,
)

# PPSFM_NO_CACHE=1 disables the persistent compile cache (isolation knob
# for cache-machinery faults; see reports/sift_segv_r5.md).
if os.environ.get("PPSFM_NO_CACHE") != "1":
    enable_persistent_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end test")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips on the CPU)")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests when JAX has no GPU.  Decided here, at
    run time, never at import: every xdist worker must collect the same
    tests."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU; JAX reports "
                        f"{jax.devices()[0].platform!r}")


# The full suite compiles many hundreds of XLA:CPU executables into one
# process; at a deterministic cumulative point (~145 tests in, crash
# position identical across cache/ISA/codegen-split configurations) the
# next compile segfaults inside jaxlib's backend_compile_and_load — the
# signature of LLVM ORC JIT code-memory/relocation exhaustion, not of any
# specific computation (every subset of the suite passes in isolation).
# Dropping executable references every N tests keeps the JIT arena
# bounded; the persistent compile cache makes the re-compiles cheap
# loads.  Evidence: reports/sift_segv_r5.md.
_CLEAR_EVERY = 40
_test_counter = [0]


def pytest_runtest_teardown(item, nextitem):
    _test_counter[0] += 1
    if _test_counter[0] % _CLEAR_EVERY == 0:
        import jax

        jax.clear_caches()
