import os
import sys

# Smoke tests / benches must see ONE device — the 512-device dry-run flag is
# set ONLY inside repro.launch.dryrun (see the system design notes).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


import pytest


@pytest.fixture(autouse=True, scope="module")
def _bound_live_executables():
    """Drop the global jit/pjit executable cache at module boundaries.

    Long single-process runs of the whole suite intermittently SIGSEGV
    inside XLA-CPU's ``backend_compile`` once hundreds of compiled
    executables are live (the crash site wanders between compile-heavy
    tests and reproduces on pre-quantization checkouts, so it is an XLA
    population/fragmentation issue, not a test bug). Bounding the live
    population per module keeps tier-1 (`pytest -x -q`, all ~450 tests in
    one process) off that cliff; the price is a smoke-model recompile per
    module, a few seconds each.
    """
    yield
    import jax
    jax.clear_caches()


def pytest_configure(config):
    # CI's fast lane runs `-m "not slow"`; the slow lane runs `-m slow`
    # (heavy hypothesis/property sweeps). Tier-1 (`pytest -x -q`) runs both.
    config.addinivalue_line(
        "markers", "slow: heavy property/fuzz sweeps (second CI lane)")
    config.addinivalue_line(
        "markers", "cache: paged-KV cache subsystem (allocator/prefix-index "
                   "property suite)")
    config.addinivalue_line(
        "markers", "chaos: fault-injection differential sweeps "
                   "(CI chaos lane)")
    config.addinivalue_line(
        "markers", "quant: quantized KV-cache cells (int8/fp8 divergence + "
                   "error-bound sweeps)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's kernels against their "
                   "plain versions)")
