# NOTE (per the brief): no XLA_FLAGS / device-count overrides here — smoke
# tests and benches must see the real (1-device) CPU.  Only the dry-run
# launcher sets xla_force_host_platform_device_count, in its own process.


import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: subprocess compile tests (~20s each)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")


# Every XLA:CPU-compiled executable holds ~50 memory mappings (LLVM JIT
# code slabs), and a full tier-1 run compiles thousands of distinct
# traces in one process — enough to cross the kernel's vm.max_map_count
# ceiling (65530 by default), at which point mmap fails and the compiler
# segfaults mid-suite.  jax.clear_caches() releases the executables and
# their mappings, so drop the caches whenever the map count crosses a
# safety threshold: per-module granularity keeps trace reuse within a
# module (where almost all of it happens) while bounding cross-module
# accumulation well under the ceiling.

_MAP_LIMIT = 30_000  # no single module peaks above ~20k maps


def _map_count() -> int:
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:  # non-Linux: no visibility — rely on bigger limits
        return 0


@pytest.fixture(autouse=True, scope="module")
def _bound_compile_cache_maps():
    yield
    if _map_count() > _MAP_LIMIT:
        jax.clear_caches()
