"""Keep each test process under the kernel's limit on memory mappings.

Every XLA:CPU executable that JAX holds in its jit caches keeps memory
mappings of its own, about a thousand for one of the sparse engine's tick
loops. tests/conftest.py releases them at the end of each module, but a
module that compiles many programs (tests/test_sparse.py) can pass the
kernel's ``vm.max_map_count`` (65530 by default) within one process, and
the next mapping then fails inside XLA with a segfault or an abort that
takes the process, and with it a pytest-xdist worker, down. After each
test, once the process holds more than half of the limit, JAX's caches are
cleared early, as they are at a module's end. The jit caching that a test
relies on within itself is untouched.

This conftest imports no JAX: tests/conftest.py must set ``XLA_FLAGS``
before the first ``import jax``.
"""

import sys

import pytest


def _read_map_limit() -> int | None:
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return None


_MAP_LIMIT = _read_map_limit()


def _map_count() -> int:
    try:
        with open("/proc/self/maps", "rb") as f:
            return f.read().count(b"\n")
    except OSError:
        return 0


@pytest.fixture(autouse=True)
def _bound_memory_mappings():
    yield
    jax = sys.modules.get("jax")
    if jax is not None and _MAP_LIMIT is not None and _map_count() > _MAP_LIMIT // 2:
        jax.clear_caches()
