import os

# Tests run on a virtual 8-device CPU mesh so multi-device sharding paths
# are exercised without accelerator hardware.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# transformers must not pull TensorFlow/Flax into a process that already
# hosts jax+torch (TF+JAX in one process segfaults in libgcc unwinding —
# observed in full-suite runs once the parity tests import transformers)
os.environ.setdefault("USE_TF", "0")
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("TRANSFORMERS_NO_ADVISORY_WARNINGS", "1")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# Persistent XLA compile cache, in a per-host-fingerprint subdirectory of
# the default path (utils/compcache.py): warm runs are ~3-5x faster.  Cache
# read errors degrade to a miss inside jax (warning, not failure).  Opt out
# with MLIS_NO_TEST_CACHE=1.
if not os.environ.get("MLIS_NO_TEST_CACHE"):
    from mlimgsynth_tpu.utils.compcache import enable as _compcache_enable
    _compcache_enable(host_subdir=True)


# --- VMA-exhaustion guard -----------------------------------------------
# The recurring full-suite segfaults (5 so far) all die at the same IP in
# libgcc's unwinder, always ~65-70% through the run, in WHATEVER code
# happens to allocate there (XLA compile, cache serialize/deserialize) —
# and /proc/sys/vm/max_map_count is 65530.  Each compiled XLA:CPU
# executable holds several mappings and jit caches are never dropped, so
# a 400+-test run exhausts the VMA table and the next mmap-backed
# allocation crashes.  Two mitigations:
#   1. raise vm.max_map_count when we can (root container);
#   2. drop all jit caches every N tests (frees executables + mappings;
#      costs recompiles across test-file boundaries only).
try:
    with open("/proc/sys/vm/max_map_count", "w") as _f:
        _f.write("1048576")
except OSError:
    pass

_test_counter = {"n": 0}


def pytest_runtest_teardown(item, nextitem):
    _test_counter["n"] += 1
    if _test_counter["n"] % 30 == 0:
        import jax
        jax.clear_caches()
