"""Test configuration: the CPU backend with 8 virtual devices.

Multi-device sharding tests run on fake CPU devices (the renderer's
analogue of multi-node tests without a cluster — SURVEY.md §4.4).
Must run before jax initializes a backend.

JAX_PLATFORMS=cpu is the default here.  Tests marked ``gpu``
(tests/test_gpu_gate.py) skip on the CPU from a fixture; run them on the
card with JAX_PLATFORMS=cuda, or through ``python chip_smoke.py``, which
calls pytest in its own (already GPU-initialized) process.
"""

import os
import sys

from jax._src import xla_bridge

# a pytest run inside a process whose backend already started (the chip
# smoke script) keeps that backend; a standalone run uses the CPU
if not xla_bridge.backends_are_initialized():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
CPU_MODE = os.environ.get("JAX_PLATFORMS") == "cpu"

if CPU_MODE:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags = (flags + " --xla_force_host_platform_device_count=8").strip()
    if "xla_cpu_max_isa" not in flags:
        # cap XLA:CPU codegen at AVX, which has no FMA instructions:
        # XLA:CPU otherwise contracts mul+add into FMA, so identical
        # formulas would round differently in differently-fused programs
        # and differ from the NumPy oracle.  Without FMA the CPU runs
        # the same uncontracted IEEE arithmetic as the GPU path (where
        # nothing contracts and division is exact, ops.device), and
        # parity holds bit for bit.  (The cap also avoids the AVX512
        # feature mismatch that SIGILL'd XLA:CPU kernels after a sandbox
        # VM migration on 2026-08-18.)
        flags = (flags + " --xla_cpu_max_isa=AVX").strip()
    if "xla_allow_excess_precision" not in flags:
        # keep f32 math in f32: no excess-precision rewrites
        flags = (flags + " --xla_allow_excess_precision=false").strip()
    os.environ["XLA_FLAGS"] = flags

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if CPU_MODE:
    jax.config.update("jax_platforms", "cpu")
    # A persistent XLA:CPU compile cache is DISABLED by default: after a
    # sandbox VM migration, (a) AOT executables cached on the previous
    # host LOADED despite a CPU-feature mismatch and SIGILL'd
    # ("cpu_aot_loader: +prefer-no-gather is not supported on the host
    # machine"), and (b) with a fresh cache dir, *serializing*
    # executables for the cache segfaulted outright (jax 0.9.0, crash
    # inside compilation_cache.put_executable_and_time).  Re-enable
    # explicitly with JAX_TEST_CACHE_DIR=/path when the host is stable
    # and the serializer is trusted.
    cache_dir = os.environ.get("JAX_TEST_CACHE_DIR")
    if cache_dir:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          0.5)

    # every XLA:CPU compiled executable maps exec pages and the full
    # suite compiles >1000 programs in one process: at the default
    # vm.max_map_count (65530) the process hits the kernel mmap limit
    # around test ~210 and SEGFAULTS inside backend_compile_and_load
    # (measured: /proc/<pid>/maps grew 35k -> 61k -> crash).  Raise the
    # limit best-effort; ignore failures (non-root / non-Linux).
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            if int(f.read()) < 262144:
                with open("/proc/sys/vm/max_map_count", "w") as g:
                    g.write("1048576")
    except OSError:
        pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: parity gate on the NVIDIA card (skips on the CPU; "
        "run with JAX_PLATFORMS=cuda python -m pytest tests -m gpu)")
