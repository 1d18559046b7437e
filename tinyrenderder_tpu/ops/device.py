"""The one platform decision, the GPU compiler flag parity needs, and
the persistent compile cache.

The renderer runs on an NVIDIA GPU.  The CPU backend exists for the
tests: there every Pallas kernel runs in the interpreter.  No other
platform is supported, and no kernel runs interpreted on the GPU.
"""

from __future__ import annotations

import logging
import os

import jax

__all__ = ["platform", "interpret", "EXACT_DIV_FLAG", "require_exact_div",
           "use_compile_cache"]

log = logging.getLogger(__name__)

#: XLA:GPU feeds LLVM ``-nvptx-prec-divf32=1``, which emits the
#: approximate ``div.full.f32`` for every f32 division.  The coverage
#: test (b1 = uy/uz, ops.semantics.barycentric) and the NDC divide of
#: triangle setup need IEEE division to match the float32 oracle bit for
#: bit; this LLVM option restores ``div.rn.f32``.  It must be in
#: XLA_FLAGS before the GPU backend starts.
EXACT_DIV_FLAG = "--xla_backend_extra_options=-nvptx-prec-divf32=2"

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def platform() -> str:
    """``"gpu"`` or ``"cpu"``: JAX's default backend.  Anything else is
    an error — the renderer has kernels for NVIDIA GPUs only."""
    p = jax.default_backend()
    if p in ("gpu", "cpu"):
        return p
    raise RuntimeError(f"unsupported JAX platform {p!r}: tinyrenderder_tpu "
                       "runs on an NVIDIA GPU (or the CPU, for tests)")


def interpret() -> bool:
    """Whether Pallas kernels run in the interpreter: only on the CPU."""
    return platform() == "cpu"


def require_exact_div() -> None:
    """Put EXACT_DIV_FLAG into XLA_FLAGS before JAX starts a backend
    (the CPU backend accepts the option and ignores it).  Called when
    the package is imported; a no-op once the flag is present."""
    flags = os.environ.get("XLA_FLAGS", "")
    if EXACT_DIV_FLAG in flags:
        return
    from jax._src import xla_bridge
    if xla_bridge.backends_are_initialized():
        log.warning("the JAX backend started before tinyrenderder_tpu was "
                    "imported, without %s: f32 division on the GPU is "
                    "approximate and bitwise parity with the oracle is "
                    "not guaranteed", EXACT_DIV_FLAG)
        return
    os.environ["XLA_FLAGS"] = (flags + " " + EXACT_DIV_FLAG).strip()


def use_compile_cache() -> str | None:
    """Keep compiled programs across processes.  JAX reads
    JAX_COMPILATION_CACHE_DIR itself when it is set, and then nothing is
    set here; otherwise GPU programs are cached in
    ``<checkout>/.jax_cache``.  The CPU backend (the tests) gets no cache:
    serializing XLA:CPU executables has crashed jax 0.9.0 (see
    tests/conftest.py).  Returns the directory in use, or None."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if platform() != "gpu":
        return None
    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
