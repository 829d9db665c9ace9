"""Persistent XLA compilation cache.

The engine's jitted sweeps (fused stream dispatch, strip/block kernels)
cost seconds to tens of seconds to compile on an accelerator; the
reference binary has no comparable startup tax (src/main.rs runs
immediately).  JAX's persistent compilation cache makes every run after
the first start hot: compiled executables are keyed by HLO fingerprint
and reloaded from disk, so repeated invocations — the normal CLI usage
pattern — skip compilation.

Cache location: ``$JAX_COMPILATION_CACHE_DIR`` when set (and no other
directory), else the fixed in-checkout directory ``DEFAULT_DIR``.  The path is part of every entry's key, so it
never depends on a temporary name, a pid or the time.  JAX's own
``jax_enable_compilation_cache`` switch turns the cache off.  Failures
are non-fatal: JAX degrades to plain compilation when entries cannot be
written or deserialized.

The default directory is used only when the configured platform is an
accelerator: XLA:CPU executables are AOT-compiled against the build
machine's exact feature set, and reloading them prints
machine-feature-mismatch errors (and risks SIGILL) on any host whose
features differ — and CPU compiles are fast enough that the cache buys
nothing.  Setting ``JAX_COMPILATION_CACHE_DIR`` opts in on any platform.
"""

from __future__ import annotations

import importlib.util
import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)
_GPU_PLUGINS = ("jax_cuda12_plugin", "jax_cuda13_plugin")


def _on_accelerator() -> bool:
    """Whether JAX will compile for an accelerator, decided without
    initializing a backend: the first configured platform when one is
    set, else whether a GPU plugin is installed."""
    import jax

    plat = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", "")
    first = plat.split(",")[0].strip().lower()
    if first:
        return first != "cpu"
    return any(importlib.util.find_spec(m) for m in _GPU_PLUGINS)


def enable_jit_cache() -> str | None:
    """Turn on JAX's persistent compilation cache.

    Returns the cache directory, or None when disabled.  Safe to call
    multiple times and before/after backend init (JAX reads the config
    at compile time).
    """
    import jax

    if not jax.config.jax_enable_compilation_cache:
        return None
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        if not _on_accelerator():
            return None
        path = DEFAULT_DIR
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return None
    jax.config.update("jax_compilation_cache_dir", path)
    # Cache everything: the engine's kernels are few and reused, so
    # there is no value in the default size/compile-time thresholds.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
