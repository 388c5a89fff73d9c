"""Persistent-compile-cache configuration: one helper for every launcher.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module
sets no directory. Otherwise the cache lives at a fixed path inside the
checkout (found from this file), so every process of one checkout — and
every later run — hits the same entries.

XLA:CPU executables are machine-specific: loading an entry compiled on
another host can fault ('Target machine feature not supported ... could
lead to SIGILL'), so CPU runs use a subdirectory keyed by the host's CPU
feature set.

This module imports jax only inside :func:`configure_compilation_cache`, so
a launcher can import it first; the cache directory is read at compile
time, so configuring it after jax is imported is safe.
"""
from __future__ import annotations

import hashlib
import os
import platform

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_key() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            key = next(line for line in f if line.startswith("flags"))
    except (OSError, StopIteration):
        key = platform.platform() + platform.processor()
    return hashlib.sha1(key.encode()).hexdigest()[:10]


def cache_dir(cpu: bool | None = None) -> str | None:
    """The compile-cache directory this process should use: None when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX honours it directly), else a
    fixed directory inside the checkout. ``cpu`` defaults to whether
    ``JAX_PLATFORMS`` selects the CPU."""
    if os.environ.get(ENV_VAR):
        return None
    if cpu is None:
        cpu = os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu"
    if cpu:
        return os.path.join(_CHECKOUT, ".jax_cache_cpu", _cpu_key())
    return os.path.join(_CHECKOUT, ".jax_cache")


def configure_compilation_cache(cpu: bool | None = None,
                                min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent compile cache at :func:`cache_dir` (unless the
    environment already names one) and return the directory in use."""
    import jax
    path = cache_dir(cpu)
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    # A finite max_size switches JAX's LRU cache into its filelock-guarded
    # mode: without it put() is a non-atomic write, and a concurrent process
    # (xdist workers, multihost ranks) can read a half-written entry and
    # crash in deserialize_executable. 4 GiB is far above any working set,
    # so this buys locking without evictions.
    jax.config.update("jax_compilation_cache_max_size", 4 * 1024**3)
    return path or os.environ[ENV_VAR]
