"""Runtime initialization.

Analog of the reference's ``dlaf::initialize/finalize/ScopedInitializer``
(``src/init.cpp:306-379``): one place that brings up the runtime — multi-host
JAX distributed init when requested, the persistent compilation cache (the
analog of warmed-up pika thread pools: first-compile latency is the
startup cost here), tune-parameter resolution, and an optional config dump
(reference ``--dlaf:print-config``).
"""
from __future__ import annotations

import dataclasses

import jax

from .cache import configure_compilation_cache
from .tune import get_tune_parameters

_initialized = False


def initialize(print_config: bool = False, distributed: bool = False,
               **distributed_kw) -> None:
    """Idempotent runtime bring-up. The compile cache follows
    :func:`dlaf_jax.cache.configure_compilation_cache`."""
    global _initialized
    if _initialized:
        return
    cache = configure_compilation_cache()
    if distributed:
        jax.distributed.initialize(**distributed_kw)
    if print_config:
        tp = get_tune_parameters()
        print("dlaf_jax configuration:")
        print(f"  backend: {jax.default_backend()}  devices: {len(jax.devices())}")
        print(f"  compilation cache: {cache}")
        for f in dataclasses.fields(tp):
            print(f"  {f.name}: {getattr(tp, f.name)}")
    _initialized = True


def finalize() -> None:
    global _initialized
    _initialized = False


class ScopedInitializer:
    """``with ScopedInitializer(): ...`` (reference ``dlaf::ScopedInitializer``)."""

    def __init__(self, **kw):
        self._kw = kw

    def __enter__(self):
        initialize(**self._kw)
        return self

    def __exit__(self, *exc):
        finalize()
        return False
