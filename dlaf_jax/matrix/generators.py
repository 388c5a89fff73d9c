"""Deterministic matrix generators for tests and benchmarks.

Analog of the reference's ``include/dlaf/util_matrix.h:150-432``
(``set_random``, ``set_random_hermitian[_positive_definite]``,
``set_identity``): generation is seed-deterministic and independent of the
device mesh, so every shard/host sees the same global matrix — the property
the reference achieves with per-element seeded RNG.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..types import is_complex_dtype, real_dtype


def random_general(key, shape, dtype):
    """Uniform in [-1, 1] (complex: re+im independently)."""
    rd = real_dtype(dtype)
    if is_complex_dtype(dtype):
        kr, ki = jax.random.split(key)
        re = jax.random.uniform(kr, shape, rd, -1.0, 1.0)
        im = jax.random.uniform(ki, shape, rd, -1.0, 1.0)
        return (re + 1j * im).astype(dtype)
    return jax.random.uniform(key, shape, rd, -1.0, 1.0).astype(dtype)


import functools


@functools.partial(jax.jit, static_argnames=("n", "dtype"))
def _random_hermitian(key, n, dtype):
    r = random_general(key, (n, n), dtype)
    return (r + jnp.conj(r.T)) / 2 if is_complex_dtype(dtype) \
        else (r + r.T) / 2


def random_hermitian(key, n, dtype):
    """Random hermitian with elements O(1) and real diagonal.

    Jitted so XLA fuses the transpose + add + scale into one output buffer:
    unjitted, each op materializes its own (n, n) temporary (three extra
    n^2 buffers beside the result).
    """
    return _random_hermitian(key, n, jnp.dtype(dtype))


def random_hermitian_positive_definite(key, n, dtype):
    """Hermitian positive definite with eigenvalues in ~[n/2, 3n/2].

    Reference: ``util::matrix::set_random_hermitian_positive_definite``
    (diagonal shifted by 2n in the reference; n here, same conditioning
    class). Jitted so XLA fuses symmetrization + diagonal shift into one
    buffer (an unjitted version holds one n^2 temporary per op).
    """
    @jax.jit
    def build(key):
        h = random_hermitian(key, n, dtype)
        idx = jnp.arange(n)
        return h.at[idx, idx].add(jnp.asarray(n, dtype))
    return build(key)


def random_triangular(key, n, dtype, lower: bool = True, unit: bool = False):
    """Well-conditioned random triangular matrix (diagonal pushed away from 0)."""
    r = random_general(key, (n, n), dtype)
    t = jnp.tril(r, -1) if lower else jnp.triu(r, 1)
    t = t / n  # keep off-diagonal mass small => condition number O(1)
    d = jnp.ones((n,), dtype) if unit else \
        (jax.random.uniform(key, (n,), real_dtype(dtype), 1.0, 2.0)).astype(dtype)
    return t + jnp.diag(d)


def identity(n, dtype):
    return jnp.eye(n, dtype=dtype)
