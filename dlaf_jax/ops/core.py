"""Core dense compute primitives shared by every algorithm.

This is the stand-in for the reference's tile-op layer
(``include/dlaf/blas/tile.h:473-479``, ``lapack/tile.h:610-618``): instead of
per-tile cuBLAS calls scheduled through senders, we expose dtype-generic,
precision-controlled matmul/masking helpers on full ``jnp`` arrays and let XLA
fuse them; the single-tile leaves live in :mod:`dlaf_jax.ops.leaf`.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..tune import get_tune_parameters
from ..types import Trans, is_complex_dtype

_PRECISIONS = {
    "default": jax.lax.Precision.DEFAULT,
    "highest": jax.lax.Precision.HIGHEST,
    "float32": jax.lax.Precision.HIGHEST,
}


def matmul_precision():
    return _PRECISIONS[get_tune_parameters().matmul_precision]


def op_mat(a, trans: Trans):
    """Apply a BLAS transposition op to a 2-D array."""
    t = Trans(trans)
    if t == Trans.NoTrans:
        return a
    if t == Trans.Trans:
        return a.T
    return a.conj().T if is_complex_dtype(a.dtype) else a.T


def mm(a, b, ta: Trans = Trans.NoTrans, tb: Trans = Trans.NoTrans, precision=None):
    """op(a) @ op(b) at the configured matmul precision (complex dtypes go
    through the native complex dot, cuBLAS zgemm/cgemm on the GPU)."""
    return jnp.matmul(op_mat(a, ta), op_mat(b, tb),
                      precision=precision or matmul_precision())


def ct(a):
    """Conjugate-transpose (hermitian adjoint) — dtype generic."""
    return a.conj().T if is_complex_dtype(a.dtype) else a.T


def tril_mask(n, m=None, k=0, dtype=jnp.bool_):
    m = n if m is None else m
    r = jax.lax.broadcasted_iota(jnp.int32, (n, m), 0)
    c = jax.lax.broadcasted_iota(jnp.int32, (n, m), 1)
    return (r >= c - k).astype(dtype)


def take_tri(a, lower: bool, unit: bool = False):
    """Materialize the referenced triangle of ``a`` (rest zeroed); with
    ``unit`` the stored diagonal is replaced by ones."""
    k = -1 if unit else 0
    t = jnp.tril(a, k) if lower else jnp.triu(a, -k)
    if unit:
        t = t + jnp.eye(a.shape[0], a.shape[1], dtype=a.dtype)
    return t


def symmetrize_tri(a, lower: bool):
    """Full hermitian matrix from its stored triangle (reference algorithms
    read only one triangle of hermitian inputs)."""
    if lower:
        t = jnp.tril(a)
        return t + ct(jnp.tril(a, -1))
    t = jnp.triu(a)
    return t + ct(jnp.triu(a, 1))


def set_tri(c, update, lower: bool):
    """Write ``update`` into the referenced triangle of ``c``, keep the other
    triangle of ``c`` untouched (BLAS herk/her2k semantics)."""
    mask = tril_mask(c.shape[0], c.shape[1]) if lower else ~tril_mask(c.shape[0], c.shape[1], k=-1)
    return jnp.where(mask, update, c)
