"""Leaf (single-tile) kernels.

Blocked recursions in :mod:`dlaf_jax.ops.blocked` bottom out here on tiles of
``leaf_block_size``. Both leaves are ``jax.lax.linalg`` primitives, which XLA
lowers to the vendor libraries on the GPU (cuSOLVER potrf, cuBLAS trsm) —
the same split as the reference's vendor-library tile ops
(``include/dlaf/lapack/tile.h:610-618``).
"""
from __future__ import annotations

import jax

from .core import ct


def potrf_leaf(a, upper: bool = False):
    """Cholesky factor of a single SPD tile; the other triangle is zeroed.
    ``upper`` selects A = U^H U on the upper triangle (strictly-lower zeroed)."""
    if upper:
        return ct(jax.lax.linalg.cholesky(ct(a), symmetrize_input=False))
    return jax.lax.linalg.cholesky(a, symmetrize_input=False)


def trsm_leaf(a, b, *, left: bool, lower: bool, trans: str, unit: bool):
    """Solve op(a) x = b (left) or x op(a) = b (right) on a single tile."""
    return jax.lax.linalg.triangular_solve(
        a, b,
        left_side=left, lower=lower,
        transpose_a=trans in ("T", "C"),
        conjugate_a=trans == "C",
        unit_diagonal=unit,
    )
