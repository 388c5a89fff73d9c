"""Core scalar/enum types for dlaf_jax.

Rebuild of the reference's type layer (see DLA-Future
``include/dlaf/types.h:25-139``): instead of ``SizeType``/``Device``/``Backend``
C++ enums we keep plain Python ints, JAX dtypes and a small set of BLAS-style
enums shared by every algorithm, plus the flop-accounting helper used by the
benchmark harness (reference ``include/dlaf/types.h`` ``total_ops``).
"""
from __future__ import annotations

import enum
from typing import Union

import jax.numpy as jnp
import numpy as np


class Uplo(str, enum.Enum):
    """Which triangle of a matrix is referenced (BLAS 'L'/'U')."""

    Lower = "L"
    Upper = "U"


class Side(str, enum.Enum):
    """Side of a triangular/hermitian factor in a product (BLAS 'L'/'R')."""

    Left = "L"
    Right = "R"


class Trans(str, enum.Enum):
    """Transposition op (BLAS 'N'/'T'/'C')."""

    NoTrans = "N"
    Trans = "T"
    ConjTrans = "C"


class Diag(str, enum.Enum):
    """Unit or non-unit diagonal for triangular matrices (BLAS 'U'/'N')."""

    Unit = "U"
    NonUnit = "N"


DTypeLike = Union[str, np.dtype, type]

_REAL = {jnp.dtype("float32"), jnp.dtype("float64"), jnp.dtype("bfloat16")}
_COMPLEX = {jnp.dtype("complex64"), jnp.dtype("complex128")}


def is_complex_dtype(dtype: DTypeLike) -> bool:
    return jnp.dtype(dtype) in _COMPLEX


def real_dtype(dtype: DTypeLike) -> np.dtype:
    """Base real type of a (possibly complex) dtype (reference ``BaseType``)."""
    d = jnp.dtype(dtype)
    if d == jnp.dtype("complex64"):
        return jnp.dtype("float32")
    if d == jnp.dtype("complex128"):
        return jnp.dtype("float64")
    return d


def complex_dtype(dtype: DTypeLike) -> np.dtype:
    """Complex type with matching precision (reference ``ComplexType``)."""
    d = jnp.dtype(dtype)
    if d in _COMPLEX:
        return d
    if d == jnp.dtype("float64"):
        return jnp.dtype("complex128")
    return jnp.dtype("complex64")


def eps(dtype: DTypeLike) -> float:
    """Machine epsilon of the base real type (used for residual bounds)."""
    return float(jnp.finfo(real_dtype(dtype)).eps)


def total_ops(dtype: DTypeLike, add: float, mul: float) -> float:
    """Total scalar flops for ``add`` additions and ``mul`` multiplications.

    Mirrors the reference's flop accounting (``include/dlaf/types.h``
    ``total_ops``; used by every miniapp): real dtypes count add+mul, complex
    dtypes count 2*add + 6*mul.
    """
    if is_complex_dtype(dtype):
        return 2.0 * add + 6.0 * mul
    return float(add) + float(mul)


def conj(x):
    """dtype-generic conjugate (no-op for real dtypes, cheap for complex)."""
    if is_complex_dtype(x.dtype):
        return jnp.conj(x)
    return x
