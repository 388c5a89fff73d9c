"""Generalized-to-standard eigenproblem transform (HEGST, itype=1).

Reference: ``dlaf::eigensolver::internal::GenToStd``
(``eigensolver/gen_to_std/impl.h:222`` local, ``:286`` distributed):
A <- L^-1 A L^-H (lower) so that the generalized problem A x = lambda B x
becomes standard. Implemented as two triangular solves — each one large
GEMM-driven blocked solve — instead of the reference's tile-wise
hegst/trsm/hemm/her2k update chain.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..api import local as lapi
from ..ops.core import ct, symmetrize_tri
from ..tune import get_tune_parameters


def generalized_to_standard(a, l, uplo: str = "L", nb: int | None = None):
    """Return L^-1 A L^-H (uplo='L') or U^-H A U^-1 (uplo='U').

    ``a`` hermitian (referenced triangle), ``l`` the Cholesky factor of B.
    """
    nb = nb or get_tune_parameters().leaf_block_size
    a = jnp.asarray(a)
    afull = symmetrize_tri(a, uplo == "L")
    if uplo == "L":
        y = lapi.trsm(l, afull, side="L", uplo="L", trans="N", nb=nb)
        return lapi.trsm(l, ct(y), side="L", uplo="L", trans="N", nb=nb)
    y = lapi.trsm(l, afull, side="L", uplo="U", trans="C", nb=nb)
    return lapi.trsm(l, ct(y), side="L", uplo="U", trans="C", nb=nb)


def generalized_to_standard_dist(a, l, uplo: str = "L"):
    """Distributed variant over DistMatrix inputs (square grids use the
    cheap canonical-layout transpose; see matrix.dist_matrix).

    ``uplo='U'`` computes U^-H A U^-1 with ``l`` holding the upper factor U
    of B = U^H U — identical to the lower case with L = U^H (one
    device-resident transpose; reference handles both uplo dispatches,
    ``eigensolver/gen_to_std/impl.h:222,286``).
    """
    from ..algos.triangular import triangular_solver

    if uplo == "U":
        l = l.transpose()           # conjugate transpose: U^H is lower
    y = triangular_solver(l, a, uplo="L", trans="N")
    yt = y.transpose()
    return triangular_solver(l, yt, uplo="L", trans="N")
