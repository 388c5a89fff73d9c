"""Hermitian eigensolver driver: the full two-stage pipeline.

Equivalent of the reference's
``Eigensolver<B,D,T>::call`` (``eigensolver/eigensolver/impl.h:38-95``):

    reduction_to_band -> band_to_tridiag -> tridiagonal D&C
        -> bt_band_to_tridiag -> bt_reduction_to_band

plus the generalized driver (``GenEigensolver::call``,
``eigensolver/gen_eigensolver/impl.h:30-93``):

    cholesky(B) -> generalized_to_standard -> eigensolver -> TRSM back-subst.
"""
from __future__ import annotations

import jax.numpy as jnp

from ...api import local as lapi
from ...ops.core import ct
from ...tune import get_tune_parameters
from .band2tridiag import band_to_tridiag_auto as band_to_tridiag
from .bt import bt_band_to_tridiag, bt_reduction_to_band
from .red2band import extract_band, reduction_to_band
from .tridiag_dc import tridiag_eigh


def get_band_size(nb: int) -> int:
    """Smallest divisor of nb >= eigensolver_min_band (reference
    ``eigensolver/internal/get_band_size.h:20`` getBandSize)."""
    min_band = get_tune_parameters().eigensolver_min_band
    for cand in range(min_band, nb + 1):
        if nb % cand == 0:
            return cand
    return nb


def eigh(a, uplo: str = "L", band: int | None = None, laed4_iter: int | None = None):
    """Eigenvalues (ascending) and eigenvectors of hermitian ``a``.

    Reference: ``dlaf::hermitian_eigensolver`` (``eigensolver/eigensolver.h:56``).
    Only the ``uplo`` triangle of ``a`` is referenced. Returns (w, v) with
    v's columns the eigenvectors.
    """
    a = jnp.asarray(a)
    n = a.shape[0]
    if uplo == "U":
        a = ct(a)
    if n == 0:
        return jnp.zeros((0,), a.dtype), jnp.zeros((0, 0), a.dtype)
    if n == 1:
        return jnp.real(a[0:1, 0]), jnp.ones((1, 1), a.dtype)

    tune = get_tune_parameters()
    laed4 = laed4_iter or tune.laed4_max_iter

    b = band or get_band_size(tune.default_block_size)
    # pad to a multiple of b with decoupled identity diagonal
    npad = (-n) % b if n > b else (b - n if n < b else 0)
    if n <= b:
        # matrix no bigger than one band block: single-stage via tridiag of
        # the dense matrix using band reduction with b=... just treat the
        # dense matrix as "band" with bandwidth n-1
        band_dense = jnp.tril(a) + ct(jnp.tril(a, -1))
        d, e, vs, taus2 = band_to_tridiag(band_dense, max(n - 1, 1))
        er, phases = _phase_normalize(e, a.dtype)
        w, q = tridiag_eigh(jnp.real(d), er, laed4)
        q = (phases[:, None] * q.astype(a.dtype)).astype(a.dtype)
        q = bt_band_to_tridiag(
            q, vs, taus2, max(n - 1, 1),
            group_size=tune.bt_band_to_tridiag_hh_apply_group_size)
        return w, q

    if npad:
        ap = jnp.zeros((n + npad, n + npad), a.dtype)
        ap = ap.at[:n, :n].set(a)
        # decoupled padding: large separated diagonal so padded eigenvalues
        # sort strictly last (the +1 keeps them above the Gershgorin bound
        # even for an all-zero input)
        gersh = jnp.max(jnp.abs(a)) * (n + 1)
        ap = ap.at[jnp.arange(n, n + npad), jnp.arange(n, n + npad)].set(
            gersh + 1.0 + jnp.arange(npad, dtype=jnp.real(a).dtype))
    else:
        ap = a
    m = ap.shape[0]

    packed, taus1 = reduction_to_band(ap, b)
    band_dense = extract_band(packed, b)
    d, e, vs, taus2 = band_to_tridiag(band_dense, b)
    er, phases = _phase_normalize(e, ap.dtype)
    w, q = tridiag_eigh(jnp.real(d), er, laed4)
    q = (phases[:, None] * q.astype(ap.dtype)).astype(ap.dtype)
    q = bt_band_to_tridiag(
        q, vs, taus2, b,
        group_size=tune.bt_band_to_tridiag_hh_apply_group_size)
    q = bt_reduction_to_band(q, packed, taus1, b)
    return w[:n], q[:n, :n]


def _phase_normalize(e, dtype):
    """Make the tridiagonal subdiagonal real (hermitian input): with
    phi_0 = 1, phi_{k+1} = phi_k * e_k/|e_k|, T = diag(phi) T_real diag(phi)^H
    has subdiagonal |e|; eigenvectors map back as v = phi * v_real."""
    from ...types import is_complex_dtype
    if not is_complex_dtype(dtype):
        return jnp.real(e), jnp.ones((e.shape[0] + 1,), dtype)
    mag = jnp.abs(e)
    sign = jnp.where(mag > 0, e / jnp.where(mag > 0, mag, 1.0), 1.0)
    phases = jnp.concatenate([jnp.ones((1,), dtype), jnp.cumprod(sign)])
    return mag.astype(jnp.real(e).dtype), phases


def eigh_gen(a, b, uplo: str = "L", factorized: bool = False, **kw):
    """Generalized eigenproblem A x = lambda B x (B hermitian pos. def.).

    Reference: ``dlaf::hermitian_generalized_eigensolver[_factorized]``
    (``eigensolver/gen_eigensolver.h:182-476``). With ``factorized`` the
    ``b`` argument is already the Cholesky factor L of B.
    """
    from ...ops.core import symmetrize_tri

    nb = get_tune_parameters().leaf_block_size
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    afull = symmetrize_tri(a, uplo == "L")
    if factorized:
        l = b if uplo == "L" else ct(b)
    else:
        bfull = symmetrize_tri(b, uplo == "L")
        l = lapi.potrf(bfull, uplo="L", nb=nb)
    # A_std = L^-1 A L^-H: y = L^-1 A, then L^-1 y^H (hermitian result)
    y = lapi.trsm(l, afull, side="L", uplo="L", trans="N", nb=nb)
    astd = lapi.trsm(l, ct(y), side="L", uplo="L", trans="N", nb=nb)
    w, z = eigh(astd, uplo="L", **kw)
    # back-substitute: x = L^-H z  (reference gen_eigensolver/impl.h:85-91)
    x = lapi.trsm(l, z, side="L", uplo="L", trans="C", nb=nb)
    return w, x
