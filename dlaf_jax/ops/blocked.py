"""Blocked recursive BLAS-3/LAPACK building blocks (single device).

The reference expresses POTRF/TRSM/TRMM/HERK as dynamic task graphs over
tiles (``factorization/cholesky/impl.h:151-189``,
``solver/triangular/impl.h:236-473``, ...). Here the idiomatic equivalent is
*static recursive blocking*: each operation splits at tile-aligned midpoints
into sub-operations plus large GEMMs, unrolled at trace time into one XLA
program. XLA's async scheduler then provides the overlap the pika runtime gave
the reference, and almost every flop lands in a large GEMM.

All functions require dimensions to be multiples of the leaf size ``nb``
(the public API pads, see :mod:`dlaf_jax.api`), are dtype-generic, and follow
BLAS semantics for which triangle is read/written.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..types import Trans
from .core import ct, mm, op_mat, set_tri, symmetrize_tri, take_tri
from .householder import tri_inv
from .leaf import potrf_leaf, trsm_leaf


def _split(n: int, nb: int) -> int:
    """Largest tile-aligned split point <= n/2 (at least one tile)."""
    return max(n // (2 * nb), 1) * nb


def _op(a, trans):
    return op_mat(a, Trans(trans))


# ---------------------------------------------------------------------------
# POTRF


def potrf_lower(a, nb: int, clean: bool = True):
    """Lower Cholesky of SPD ``a``.

    With ``clean`` the strictly-upper part is zeroed (one extra full pass);
    without it the upper triangle keeps the original input content — the
    reference's in-place semantics (potrf writes only the lower triangle).

    Reference algorithm: tiled right-looking Cholesky
    (``factorization/cholesky/impl.h:151-189``); here as a recursive blocked
    factorization, mathematically identical ordering of the same tile ops.
    All updates are in-place ``.at[]`` writes on one buffer (XLA aliases
    them), never concatenations — a rebuild-the-matrix recursion would copy
    the whole matrix at every level.
    """
    n = a.shape[0]
    assert n % nb == 0, (n, nb)
    invd = jnp.zeros((n // nb, min(nb, n), min(nb, n)), a.dtype)

    def rec(a, invd, o, s):
        if s <= nb:
            f = potrf_leaf(a[o:o + s, o:o + s])
            # invert the diagonal tile ONCE at factorization time; every
            # panel solve above reuses it (cuBLAS inverted-diagonal scheme)
            invd = invd.at[o // nb].set(tri_inv(f, lower=True, nb=64))
            return a.at[o:o + s, o:o + s].set(f), invd
        s1 = _split(s, nb)
        a, invd = rec(a, invd, o, s1)
        # A21 <- A21 L11^-H (tile::trsm Right/Lower/ConjTrans, blas/tile.h:473)
        l21 = _trsm_right_lc_preinv(a[o + s1:o + s, o:o + s1], a, invd, o, s1, nb)
        a = a.at[o + s1:o + s, o:o + s1].set(l21)
        # A22 <- A22 - L21 L21^H (tile::herk trailing update)
        a = _herk_inplace(a, o + s1, s - s1, l21, lower=True, trans="N",
                          alpha=-1.0, beta=1.0, nb=nb)
        return rec(a, invd, o + s1, s - s1)

    a, _ = rec(a, invd, 0, n)
    return jnp.tril(a) if clean else a


def _trsm_right_lc_preinv(b, a, invd, o, s, nb):
    """X L^H = B with L = a[o:o+s, o:o+s] (lower, factored): the forward
    column recursion of ``_trsm_right`` with each diagonal leaf solve
    replaced by one GEMM against the precomputed tile inverse."""

    def rec(b, oo, ss):
        if ss <= nb:
            inv = invd[(o + oo) // nb]
            return b.at[:, oo:oo + ss].set(
                mm(b[:, oo:oo + ss], ct(inv)))
        s1 = _split(ss, nb)
        b = rec(b, oo, s1)
        off = a[o + oo + s1:o + oo + ss, o + oo:o + oo + s1]
        b = b.at[:, oo + s1:oo + ss].add(-mm(b[:, oo:oo + s1], ct(off)))
        return rec(b, oo + s1, ss - s1)

    return rec(b, 0, s)


def potrf_upper(a, nb: int, clean: bool = True):
    """Upper Cholesky (A = U^H U) of SPD ``a``; lower mirror of
    ``potrf_lower`` (reference Cholesky supports both uplo cases,
    ``factorization/cholesky.h:40``).

    The panel solve is a LEFT triangular solve (U12 = U11^{-H} A12) and the
    trailing update is herk(trans='C'), so no operand is physically
    transposed and XLA keeps the program row-major; the lower-uplo path's
    right-side solves may force transpose copies or a relayout.
    """
    n = a.shape[0]
    assert n % nb == 0, (n, nb)
    invd = jnp.zeros((n // nb, min(nb, n), min(nb, n)), a.dtype)

    def rec(a, invd, o, s):
        if s <= nb:
            blk = a[o:o + s, o:o + s]
            f = potrf_leaf(blk, upper=True)
            invd = invd.at[o // nb].set(tri_inv(f, lower=False, nb=64))
            return a.at[o:o + s, o:o + s].set(f), invd
        s1 = _split(s, nb)
        a, invd = rec(a, invd, o, s1)
        # A12 <- U11^{-H} A12 (left solve with the stored-upper factor)
        u12 = _trsm_left_uc_preinv(a[o:o + s1, o + s1:o + s], a, invd, o, s1, nb)
        a = a.at[o:o + s1, o + s1:o + s].set(u12)
        # A22 <- A22 - U12^H U12
        a = _herk_inplace(a, o + s1, s - s1, u12, lower=False, trans="C",
                          alpha=-1.0, beta=1.0, nb=nb)
        return rec(a, invd, o + s1, s - s1)

    a, _ = rec(a, invd, 0, n)
    return jnp.triu(a) if clean else a


def _trsm_left_uc_preinv(b, a, invd, o, s, nb):
    """U^H X = B with U = a[o:o+s, o:o+s] (upper, factored): the forward row
    recursion of ``_trsm_left`` with each diagonal leaf solve replaced by one
    GEMM against the precomputed tile inverse."""

    def rec(b, oo, ss):
        if ss <= nb:
            inv = invd[(o + oo) // nb]
            return b.at[oo:oo + ss].set(mm(ct(inv), b[oo:oo + ss]))
        s1 = _split(ss, nb)
        b = rec(b, oo, s1)
        off = a[o + oo:o + oo + s1, o + oo + s1:o + oo + ss]
        b = b.at[oo + s1:oo + ss].add(-mm(ct(off), b[oo:oo + s1]))
        return rec(b, oo + s1, ss - s1)

    return rec(b, 0, s)


# ---------------------------------------------------------------------------
# TRSM — triangular solve with multiple RHS


def trsm(b, a, *, side: str, lower: bool, trans: str, unit: bool, nb: int, alpha=1.0):
    """Solve op(A) X = alpha B (side='L') or X op(A) = alpha B (side='R').

    All 8 side/uplo/trans cases of the reference's triangular solver
    (``solver/triangular/impl.h:236-473``). Right-side cases use a native
    column-block recursion: reducing them to left cases through transposes
    can make XLA flip the *entire surrounding program* into a column-major
    layout, inserting two full-matrix relayout copies at the jit boundary
    on top of the transposes themselves.
    """
    if side == "R":
        return _trsm_right(alpha * b, a, lower, trans, unit, nb)
    return _trsm_left(alpha * b, a, lower, trans, unit, nb)


def _trsm_left(b, a, lower, trans, unit, nb):
    n = a.shape[0]
    assert n % nb == 0 and b.shape[0] == n
    forward = (lower and trans == "N") or (not lower and trans != "N")

    def rec(b, o, s):
        if s <= nb:
            return b.at[o:o + s].set(trsm_leaf(
                a[o:o + s, o:o + s], b[o:o + s],
                left=True, lower=lower, trans=trans, unit=unit))
        s1 = _split(s, nb)
        off = a[o + s1:o + s, o:o + s1] if lower else a[o:o + s1, o + s1:o + s]
        if forward:
            b = rec(b, o, s1)
            # op(A) block below-left: A21 (lower,N) or op(A12) (upper,T/C)
            m = off if (lower and trans == "N") else _op(off, trans)
            b = b.at[o + s1:o + s].add(-mm(m, b[o:o + s1]))
            return rec(b, o + s1, s - s1)
        b = rec(b, o + s1, s - s1)
        m = off if (not lower and trans == "N") else _op(off, trans)
        b = b.at[o:o + s1].add(-mm(m, b[o + s1:o + s]))
        return rec(b, o, s1)

    return rec(b, 0, n)


def _trsm_right(b, a, lower, trans, unit, nb):
    """X op(A) = B by column-block recursion (all four lower/trans cases)."""
    n = a.shape[0]
    assert n % nb == 0 and b.shape[1] == n
    forward = (lower and trans != "N") or (not lower and trans == "N")

    def rec(b, o, s):
        if s <= nb:
            return b.at[:, o:o + s].set(trsm_leaf(
                a[o:o + s, o:o + s], b[:, o:o + s],
                left=False, lower=lower, trans=trans, unit=unit))
        s1 = _split(s, nb)
        off = a[o + s1:o + s, o:o + s1] if lower else a[o:o + s1, o + s1:o + s]
        if forward:
            b = rec(b, o, s1)
            # op(A) block above-right: A12 (upper,N) or op(A21) (lower,T/C)
            m = off if (not lower and trans == "N") else _op(off, trans)
            b = b.at[:, o + s1:o + s].add(-mm(b[:, o:o + s1], m))
            return rec(b, o + s1, s - s1)
        b = rec(b, o + s1, s - s1)
        m = off if (lower and trans == "N") else _op(off, trans)
        b = b.at[:, o:o + s1].add(-mm(b[:, o + s1:o + s], m))
        return rec(b, o, s1)

    return rec(b, 0, n)


# ---------------------------------------------------------------------------
# TRMM — triangular matrix multiply


def trmm(b, a, *, side: str, lower: bool, trans: str, unit: bool, nb: int, alpha=1.0):
    """B <- alpha op(A) B (side='L') or alpha B op(A) (side='R').

    Reference: ``multiplication/triangular`` (8 local cases,
    ``multiplication/triangular/api.h:17-75``).
    """
    if side == "R":
        if trans == "C":
            y = jnp.conj(alpha) * _trmm_left(ct(b), a, lower, "N", unit, nb)
            return ct(y)
        tt = {"N": "T", "T": "N"}[trans]
        return alpha * _trmm_left(b.T, a, lower, tt, unit, nb).T
    return alpha * _trmm_left(b, a, lower, trans, unit, nb)


def _trmm_left(b, a, lower, trans, unit, nb):
    n = a.shape[0]
    assert n % nb == 0 and b.shape[0] == n
    low_block = (lower and trans == "N") or (not lower and trans != "N")

    def rec(b, o, s):
        if s <= nb:
            return b.at[o:o + s].set(
                mm(take_tri(a[o:o + s, o:o + s], lower, unit), b[o:o + s],
                   ta=Trans(trans)))
        s1 = _split(s, nb)
        off = a[o + s1:o + s, o:o + s1] if lower else a[o:o + s1, o + s1:o + s]
        m = off if (trans == "N") else _op(off, trans)
        # op(A)'s off-diagonal block contributes to one half; the source half
        # must still hold the ORIGINAL b, so order the updates accordingly
        if low_block:
            cross = mm(m, b[o:o + s1])
            b = rec(b, o, s1)
            b = rec(b, o + s1, s - s1)
            return b.at[o + s1:o + s].add(cross)
        cross = mm(m, b[o + s1:o + s])
        b = rec(b, o, s1)
        b = rec(b, o + s1, s - s1)
        return b.at[o:o + s1].add(cross)

    return rec(b, 0, n)


# ---------------------------------------------------------------------------
# HERK / HER2K — hermitian rank-k updates (only referenced triangle written)


def _herk_inplace(c, o, s, a, *, lower, trans, alpha, beta, nb):
    """Triangle-only rank-k update of the diagonal block C[o:o+s, o:o+s];
    ``a``'s n-dimension index 0 aligns with row/col ``o`` of that block."""
    ta = Trans.NoTrans if trans == "N" else Trans.ConjTrans
    tb = Trans.ConjTrans if trans == "N" else Trans.NoTrans

    def blk(lo, ln):
        return a[lo:lo + ln] if trans == "N" else a[:, lo:lo + ln]

    def rec(c, co, s):
        if s <= nb:
            g = mm(blk(co - o, s), blk(co - o, s), ta=ta, tb=tb)
            cb = c[co:co + s, co:co + s]
            return c.at[co:co + s, co:co + s].set(
                set_tri(cb, beta * cb + alpha * g, lower))
        s1 = _split(s, nb)
        c = rec(c, co, s1)
        c = rec(c, co + s1, s - s1)
        if lower:
            g = mm(blk(co - o + s1, s - s1), blk(co - o, s1), ta=ta, tb=tb)
            return c.at[co + s1:co + s, co:co + s1].set(
                beta * c[co + s1:co + s, co:co + s1] + alpha * g)
        g = mm(blk(co - o, s1), blk(co - o + s1, s - s1), ta=ta, tb=tb)
        return c.at[co:co + s1, co + s1:co + s].set(
            beta * c[co:co + s1, co + s1:co + s] + alpha * g)

    return rec(c, o, s)


def herk(c, a, *, lower: bool, trans: str, alpha=1.0, beta=1.0, nb: int = 128):
    """C <- alpha op(A) op(A)^H + beta C on the referenced triangle.

    trans='N': op(A)=A (n x k); trans='C': op(A)=A^H (reference tile::herk,
    ``blas/tile.h:473-479``). Recursive with in-place block writes:
    off-diagonal quadrants are plain GEMMs, only leaf diagonal blocks
    compute a wasted half-triangle.
    """
    return _herk_inplace(c, 0, c.shape[0], a, lower=lower, trans=trans,
                         alpha=alpha, beta=beta, nb=nb)


def her2k(c, a, b, *, lower: bool, trans: str, alpha=1.0, beta=1.0, nb: int = 128):
    """C <- alpha op(A) op(B)^H + conj(alpha) op(B) op(A)^H + beta C."""
    ta = Trans.NoTrans if trans == "N" else Trans.ConjTrans
    tb = Trans.ConjTrans if trans == "N" else Trans.NoTrans

    def blk(x, lo, ln):
        return x[lo:lo + ln] if trans == "N" else x[:, lo:lo + ln]

    def two(lo1, ln1, lo2, ln2):
        g = alpha * mm(blk(a, lo1, ln1), blk(b, lo2, ln2), ta=ta, tb=tb)
        return g + jnp.conj(alpha) * mm(blk(b, lo1, ln1), blk(a, lo2, ln2),
                                        ta=ta, tb=tb)

    def rec(c, o, s):
        if s <= nb:
            cb = c[o:o + s, o:o + s]
            return c.at[o:o + s, o:o + s].set(
                set_tri(cb, beta * cb + two(o, s, o, s), lower))
        s1 = _split(s, nb)
        c = rec(c, o, s1)
        c = rec(c, o + s1, s - s1)
        if lower:
            return c.at[o + s1:o + s, o:o + s1].set(
                beta * c[o + s1:o + s, o:o + s1] + two(o + s1, s - s1, o, s1))
        return c.at[o:o + s1, o + s1:o + s].set(
            beta * c[o:o + s1, o + s1:o + s] + two(o, s1, o + s1, s - s1))

    return rec(c, 0, c.shape[0])


# ---------------------------------------------------------------------------
# HEMM — hermitian matrix multiply


def hemm(c, a, b, *, side: str, lower: bool, alpha=1.0, beta=0.0):
    """C <- alpha A B + beta C ('L') or alpha B A + beta C ('R'), A hermitian
    with only the ``lower``/upper triangle stored (reference
    ``multiplication/hermitian/impl.h:68``). Materializing the full hermitian
    operand costs O(n^2) bandwidth and keeps the product one large GEMM.
    """
    full = symmetrize_tri(a, lower)
    prod = mm(full, b) if side == "L" else mm(b, full)
    return alpha * prod + beta * c


# ---------------------------------------------------------------------------
# GEMM


def gemm(c, a, b, *, transa: str = "N", transb: str = "N", alpha=1.0, beta=0.0):
    """C <- alpha op(A) op(B) + beta C (reference ``multiplication/general``)."""
    return alpha * mm(a, b, ta=Trans(transa), tb=Trans(transb)) + beta * c
