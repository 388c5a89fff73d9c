"""Householder panel factorization and compact-WY T factor.

Building blocks for the two-stage eigensolver, replacing the reference's
panel-reflector computation (``eigensolver/reduction_to_band/impl.h:296-361``)
and QR T-factor (``factorization/qr/t_factor_impl.h``):

  - ``panel_qr``: unblocked Householder QR of an (m, b) panel, LAPACK
    conventions (v[head] = 1 implicit, tau scalars), fully vectorized per
    step via index masks — no dynamic gather/scatter, so it lowers to
    plain elementwise code.
  - ``t_factor``: T = inv(diag(1/tau) + striu(V^H V)) — a single GEMM
    plus a small triangular inverse, instead of the reference's per-column
    gemv sweep.
  - ``tri_inv``: recursive blocked triangular inverse.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from .core import mm
from ..types import is_complex_dtype, real_dtype


def _sign_phase(x0, dtype):
    """Phase factor used for the Householder head: real sign / complex phase
    (maps x0 to the negative real axis like LAPACK larfg)."""
    if is_complex_dtype(dtype):
        mag = jnp.abs(x0)
        return jnp.where(mag == 0, jnp.ones_like(x0), x0 / jnp.where(mag == 0, 1.0, mag))
    return jnp.where(x0 >= 0, 1.0, -1.0).astype(dtype)


def householder_vector(x, head: int = 0):
    """Reflector (v, tau, beta) with H x = beta e_head, v[head] = 1.

    ``x`` entries before ``head`` are ignored (assumed zero by the caller).
    """
    dtype = x.dtype
    n = x.shape[0]
    idx = jnp.arange(n)
    xm = jnp.where(idx >= head, x, 0)
    x0 = xm[head]
    normx = jnp.sqrt(jnp.sum(jnp.abs(xm) ** 2).astype(real_dtype(dtype)))
    phase = _sign_phase(x0, dtype)
    beta = (-phase * normx).astype(dtype)
    denom = x0 - beta
    safe = jnp.abs(denom) > 0
    v = jnp.where(idx > head, xm / jnp.where(safe, denom, 1.0), 0)
    v = jnp.where(idx == head, 1.0, v)
    tau = jnp.where(safe, (beta - x0) / beta, 0.0).astype(dtype)
    # LAPACK: tau = (beta - x0)/beta for the v/(x0-beta) normalization
    return v, tau, jnp.where(safe, beta, x0)


def panel_qr(panel):
    """Householder QR of an (m, b) panel.

    Returns (v, taus, r): ``v`` (m, b) unit-lower-trapezoidal reflectors
    (ones on the diagonal, zeros above), ``taus`` (b,), ``r`` (b, b) upper
    triangular factor.
    """
    m, b = panel.shape
    dtype = panel.dtype
    rows = jnp.arange(m)

    def step(t, carry):
        a, v, taus = carry
        colmask = jnp.arange(b) == t
        x = jnp.sum(jnp.where(colmask[None, :], a, 0), axis=1)   # column t
        vt, tau, beta = householder_vector(x, t)
        # apply H = I - tau v v^H to the remaining columns (masked >= t)
        w = jnp.sum(jnp.conj(vt)[:, None] * a, axis=0)           # v^H A  (b,)
        w = jnp.where(jnp.arange(b) >= t, w, 0)
        a = a - tau * vt[:, None] * w[None, :]
        # column t of a now holds (r_0..r_{t-1} already, beta at t, 0 below)
        a = jnp.where(colmask[None, :] & (rows == t)[:, None], beta, a)
        a = jnp.where(colmask[None, :] & (rows > t)[:, None], 0, a)
        v = jnp.where(colmask[None, :], vt[:, None], v)
        taus = jnp.where(colmask, tau, taus)
        return a, v, taus

    v0 = jnp.zeros_like(panel)
    taus0 = jnp.zeros((b,), dtype)
    a, v, taus = lax.fori_loop(0, min(m, b), step, (panel, v0, taus0))
    r = jnp.triu(a[:b]) if m >= b else jnp.triu(a)
    return v, taus, r


def tri_inv(a, lower: bool = True, nb: int = 64):
    """Inverse of a triangular matrix by blocked recursion:
    inv([[A,0],[B,C]]) = [[iA,0],[-iC B iA, iC]]."""
    n = a.shape[0]
    if n <= nb:
        eye = jnp.eye(n, dtype=a.dtype)
        return lax.linalg.triangular_solve(a, eye, left_side=True, lower=lower)
    n1 = max(n // (2 * nb), 1) * nb
    if lower:
        ia = tri_inv(a[:n1, :n1], True, nb)
        ic = tri_inv(a[n1:, n1:], True, nb)
        off = -mm(ic, mm(a[n1:, :n1], ia))
        top = jnp.concatenate([ia, jnp.zeros((n1, n - n1), a.dtype)], axis=1)
        bot = jnp.concatenate([off, ic], axis=1)
        return jnp.concatenate([top, bot], axis=0)
    ia = tri_inv(a[:n1, :n1], False, nb)
    ic = tri_inv(a[n1:, n1:], False, nb)
    off = -mm(ia, mm(a[:n1, n1:], ic))
    top = jnp.concatenate([ia, off], axis=1)
    bot = jnp.concatenate([jnp.zeros((n - n1, n1), a.dtype), ic], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def t_factor(v, taus):
    """Compact-WY T (upper triangular, b x b) with Q = I - V T V^H.

    Uses the closed form T^{-1} = diag(1/tau) + striu(V^H V): one GEMM
    plus a b x b triangular inverse — the GEMM-shaped replacement for the
    reference's column-sweep larft (``factorization/qr/t_factor_impl.h``).
    Columns with tau == 0 (no reflector) yield zero rows/cols in T.
    """
    b = v.shape[1]
    g = mm(v, v, ta="C")                       # V^H V
    su = jnp.triu(g, 1)
    safe_tau = jnp.where(taus == 0, 1.0, taus)
    tinv = su + jnp.diag(1.0 / safe_tau)
    t = tri_inv(tinv, lower=False, nb=64)
    active = taus != 0
    t = jnp.where(active[:, None] & active[None, :], t, 0)
    return t
