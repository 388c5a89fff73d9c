"""Stage 1: reduction of a hermitian matrix to band form.

Re-design of the reference's ``reduction_to_band``
(``eigensolver/reduction_to_band/impl.h:968-1109`` local): blocked Householder
panels of width ``band`` and the compact-WY two-sided trailing update
(W = A V T, X = W - 1/2 V T^H V^H W, A <- A - V X^H - X V^H), with

  - the panel QR vectorized per column instead of the reference's
    multi-threaded reflector computation,
  - the T factor from the closed form (one GEMM + small triangular inverse)
    instead of the per-column gemv sweep,
  - static shapes: every panel step works on masked full-height arrays; the
    dynamic panel offset enters only through masks, rolls and dynamic slices.

Output follows the LAPACK/reference packing: the band stays in the banded
lower triangle of ``a``; the Householder vectors overwrite the annihilated
entries strictly below the band (unit head implicit); ``taus`` (one per
eliminated column) are returned separately (reference ``mat_taus``).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ...ops.core import ct, matmul_precision, symmetrize_tri
from ...ops.householder import panel_qr, t_factor


N_WINDOW_BUCKETS = 8


@functools.partial(jax.jit, static_argnames=("band",))
def reduction_to_band(a, band: int):
    """Reduce hermitian ``a`` (lower stored, n divisible by band) to band
    form. Returns (a_packed, taus) with taus shaped (n,)).

    Work-optimal shrinking windows (reference trailing updates touch only
    trailing tiles, ``reduction_to_band/impl.h:809-854``): the panel loop is
    split into static buckets; within a bucket every step operates on the
    trailing window slice, so per-step GEMM cost tracks the trailing size
    (the masked full-width version burned ~3x the flops).

    HBM-traffic invariant: the trailing window is kept FULLY hermitian
    (both triangles valid; symmetrized once on entry). W = A (V T) then
    needs no per-step symmetrize/mask materialization — V is zero on rows
    < r0, so stale columns never contribute and only W's rows need a cheap
    (nw, b) mask — and the rank-2b update subtracts its (exactly hermitian)
    product over the whole window, which XLA fuses into the GEMM epilogue.
    The previous masked form paid ~3 extra O(nw^2) buffer passes per panel
    (symmetrize + masked copy + masked subtract), making stage 1
    bandwidth-bound at ~5.7 TFLOP/s on a 64 TFLOP/s chip.
    """
    n = a.shape[0]
    b = band
    assert n % b == 0, (n, b)
    npanels = max(n // b - 1, 0)
    a = symmetrize_tri(a, lower=True)       # establish the invariant (once)

    def panel_step(k, carry, *, base):
        a, taus = carry                     # a = trailing window [base:, base:]
        nw = a.shape[0]
        rows = base + jnp.arange(nw)        # global row ids of the window
        j0 = k * b                          # global panel columns [j0, j0+b)
        r0 = j0 + b                         # global reflector row start
        below = rows >= r0

        # --- panel QR ----------------------------------------------------
        panel = lax.dynamic_slice(a, (0, j0 - base), (nw, b))
        panel = jnp.where(below[:, None], panel, 0)
        shifted = jnp.roll(panel, -(r0 - base), axis=0)
        v_s, taus_p, r_fac = panel_qr(shifted)
        v = jnp.roll(v_s, r0 - base, axis=0)     # reflectors, head rows on
        v = jnp.where(below[:, None], v, 0)      # the block diagonal of r0+

        # --- T factor ----------------------------------------------------
        t = t_factor(v, taus_p)

        # --- two-sided trailing update ----------------------------------
        # W = A (V T): V's rows < r0 are zero, so columns of A outside the
        # trailing block contribute nothing; rows < r0 of W are garbage
        # (stale band/reflector rows) and are masked — an (nw, b) mask.
        w = jnp.matmul(a, jnp.matmul(v, t, precision=matmul_precision()),
                       precision=matmul_precision())
        w = jnp.where(below[:, None], w, 0)
        # X = W - 1/2 V (T^H (V^H W))
        vhw = jnp.matmul(ct(v), w, precision=matmul_precision())
        x = w - 0.5 * jnp.matmul(v, jnp.matmul(ct(t), vhw,
                                               precision=matmul_precision()),
                                 precision=matmul_precision())
        # V X^H + X V^H as ONE rank-2b GEMM: [V X] @ [X V]^H — two separate
        # products would each materialize an (nw, nw) buffer (two extra
        # n^2 buffers live at the top of the reduction). The product is
        # hermitian and zero outside rows/cols >= r0, so the unmasked
        # subtraction preserves the symmetric-window invariant.
        upd = jnp.matmul(jnp.concatenate([v, x], axis=1),
                         ct(jnp.concatenate([x, v], axis=1)),
                         precision=matmul_precision())
        a = a - upd

        # --- write back the panel: R on the band block, V strictly below --
        r_full = jnp.roll(jnp.concatenate(
            [jnp.triu(r_fac), jnp.zeros((nw - b, b), a.dtype)], axis=0),
            r0 - base, axis=0)
        # strictly-below-head mask in unshifted coordinates:
        head = r0 + jnp.arange(b)                 # head row of each column
        strict_v = rows[:, None] > head[None, :]
        newpanel = jnp.where(strict_v, v, r_full)
        newpanel = jnp.where(below[:, None], newpanel,
                             lax.dynamic_slice(a, (0, j0 - base), (nw, b)))
        a = lax.dynamic_update_slice(a, newpanel, (0, j0 - base))

        taus = lax.dynamic_update_slice(taus, taus_p, (j0,))
        return a, taus

    taus = jnp.zeros((n,), a.dtype)
    nwin = N_WINDOW_BUCKETS
    edges = sorted({min(round(i * npanels / nwin), npanels)
                    for i in range(nwin + 1)})
    for k0, k1 in zip(edges[:-1], edges[1:]):
        base = k0 * b                        # window: rows/cols >= base
        w = a[base:, base:]
        w, taus = lax.fori_loop(
            k0, k1, lambda k, c: panel_step(k, c, base=base), (w, taus))
        a = a.at[base:, base:].set(w)
    return a, taus


def extract_band(a_packed, band: int):
    """Dense symmetric band matrix from the packed output (both triangles)."""
    n = a_packed.shape[0]
    rows = jnp.arange(n)
    in_band = (rows[:, None] - rows[None, :] <= band) & \
              (rows[:, None] - rows[None, :] >= 0)
    lower_band = jnp.where(in_band, a_packed, 0)
    return lower_band + ct(jnp.tril(lower_band, -1))


def extract_v(a_packed, band: int):
    """Householder panels (strictly below the band) with unit heads restored.

    Returns v (n, n) where column j holds the reflector that eliminated
    column j (head at row j + band, implicit 1 set explicitly).
    """
    n = a_packed.shape[0]
    rows = jnp.arange(n)
    head = rows[None, :] + band
    v = jnp.where(rows[:, None] > head, a_packed, 0)
    v = v + jnp.where(rows[:, None] == head, 1.0, 0).astype(a_packed.dtype)
    return v
