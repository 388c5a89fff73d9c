"""Banded 'strip' storage for stage 2 (band -> tridiagonal).

The reference keeps stage 2 on a re-distributed 1-D *band* layout
(``eigensolver/band_to_tridiag/mc.h:438-662``, ``get_1d_block_size.h:19-21``)
precisely because the working set is O(n*b), not O(n^2). The equivalent
defined here is *strip storage*:

    strips[s]  =  A[s*b : (s+1)*b,  (s-3)*b : (s+2)*b]      shape (b, 5b)

i.e. one dense (b, 5b) slab per block-row holding every stored (lower,
r >= c) entry of that block-row with room for the bulge (bandwidth grows to
at most 2b-1 during chasing) plus alignment slack, zeros elsewhere. Total
memory 5*n*b.

Why this layout: every bulge-chase window becomes a handful of *scalar-start
dynamic slices* (no gathers, no scatters with computed index vectors — contiguous
copies XLA lowers without index arithmetic):
the chase at row i0 touches exactly

    G = A[[i0, i0+2b) x [i0-b, i0+b)]

which lives in strips s0..s0+2 (s0 = i0//b) at per-strip column offset
(i0 mod b) + (2-g)*b, g = 0..2.

Pieces of G (window coordinates, rows [i0, i0+2b), cols [i0-b, i0+b)):
    CY = G[:b, :b]    rows I = [i0, i0+b), cols [i0-b, i0)   <- H @ CY
    S  = G[:b, b:]    rows I, cols I (hermitian diag block)  <- H @ S @ H^H
    B  = G[b:, b:]    rows [i0+b, i0+2b), cols I             <- B @ H^H
with the eliminated column y = CY[:, b-1] (first chase of a sweep, j = i0-1)
or CY[:, 0] (later chases, j = i0-b). All fill-in stays inside G: entries of
columns I live in rows <= i0+2b-1 (bandwidth invariant <= 2b-1).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ...ops.core import ct, matmul_precision
from ...ops.householder import householder_vector
from ...types import is_complex_dtype

STRIP_W = 5  # strip width in units of b: cols [(s-3)*b, (s+2)*b)
COL_BASE = 3  # strip-local column of the diagonal element of its first row


def n_strips(n: int, b: int) -> int:
    """Strip count incl. padding so every chase window is in-bounds."""
    return -(-n // b) + 3


def band_to_strips(band_dense, b: int):
    """(n, n) dense symmetric band matrix -> strip storage.

    Only the lower triangle within the band is read.
    """
    n = band_dense.shape[0]
    ns = n_strips(n, b)
    dt_ = band_dense.dtype
    rows = jnp.arange(n)
    lower = jnp.where((rows[:, None] >= rows[None, :]), band_dense, 0)
    # pad rows to ns*b, cols by 3b on the left / enough on the right
    ap = jnp.zeros((ns * b, 3 * b + ns * b + 2 * b), dt_)
    ap = lax.dynamic_update_slice(ap, lower, (0, 3 * b))

    def body(s, out):
        blk = lax.dynamic_slice(ap, (s * b, s * b), (b, STRIP_W * b))
        return lax.dynamic_update_slice(out, blk[None], (s, 0, 0))

    return lax.fori_loop(0, ns, body, jnp.zeros((ns, b, STRIP_W * b), dt_))


def restripe(strips_nb, nb: int, b: int, ns_out: int):
    """nb-strip storage -> b-strip storage (b | nb); replicated O(n*b) pass.

    The analog of the reference's 1-D block re-distribution between stages 1
    and 2 (``get_1d_block_size.h:19-21``): stage 1 runs on nb-tiles, stage 2
    chases a band of width b < nb.
    """
    assert nb % b == 0
    dt_ = strips_nb.dtype
    out0 = jnp.zeros((ns_out, b, STRIP_W * b), dt_)

    def body(s, out):
        s = jnp.asarray(s, jnp.int32)
        r0 = s * b
        t = r0 // nb
        rl0 = r0 % nb
        # column j=0 of b-strip s is global (s-3)*b = strip-t offset
        # (s-3)*b - (t-3)*nb = rl0 + 3*(nb - b)  (always in [0, 5nb-5b])
        c0 = rl0 + 3 * (nb - b)
        blk = lax.dynamic_slice(strips_nb, (t, rl0, c0),
                                (1, b, STRIP_W * b))[0]
        return lax.dynamic_update_slice(out, blk[None],
                                        (s, jnp.int32(0), jnp.int32(0)))

    # every b-strip start maps inside the nb-strip array (padding strips are
    # zero, and dynamic_slice clamps at the edge onto zero content)
    return lax.fori_loop(0, ns_out, body, out0)


def packed_to_strips(a_packed, band: int, nb: int | None = None):
    """Strip storage directly from the stage-1 packed output (band in the
    banded lower triangle of ``a_packed``; reflectors strictly below are
    masked away). O(n*b) output without materializing a dense band matrix.
    """
    n = a_packed.shape[0]
    b = band
    ns = n_strips(n, b)
    dt_ = a_packed.dtype
    ap = jnp.zeros((ns * b, 3 * b + ns * b + 2 * b), dt_)
    ap = lax.dynamic_update_slice(ap, a_packed, (0, 3 * b))

    def body(s, out):
        blk = lax.dynamic_slice(ap, (s * b, s * b), (b, STRIP_W * b))
        # keep only the band: global (r, c) with 0 <= r - c <= b
        r = s * b + jnp.arange(b)[:, None]
        c = (s - COL_BASE) * b + jnp.arange(STRIP_W * b)[None, :]
        blk = jnp.where((r >= c) & (r - c <= b), blk, 0)
        return lax.dynamic_update_slice(out, blk[None], (s, 0, 0))

    return lax.fori_loop(0, ns, body, jnp.zeros((ns, b, STRIP_W * b), dt_))


def strips_extract_tridiag(strips, n: int, b: int):
    """(d, e) of the tridiagonal matrix left in strip storage."""
    ns = strips.shape[0]
    i = jnp.arange(b)
    dfull = strips[:, i, i + COL_BASE * b].reshape(ns * b)       # A[r, r]
    efull = strips[:, i, i + COL_BASE * b - 1].reshape(ns * b)   # A[r, r-1]
    return jnp.real(dfull[:n]), efull[1:n]


def _chase_window(strips, i0, b: int):
    """Gather the (2b, 2b) window G at reflector row i0 plus the raw 3-strip
    slab (for the write-back) and the slab row offset."""
    z = jnp.int32(0)
    s0 = jnp.asarray(i0 // b, jnp.int32)
    im = jnp.asarray(i0 - s0 * b, jnp.int32)
    blks = [lax.dynamic_slice(strips, (s0 + g, z, im + (2 - g) * b),
                              (1, b, 2 * b))[0] for g in range(3)]
    s3 = jnp.concatenate(blks, axis=0)          # (3b, 2b): rows [s0*b, s0*b+3b)
    g_ = lax.dynamic_slice(s3, (im, z), (2 * b, 2 * b))
    return g_, s3, im


def _chase_scatter(strips, g_new, s3, im, i0, b: int):
    """Write the updated window back into strip storage."""
    z = jnp.int32(0)
    s0 = jnp.asarray(i0 // b, jnp.int32)
    im = jnp.asarray(im, jnp.int32)
    s3 = lax.dynamic_update_slice(s3, g_new, (im, z))
    for g in range(3):
        strips = lax.dynamic_update_slice(
            strips, s3[g * b:(g + 1) * b][None],
            (s0 + g, z, im + (2 - g) * b))
    return strips


def chase_math(g_, first: bool, b: int):
    """One bulge-chase on the dense window ``g_`` (2b, 2b).

    Returns (g_new, v, tau). ``first`` selects the eliminated column
    (j = i0-1 for the first chase of a sweep, j = i0-b afterwards).
    """
    dt_ = g_.dtype
    conj = (lambda x: jnp.conj(x)) if is_complex_dtype(dt_) else (lambda x: x)
    y_col = b - 1 if first else 0
    y = g_[:b, y_col]
    v, tau, beta = householder_vector(y, 0)

    cy = g_[:b, :b]
    s_ = g_[:b, b:]
    b_ = g_[b:, b:]
    s_full = s_ + ct(jnp.tril(s_, -1))

    vh_cy = jnp.matmul(conj(v)[None, :], cy, precision=matmul_precision())
    cy = cy - tau * v[:, None] * vh_cy
    # eliminated column: beta at the head, zeros below (LAPACK larfg exact)
    ycol_mask = jnp.arange(b)[None, :] == y_col
    newy = jnp.where(jnp.arange(b) == 0, beta, 0).astype(dt_)
    cy = jnp.where(ycol_mask, newy[:, None], cy)

    vh_s = jnp.matmul(conj(v)[None, :], s_full, precision=matmul_precision())
    s1 = s_full - tau * v[:, None] * vh_s
    s1v = jnp.matmul(s1, v[:, None], precision=matmul_precision())
    s2 = s1 - conj(tau) * s1v * conj(v)[None, :]

    bv = jnp.matmul(b_, v[:, None], precision=matmul_precision())
    b2 = b_ - conj(tau) * bv * conj(v)[None, :]

    g_new = jnp.concatenate([
        jnp.concatenate([cy, jnp.tril(s2)], axis=1),
        jnp.concatenate([g_[b:, :b], b2], axis=1)], axis=0)
    return g_new, v, tau


# ---------------------------------------------------------------------------
# wavefront (pipelined) chasing: the parallel schedule behind the
# compute-distributed stage 2 (reference SweepWorkerDist handoff,
# eigensolver/band_to_tridiag/mc.h:568-661).
#
# Chase (s, c) runs at wavefront time t = 3s + c.  Concurrent chases then
# differ in i0 = s + 1 + c*b by multiples of 3b-1, so their (2b x 2b)
# windows are element-disjoint, and every ordered pair of *overlapping*
# chases ((s+1, c') overlaps (s, c) iff c' - c in {-2..1}) executes in
# sequential-prefix order (t' - t = 3 + c' - c >= 1) — the pipelined result
# is bit-identical to the sequential sweep loop.


def wavefront_nsteps(n: int, b: int) -> int:
    nsweeps = max(n - 2, 1)
    ncmax = -(-(n - 1) // b)
    return 3 * (nsweeps - 1) + ncmax


def wavefront_k(S: int, b: int) -> int:
    """Upper bound on concurrent chases inside a segment of S strips."""
    return (S * b) // (3 * b - 1) + 2


def chase_wavefront_step(ext, vs, taus, t, *, n, b, S, seg0, K):
    """Execute every wavefront-``t`` chase whose i0 lies in strip rows
    [seg0*b, (seg0+S)*b) on the extended local strip array ``ext``
    ((S+2, b, 5b): strips seg0 .. seg0+S+1, the last two a right halo).

    Records reflectors segment-locally: sweep s's chases inside this
    segment land at vs[s, c - c_lo(s)] with
    c_lo(s) = max(0, seg0 - (s+1)//b); vs has a discard row at index
    nsweeps for masked slots.  Returns (ext, vs, taus).
    """
    nsweeps = n - 2
    lo = seg0 * b
    hi = (seg0 + S) * b
    t = jnp.asarray(t, jnp.int32)
    # i0(s) = t*b + 1 + s*(1 - 3b) is decreasing in s; the smallest active
    # s in this segment satisfies i0 < hi
    s_min = (t * b + 1 - hi) // (3 * b - 1) + 1

    def body(k, carry):
        ext, vs, taus = carry
        s = s_min + jnp.asarray(k, jnp.int32)
        c = t - 3 * s
        i0 = s + 1 + c * b
        nc = -(-(n - 1 - s) // b)
        valid = (s >= 0) & (s < nsweeps) & (c >= 0) & (c < nc) & \
            (i0 >= lo) & (i0 < hi)
        i0l = jnp.clip(i0 - lo, 0, S * b - 1)
        g_, s3, im = _chase_window(ext, i0l, b)
        g0, v0, tau0 = chase_math(g_, first=True, b=b)
        g1, v1, tau1 = chase_math(g_, first=False, b=b)
        isfirst = c == 0
        g_new = jnp.where(isfirst, g0, g1)
        v = jnp.where(isfirst, v0, v1)
        tau = jnp.where(isfirst, tau0, tau1)
        g_new = jnp.where(valid, g_new, g_)
        v = jnp.where(valid, v, 0)
        tau = jnp.where(valid, tau, 0)
        ext = _chase_scatter(ext, g_new, s3, im, i0l, b)
        c_lo = jnp.maximum(0, seg0 - (s + 1) // b)
        discard = vs.shape[0] - 1
        srec = jnp.where(valid, jnp.clip(s, 0, discard), discard)
        crec = jnp.clip(c - c_lo, 0, vs.shape[1] - 1)
        vs = lax.dynamic_update_slice(vs, v[None, None, :],
                                      (srec, crec, jnp.int32(0)))
        taus = lax.dynamic_update_slice(taus, tau[None, None], (srec, crec))
        return ext, vs, taus

    return lax.fori_loop(0, K, body, (ext, vs, taus))


@functools.partial(jax.jit, static_argnames=("n", "b"))
def band_to_tridiag_wavefront(strips, n: int, b: int):
    """Single-device wavefront-scheduled chase: same result as
    :func:`band_to_tridiag_strips`, but executed on the t = 3s + c pipeline
    schedule (the schedule the distributed chase runs per segment)."""
    ns = strips.shape[0]
    dt_ = strips.dtype
    nsweeps = n - 2
    ncmax = -(-(n - 1) // b)
    ext = jnp.concatenate([strips, jnp.zeros((2, b, STRIP_W * b), dt_)])
    vs0 = jnp.zeros((nsweeps + 1, ncmax, b), dt_)
    taus0 = jnp.zeros((nsweeps + 1, ncmax), dt_)
    K = wavefront_k(ns, b)

    def step(t, carry):
        ext, vs, taus = carry
        return chase_wavefront_step(ext, vs, taus, t, n=n, b=b, S=ns,
                                    seg0=0, K=K)

    ext, vs, taus = lax.fori_loop(0, wavefront_nsteps(n, b), step,
                                  (ext, vs0, taus0))
    d, e = strips_extract_tridiag(ext[:ns], n, b)
    return d, e, vs[:nsweeps], taus[:nsweeps]


@functools.partial(jax.jit, static_argnames=("n", "b", "sweep_chunk"))
def band_to_tridiag_strips(strips, n: int, b: int, sweep_lo=0,
                           sweep_chunk: int | None = None):
    """Sequential bulge chasing on strip storage.

    Same sweep/chase schedule and recorded-reflector layout as the dense
    kernel (see :mod:`band2tridiag`): returns (d, e, vs, taus) with
    vs (nsweeps, ncmax, b), taus (nsweeps, ncmax); the chase-c reflector of
    sweep s acts on rows [s + 1 + c*b, s + 1 + (c+1)*b).

    With ``sweep_chunk`` only sweeps [sweep_lo, sweep_lo + sweep_chunk) are
    *recorded* (vs/taus leading dim = sweep_chunk; the chasing itself always
    runs all sweeps) — the distributed driver shards the O(n^2) reflector
    record over devices this way while the O(n*b) band stays replicated.
    ``sweep_lo`` may be traced (e.g. a mesh axis index).
    """
    dt_ = strips.dtype
    nsweeps = n - 2
    ncmax = -(-(n - 1) // b)
    nrec = nsweeps if sweep_chunk is None else sweep_chunk
    vs0 = jnp.zeros((nrec + 1, ncmax, b), dt_)    # last row = discard slot
    taus0 = jnp.zeros((nrec + 1, ncmax), dt_)
    lo = jnp.asarray(sweep_lo, jnp.int32)

    def chase(c, carry):
        s, strips, vs, taus = carry
        c = jnp.asarray(c, jnp.int32)   # fori index dtype varies under x64
        i0 = s + 1 + c * b
        g_, s3, im = _chase_window(strips, i0, b)
        g0, v0, tau0 = chase_math(g_, first=True, b=b)
        g1, v1, tau1 = chase_math(g_, first=False, b=b)
        isfirst = c == 0
        g_new = jnp.where(isfirst, g0, g1)
        v = jnp.where(isfirst, v0, v1)
        tau = jnp.where(isfirst, tau0, tau1)
        strips = _chase_scatter(strips, g_new, s3, im, i0, b)
        srec = jnp.clip(s - lo, -1, nrec) % (nrec + 1)    # out of range -> nrec
        vs = lax.dynamic_update_slice(vs, v[None, None, :],
                                      (srec, c, jnp.int32(0)))
        taus = lax.dynamic_update_slice(taus, tau[None, None], (srec, c))
        return s, strips, vs, taus

    def sweep(s, carry):
        strips, vs, taus = carry
        s = jnp.asarray(s, jnp.int32)
        nc = jnp.maximum(0, -(-(n - 1 - s) // b))
        _, strips, vs, taus = lax.fori_loop(0, nc, chase, (s, strips, vs, taus))
        return strips, vs, taus

    strips, vs, taus = lax.fori_loop(0, nsweeps, sweep, (strips, vs0, taus0))
    d, e = strips_extract_tridiag(strips, n, b)
    return d, e, vs[:nrec], taus[:nrec]
