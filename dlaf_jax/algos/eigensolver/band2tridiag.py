"""Stage 2: band -> tridiagonal via Householder bulge chasing.

Re-design of the reference's ``band_to_tridiag``
(``eigensolver/band_to_tridiag/mc.h:438-990``): the same sweep/chase
structure (sweep s eliminates column s below the first subdiagonal, then
chases the fill-in bulge down in steps of the bandwidth), but expressed as a
two-level ``fori_loop`` over (sweep, chase) with static-size windowed
two-sided updates, instead of the reference's SweepWorker pipeline with
counting semaphores.

Every reflector (length ``b``) is recorded — the analog of the reference's
``TridiagResult::hh_reflectors`` (``band_to_tridiag/api.h:19``) — so the
back-transformation can be applied to the eigenvectors later
(``bt_band_to_tridiag``).

The matrix is kept as a full symmetric dense array padded by ``3b+2`` on each
side so every dynamic window slice is in-bounds without clamping; entries
outside the real matrix are zero and make the corresponding reflectors no-ops.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ...ops.core import matmul_precision
from ...ops.householder import householder_vector
from ...types import is_complex_dtype


@functools.partial(jax.jit, static_argnames=("b",))
def band_to_tridiag(band_dense, b: int):
    """Reduce a dense symmetric band matrix (bandwidth ``b``) to tridiagonal.

    Returns (d, e, vs, taus): diagonal (n,), subdiagonal (n-1,), recorded
    reflectors vs (nsweeps, ncmax, b) and taus (nsweeps, ncmax) where the
    chase-c reflector of sweep s acts on rows [s + 1 + c*b, s + 1 + (c+1)*b).
    """
    n = band_dense.shape[0]
    if b == 1 or n <= 2:
        d = jnp.diagonal(band_dense)
        e = jnp.diagonal(band_dense, -1)
        vs = jnp.zeros((1, 1, b), band_dense.dtype)
        taus = jnp.zeros((1, 1), band_dense.dtype)
        return jnp.real(d), e, vs, taus

    pad = 3 * b + 2
    npd = n + 2 * pad
    bp = jnp.zeros((npd, npd), band_dense.dtype)
    bp = lax.dynamic_update_slice(bp, band_dense, (pad, pad))

    nsweeps = n - 2
    ncmax = -(-(n - 1) // b)          # ceil((n-1)/b)
    win = 3 * b + 2

    vs0 = jnp.zeros((nsweeps, ncmax, b), band_dense.dtype)
    taus0 = jnp.zeros((nsweeps, ncmax), band_dense.dtype)

    def chase(c, carry):
        s, a, vs, taus = carry
        i0 = s + 1 + c * b                      # reflector rows [i0, i0+b)
        j = jnp.where(c == 0, s, s + 1 + (c - 1) * b)  # column to clean
        i0p = i0 + pad
        jp = j + pad
        x = lax.dynamic_slice(a, (i0p, jp), (b, 1))[:, 0]
        v, tau, beta = householder_vector(x, 0)
        # write the eliminated column: beta at head, zeros below
        newcol = jnp.where(jnp.arange(b) == 0, beta, 0)[:, None]
        a = lax.dynamic_update_slice(a, newcol.astype(a.dtype), (i0p, jp))
        # mirror (symmetric storage)
        newrow = jnp.conj(newcol.T) if is_complex_dtype(a.dtype) else newcol.T
        a = lax.dynamic_update_slice(a, newrow.astype(a.dtype), (jp, i0p))

        # two-sided windowed update on cols/rows (j, j + win]
        w0 = jp + 1
        srow = lax.dynamic_slice(a, (i0p, w0), (b, win))
        srow = srow - tau * v[:, None] * jnp.matmul(
            jnp.conj(v)[None, :], srow, precision=matmul_precision())
        a = lax.dynamic_update_slice(a, srow, (i0p, w0))
        scol = lax.dynamic_slice(a, (w0, i0p), (win, b))
        sv = jnp.matmul(scol, v[:, None], precision=matmul_precision())
        scol = scol - (jnp.conj(tau) if is_complex_dtype(a.dtype) else tau) \
            * sv * jnp.conj(v)[None, :]
        a = lax.dynamic_update_slice(a, scol, (w0, i0p))

        vs = lax.dynamic_update_slice(vs, v[None, None, :], (s, c, 0))
        taus = lax.dynamic_update_slice(taus, tau[None, None], (s, c))
        return s, a, vs, taus

    def sweep(s, carry):
        a, vs, taus = carry
        nc = jnp.maximum(0, -(-(n - 1 - s) // b))  # ceil((n-1-s)/b)
        _, a, vs, taus = lax.fori_loop(0, nc, chase, (s, a, vs, taus))
        return a, vs, taus

    a, vs, taus = lax.fori_loop(0, nsweeps, sweep, (bp, vs0, taus0))
    full = lax.dynamic_slice(a, (pad, pad), (n, n))
    d = jnp.real(jnp.diagonal(full))
    e = jnp.diagonal(full, -1)
    return d, e, vs, taus


# ---------------------------------------------------------------------------
# wavefront-pipelined variant

LAG = 4  # chase-steps between adjacent active sweeps (> window extent / b)


@functools.partial(jax.jit, static_argnames=("b", "lane_chunk"))
def band_to_tridiag_pipelined(band_dense, b: int, lane_chunk: int = 0):
    """Wavefront-pipelined bulge chasing: identical mathematics and reflector
    record as :func:`band_to_tridiag`, but sweeps run LAG chase-steps apart
    so up to ncmax/LAG chases execute per step as ONE batched operation —
    the analog of the reference's pipelined SweepWorker ring
    (``band_to_tridiag/mc.h:568-661``). Sequential steps drop from
    ~n^2/b to ~LAG*n.

    Disjointness: lane w works on rows [i0_w, i0_w + b), window columns
    (j_w, j_w + 3b + 2]; adjacent active lanes are LAG*b - 1 >= 3b + 2 rows
    apart (b >= 3), so all batched gathers/scatters touch disjoint blocks.
    """
    n = band_dense.shape[0]
    dt_ = band_dense.dtype
    if b == 1 or n <= 2 or b < 3:
        return band_to_tridiag(band_dense, b)

    pad = 3 * b + 2
    npd = n + 2 * pad
    a0 = jnp.zeros((npd, npd), dt_)
    a0 = lax.dynamic_update_slice(a0, band_dense, (pad, pad))

    nsweeps = n - 2
    ncmax = -(-(n - 1) // b)
    win = 3 * b + 2
    nlanes = ncmax // LAG + 1
    tsteps = LAG * (nsweeps - 1) + ncmax + 1

    vs0 = jnp.zeros((nsweeps, ncmax, b), dt_)
    taus0 = jnp.zeros((nsweeps, ncmax), dt_)

    grp = lane_chunk if lane_chunk and lane_chunk < nlanes else nlanes
    ngroups = -(-nlanes // grp)

    ar_b = jnp.arange(b)
    ar_w = jnp.arange(win)
    ar_g = jnp.arange(grp)

    conj = (lambda x: jnp.conj(x)) if is_complex_dtype(dt_) else (lambda x: x)

    def group_step(t, g, carry):
        a, vs, taus = carry
        lanes = g * grp + ar_g
        s_w = t // LAG - lanes
        c_w = t - LAG * s_w
        nc_w = jnp.maximum(0, -(-(n - 1 - s_w) // b))
        valid = (s_w >= 0) & (s_w < nsweeps) & (c_w < nc_w)
        i0 = s_w + 1 + c_w * b
        j = jnp.where(c_w == 0, s_w, s_w + 1 + (c_w - 1) * b)
        # invalid lanes are redirected into the top-left zero padding
        # ([0, b) x [0, win+1)), which no valid window ever touches (valid
        # windows live at indices >= pad = 3b+2); their writes below always
        # store back the gathered original, so they are exact no-ops.
        i0p = jnp.where(valid, i0 + pad, 0)
        jp = jnp.where(valid, j + pad, 0)
        w0 = jp + 1

        rows = i0p[:, None] + ar_b[None, :]            # (W, b)
        x = a[rows, jp[:, None]]
        v, tau, beta = jax.vmap(lambda xv: householder_vector(xv, 0))(x)
        tau = jnp.where(valid, tau, 0)
        v = jnp.where(valid[:, None], v, 0)

        # eliminated column + symmetric mirror
        newcol = jnp.where(ar_b[None, :] == 0, beta[:, None], 0).astype(dt_)
        newcol = jnp.where(valid[:, None], newcol, x)
        a = a.at[rows, jp[:, None]].set(newcol)
        a = a.at[jp[:, None], rows].set(conj(newcol))

        # two-sided windowed update, rows then cols (same order as sequential)
        wcols = w0[:, None] + ar_w[None, :]            # (W, win)
        srow = a[rows[:, :, None], wcols[:, None, :]]  # (W, b, win)
        vhs = jnp.einsum("wb,wbc->wc", conj(v), srow,
                         precision=matmul_precision())
        srow = srow - tau[:, None, None] * v[:, :, None] * vhs[:, None, :]
        a = a.at[rows[:, :, None], wcols[:, None, :]].set(srow)

        scol = a[wcols[:, :, None], rows[:, None, :]]  # (W, win, b)
        sv = jnp.einsum("wcb,wb->wc", scol, v, precision=matmul_precision())
        scol = scol - conj(tau)[:, None, None] * sv[:, :, None] * conj(v)[:, None, :]
        a = a.at[wcols[:, :, None], rows[:, None, :]].set(scol)

        # record reflectors (invalid lanes land in slot (0, 0) with tau = 0,
        # v = 0 — harmless only if slot (0,0) is written by its real owner
        # later, so redirect invalid lanes to their own c_w slot of sweep 0,
        # whose chases all happen at t < LAG and are valid; use drop instead)
        s_idx = jnp.where(valid, s_w, nsweeps + 1)
        vs = vs.at[s_idx, c_w].set(v, mode="drop")
        taus = taus.at[s_idx, c_w].set(tau, mode="drop")
        return a, vs, taus

    def step(t, carry):
        # lanes of one time step are independent (disjoint windows); the
        # group loop only exists to cap the batched scatter width
        return lax.fori_loop(0, ngroups,
                             lambda g, c: group_step(t, g, c), carry)

    a, vs, taus = lax.fori_loop(0, tsteps, step, (a0, vs0, taus0))
    full = lax.dynamic_slice(a, (pad, pad), (n, n))
    d = jnp.real(jnp.diagonal(full))
    e = jnp.diagonal(full, -1)
    return d, e, vs, taus


def band_to_tridiag_auto(band_dense, b: int):
    """Kernel selection per tune.band_to_tridiag_kernel (see tune.py):
    "pipelined" runs the batched dense wavefront kernel, "strips" the
    sequential chase on O(n*b) strip storage, "sequential" the dense sweep
    loop."""
    from ...tune import get_tune_parameters
    kind = get_tune_parameters().band_to_tridiag_kernel
    n = band_dense.shape[0]
    if kind == "sequential":
        return band_to_tridiag(band_dense, b)
    if kind == "strips" and b > 1 and n > 2:
        from .band_strips import band_to_strips, band_to_tridiag_strips
        return band_to_tridiag_strips(band_to_strips(band_dense, b), n, b)
    return band_to_tridiag_pipelined(band_dense, b)
