"""Distributed reduction to band over a 2-D device mesh.

Re-design of the reference's distributed ``reduction_to_band``
(``eigensolver/reduction_to_band/impl.h:1112-1463``): the same panel/trailing
split, but with

  - the panel gathered REPLICATED to every rank (an (n, b) strip — cheap)
    instead of the reference's per-rank panel computation with column-comm
    allreduces of norms/x0 (``impl.h:616-689``): each rank runs the identical
    deterministic panel QR, so no reflector broadcast is needed at all;
  - the two-sided trailing update evaluated IN PLACE on the distributed
    shards: W = S V T is formed by one masked local GEMM pair per rank plus
    one mesh-wide scatter-psum (replacing the reference's hemmComputeX
    row+col reduce dance, ``impl.h:691-808``), and the rank-2b update
    A -= V X^H + X V^H is local to every shard;
  - everything lives in ONE shard_map/fori_loop program: the look-ahead and
    round-robin workspaces of the reference (``impl.h:1186-1196``) are
    subsumed by XLA's dataflow scheduling.

Band size may be SMALLER than the distribution block (the reference's
band < nb via retiling, ``matrix/matrix.h:377-432`` + ``get_band_size.h:20``):
panels are ``band``-wide column slabs addressed inside nb-tiles, so a
realistic nb (512) can run with a cheap stage-2 band (64-128).

Work-optimal trailing updates (reference touches only trailing tiles,
``reduction_to_band/impl.h:809-854``): the panel loop is split into static
shrinking-window buckets exactly like the distributed Cholesky — per-step
GEMM cost tracks the trailing size while all shapes stay static.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ...comm import panel
from ...comm.mesh import COL_AXIS, ROW_AXIS
from ...matrix.dist_matrix import DistMatrix
from ...ops.core import ct, matmul_precision
from ...ops.householder import panel_qr, t_factor

N_WINDOW_BUCKETS = 8


def band_window_buckets(npanels: int, band: int, nb: int, Pn: int, Qn: int,
                        nwin: int = N_WINDOW_BUCKETS):
    """Static panel-loop buckets [(k0, k1, offr, offc)]: for every panel k in
    [k0, k1), all rows/cols the step touches lie in the local window starting
    at local tile (offr, offc) on every rank."""
    edges = sorted({min(round(i * npanels / nwin), npanels)
                    for i in range(nwin + 1)})
    buckets = []
    for k0, k1 in zip(edges[:-1], edges[1:]):
        kt0 = (k0 * band) // nb
        offr = max(0, -(-(kt0 - Pn + 1) // Pn))
        offc = max(0, -(-(kt0 - Qn + 1) // Qn))
        buckets.append((k0, k1, offr, offc))
    return buckets


# single audited panel-gather implementation (reference matrix/panel.h:43)
_gather_col_band = panel.gather_col_panel


def _gather_col_block(a, kt, nb, lmt):
    """Local column-tile slab kt -> replicated global (n, nb) block
    (kept for the stage-1 back-transformation's nb-wide panel loads)."""
    return _gather_col_band(a, jnp.asarray(kt, jnp.int32) * nb, nb, nb, lmt)


def _red2band_step(carry, k, *, band, nb, offr, offc, grow, gcol, n, base):
    """One band-panel step on the trailing window (pre-sliced index arrays).

    ``grow``/``gcol`` are the window's global element ids; ``base`` is the
    window's first global row (offr * P * nb); ``n`` the padded global size.
    """
    a, taus = carry
    dt_ = a.dtype
    p = lax.axis_index(ROW_AXIS)
    q = lax.axis_index(COL_AXIS)
    Pn = lax.axis_size(ROW_AXIS)
    Qn = lax.axis_size(COL_AXIS)
    lm, ln = a.shape
    lmt = lm // nb
    n_w = Pn * lmt * nb                              # replicated window rows
    rows_w = base + jnp.arange(n_w)                  # their global ids

    valid_col = gcol < n
    gcol_c = jnp.minimum(gcol, n - 1)
    tril_loc = (grow[:, None] >= gcol[None, :]) & valid_col[None, :]

    j0 = jnp.asarray(k, jnp.int32) * band
    r0 = j0 + band

    # ---- replicated panel QR ------------------------------------------
    panel = _gather_col_band(a, j0, band, nb, lmt, offc)   # (n_w, band)
    panel = jnp.where((rows_w >= r0)[:, None], panel, 0)
    shifted = jnp.roll(panel, -(r0 - base), axis=0)
    v_s, taus_p, r_fac = panel_qr(shifted)
    v = jnp.roll(v_s, r0 - base, axis=0)
    v = jnp.where((rows_w >= r0)[:, None], v, 0)
    t = t_factor(v, taus_p)
    u = jnp.matmul(v, t, precision=matmul_precision())     # (n_w, band)

    # ---- distributed W = S @ U (S = trailing hermitian from tril) -----
    trail = (grow >= r0)[:, None] & (gcol >= r0)[None, :]
    m_loc = jnp.where(trail & tril_loc, a, 0)
    # window-relative ids; cols before the window base (possible on
    # non-square grids) clamp to 0 — their w_cols values are exactly zero
    # (masked m_str column), so the clamped scatter adds nothing
    gcol_w = jnp.clip(gcol_c - base, 0, n_w - 1)
    u_cols = jnp.take(u, gcol_w, axis=0)                   # (ln, band)
    u_rows = jnp.take(u, grow - base, axis=0)              # (lm, band)
    w_rows = jnp.matmul(m_loc, u_cols, precision=matmul_precision())
    strict = trail & tril_loc & (grow[:, None] > gcol[None, :])
    m_str = jnp.where(strict, a, 0)
    w_cols = jnp.matmul(ct(m_str), u_rows, precision=matmul_precision())
    contrib = jnp.zeros((n_w, band), dt_)
    contrib = contrib.at[grow - base].add(w_rows)
    contrib = contrib.at[gcol_w].add(
        jnp.where(valid_col[:, None], w_cols, 0))
    w = lax.psum(lax.psum(contrib, ROW_AXIS), COL_AXIS)

    # ---- X = W - 1/2 V (T^H (V^H W))  (replicated, small) -------------
    vhw = jnp.matmul(ct(v), w, precision=matmul_precision())
    x = w - 0.5 * jnp.matmul(
        v, jnp.matmul(ct(t), vhw, precision=matmul_precision()),
        precision=matmul_precision())

    # ---- local rank-2b trailing update --------------------------------
    v_rows = jnp.take(v, grow - base, axis=0)
    v_cols = jnp.take(v, gcol_w, axis=0)
    x_rows = jnp.take(x, grow - base, axis=0)
    x_cols = jnp.take(x, gcol_w, axis=0)
    upd = (jnp.matmul(v_rows, ct(x_cols), precision=matmul_precision())
           + jnp.matmul(x_rows, ct(v_cols), precision=matmul_precision()))
    a = jnp.where(trail & tril_loc, a - upd, a)

    # ---- write back the panel (R on band block, V strictly below) -----
    head = r0 + jnp.arange(band)
    r_full = jnp.roll(jnp.concatenate(
        [jnp.triu(r_fac), jnp.zeros((n_w - band, band), dt_)], axis=0),
        r0 - base, axis=0)
    newpanel = jnp.where(rows_w[:, None] > head[None, :], v, r_full)
    kt = j0 // nb
    lc = (kt // Qn - offc) * nb + j0 % nb
    cur = lax.dynamic_slice(a, (jnp.int32(0), lc), (lm, band))
    mine = jnp.take(newpanel, grow - base, axis=0)         # (lm, band)
    keep_old = (grow < r0)[:, None]
    merged = jnp.where(keep_old, cur, mine)
    a = lax.dynamic_update_slice(
        a, jnp.where(q == kt % Qn, merged, cur), (jnp.int32(0), lc))

    taus = lax.dynamic_update_slice(taus, taus_p, (j0,))
    return a, taus


def _dist_red2band_shardfn(a4, *, nb, band, npanels):
    a = a4[0, 0]
    p = lax.axis_index(ROW_AXIS)
    q = lax.axis_index(COL_AXIS)
    Pn = lax.axis_size(ROW_AXIS)
    Qn = lax.axis_size(COL_AXIS)
    lm, ln = a.shape
    lmt, lnt = lm // nb, ln // nb
    n = lmt * Pn * nb

    grow = (jnp.arange(lmt) * Pn + p).repeat(nb) * nb + \
        jnp.tile(jnp.arange(nb), lmt)                  # global row element ids
    gcol = (jnp.arange(lnt) * Qn + q).repeat(nb) * nb + \
        jnp.tile(jnp.arange(nb), lnt)

    taus = jnp.zeros((n,), a.dtype)
    for k0, k1, offr, offc in band_window_buckets(npanels, band, nb, Pn, Qn):
        offr = min(offr, lmt - 1)
        offc = min(offc, lnt - 1)
        w = a[offr * nb:, offc * nb:]
        step = functools.partial(
            _red2band_step, band=band, nb=nb, offr=offr, offc=offc,
            grow=grow[offr * nb:], gcol=gcol[offc * nb:], n=n,
            base=offr * Pn * nb)
        w, taus = lax.fori_loop(k0, k1, lambda k, c: step(c, k), (w, taus))
        a = a.at[offr * nb:, offc * nb:].set(w)
    return a[None, None], taus


@functools.partial(jax.jit, static_argnames=("nb", "band", "npanels", "mesh"))
def _dist_red2band(data, *, nb, band, npanels, mesh):
    spec = P(ROW_AXIS, COL_AXIS, None, None)
    fn = jax.shard_map(
        functools.partial(_dist_red2band_shardfn, nb=nb, band=band,
                          npanels=npanels),
        mesh=mesh, in_specs=(spec,), out_specs=(spec, P()),
        check_vma=False)
    return fn(data)


def reduction_to_band_dist(a: DistMatrix, band: int | None = None):
    """Distributed reduction to band (band | block size, band <= nb).

    Returns (packed DistMatrix, taus replicated (n_padded,)).
    """
    nb = a.block_size
    band = band or nb
    assert nb % band == 0, (nb, band)
    m, n = a.dist.size
    assert m == n
    pm = a.dist.padded_size[0]
    npanels = max(pm // band - 1, 0)
    data, taus = _dist_red2band(a.data, nb=nb, band=band, npanels=npanels,
                                mesh=a.grid.mesh)
    return DistMatrix(data, a.dist, a.grid), taus
