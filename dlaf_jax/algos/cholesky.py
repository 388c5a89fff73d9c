"""Distributed tiled Cholesky factorization (POTRF).

Re-design of the reference's distributed right-looking Cholesky
(``factorization/cholesky/impl.h:192-313``): the same k-loop over diagonal
tiles, but expressed as one SPMD program over a 2-D device mesh:

  - diagonal-tile broadcast down the grid column -> masked ``psum`` over both
    axes (reference ``impl.h:241-251`` col-comm ``MPI_Ibcast``),
  - panel TRSM on the owning grid column -> local slab solve + row-broadcast
    (reference ``impl.h:253-270``, ``broadcast_panel.h:61,125``),
  - transposed-panel redistribution -> ``all_gather`` over the row axis
    (reference's transposed Panel with StoreTransposed),
  - trailing HERK/GEMM -> one masked local GEMM per rank per step.

The reference's look-ahead/round-robin-workspace machinery is unnecessary:
XLA overlaps the collectives of step k+1 with the trailing GEMM of step k by
dataflow. Static shapes are kept by masking with global row/col indices.

Work-optimal trailing updates (reference touches only trailing tiles,
``factorization/cholesky/impl.h:273-300``): the k-loop is split into a small
static number of buckets; within a bucket every step operates on a
statically-sliced trailing window of the local shard, so the per-step GEMM
cost shrinks proportionally to the trailing size (within the bucket
granularity) while every shape stays static for XLA.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ..comm import collectives as coll, panel
from ..comm.mesh import COL_AXIS, ROW_AXIS
from ..matrix.dist_matrix import DistMatrix
from ..ops import leaf
from ..ops.core import ct, matmul_precision
from ..ops.householder import tri_inv
from ..tune import get_tune_parameters

N_WINDOW_BUCKETS = 8


def window_buckets(nrt: int, Pn: int, Qn: int, nwin: int = N_WINDOW_BUCKETS,
                   stride: int = 1):
    """Static k-loop buckets [(k0, k1, offr, offc)]: for every k in
    [k0, k1), all tiles at global index >= k*stride are inside the local
    window starting at local tile (offr, offc) on every rank (``stride`` =
    tiles per loop step, e.g. the wide-panel width)."""
    edges = sorted({min(round(i * nrt / nwin), nrt) for i in range(nwin + 1)})
    buckets = []
    for k0, k1 in zip(edges[:-1], edges[1:]):
        kt0 = k0 * stride
        offr = max(0, -(-(kt0 - Pn + 1) // Pn))
        offc = max(0, -(-(kt0 - Qn + 1) // Qn))
        buckets.append((k0, k1, offr, offc))
    return buckets


def _tile_step(a, kt, *, nb, offr, offc, row_tile, col_tile,
               pl_lc0, pl_w, pl_end, valid):
    """Factor tile kt, solve its panel, and update ONLY the remaining panel
    columns (the contiguous ``pl_w`` local tiles from local tile ``pl_lc0``).
    Returns (a, w, wtT): the solved below-rows panel (lm, nb) and its
    TRANSPOSED (+ conjugated) extraction (nb, ln), both zeroed when
    ``valid`` is false — ready for the wide trailing GEMM. The transposed
    panel is stored (nb, ln) so every GEMM is a plain NN matmul: NT
    contractions make XLA's layout assignment flip the whole in-place
    update chain to column-major, inserting full-matrix relayout copies.
    """
    p = lax.axis_index(ROW_AXIS)
    q = lax.axis_index(COL_AXIS)
    Pn = lax.axis_size(ROW_AXIS)
    Qn = lax.axis_size(COL_AXIS)
    lm, ln = a.shape

    owner_p = kt % Pn
    owner_q = kt % Qn
    lk_r = kt // Pn - offr
    lk_c = kt // Qn - offc

    # 1. factor the diagonal tile and broadcast it (non-owners compute junk
    #    that the masked psum discards; invalid tail tiles factor identity)
    tile = lax.dynamic_slice(a, (lk_r * nb, lk_c * nb), (nb, nb))
    tile = jnp.where(valid, tile, jnp.eye(nb, dtype=a.dtype))
    lkk = leaf.potrf_leaf(tile)
    lkk = coll.bcast2d(lkk, (owner_p, owner_q), (ROW_AXIS, COL_AXIS))

    # 2. panel solve on the owning grid column: slab <- slab * Lkk^-H.
    #    One tile-scope inverse + ONE wide GEMM (same inverted-diagonal
    #    scheme and scope as the local path, ops/blocked.py potrf_lower) —
    #    a leaf-blocked trsm here shreds the solve into nb/leaf narrow GEMMs.
    slab = lax.dynamic_slice(a, (0, lk_c * nb), (lm, nb))
    solved = jnp.matmul(slab, ct(tri_inv(lkk, lower=True, nb=64)),
                        precision=matmul_precision())
    below = valid & (row_tile.repeat(nb) > kt)[:, None]
    newslab = jnp.where(below, solved, slab)
    cur = lax.dynamic_slice(newslab, (lk_r * nb, 0), (nb, nb))
    # write only the lower triangle of the factored tile; its strict upper
    # keeps the original content (reference potrf tile semantics)
    merged = jnp.where(jnp.tril(jnp.ones((nb, nb), jnp.bool_)), lkk, cur)
    newslab = lax.dynamic_update_slice(
        newslab, jnp.where(valid & (p == owner_p), merged, cur), (lk_r * nb, 0))
    a = lax.dynamic_update_slice(
        a, jnp.where(valid & (q == owner_q), newslab, slab), (0, lk_c * nb))

    # 3. broadcast the solved panel along the row axis (reference
    #    broadcast_panel col->rows): W holds L(i, kt) for local row tiles i>kt
    wl = jnp.where(below, newslab, jnp.zeros_like(newslab))
    w = coll.bcast(jnp.where(q == owner_q, wl, jnp.zeros_like(wl)),
                   owner_q, COL_AXIS)

    # 4. transposed panel: every rank needs L(j, kt) for its local col tiles
    #    (reference transposed Panel broadcast, broadcast_panel.h:125). Window
    #    row index t maps to global tile t + offr * P; out-of-range col_tile
    #    entries (padding / non-trailing tiles) rely on the clamp-into-padding
    #    invariant documented in comm/panel.py — the masks below discard them.
    lmt = lm // nb
    wtT = panel.take_tiles(panel.all_tiles(w, ROW_AXIS, nb),
                           col_tile - offr * Pn)
    wtT = jnp.conj(wtT.transpose(2, 0, 1).reshape(nb, ln))
    wtT = jnp.where(valid & (col_tile.repeat(nb) > kt)[None, :], wtT,
                    jnp.zeros_like(wtT))

    # 5. panel-restricted trailing update (k = nb, O(n * wt*nb) work): the
    #    wide k = wt*nb update of everything right of the panel happens once
    #    per panel in the caller
    # the tail panel can reach past the padded local tiles: clamp the slab
    # start (valid panel columns provably stay inside the clamped slab) and
    # mask non-panel columns out of the update
    lnt_w = ln // nb
    pl_lc0 = jnp.minimum(jnp.asarray(pl_lc0, jnp.int32), lnt_w - pl_w)
    pc0 = pl_lc0 * nb
    z = jnp.zeros((), jnp.int32)
    pslab = lax.dynamic_slice(a, (z, pc0), (lm, pl_w * nb))
    wt_p = lax.dynamic_slice(wtT, (z, pc0), (nb, pl_w * nb))
    upd = jnp.matmul(w, wt_p, precision=matmul_precision())
    colt_all = col_tile.repeat(nb)
    colg_all = colt_all * nb + jnp.tile(jnp.arange(nb), lnt_w)
    colg_p = lax.dynamic_slice(colg_all, (pc0,), (pl_w * nb,))
    colt_p = lax.dynamic_slice(colt_all, (pc0,), (pl_w * nb,))
    rowg_el = row_tile.repeat(nb) * nb + jnp.tile(jnp.arange(nb), lmt)
    mask = (rowg_el[:, None] >= colg_p[None, :]) & \
        (colt_p < pl_end)[None, :]
    pslab = pslab - jnp.where(mask, upd, 0)
    a = lax.dynamic_update_slice(a, pslab, (z, pc0))
    return a, w, wtT


def _tile_step_static(pan, kt, *, nb, lnt, offr, pl_c0, pl_c1, pl_end,
                      row_tile, col_tile, glob_row, glob_col):
    """Unrolled-panel tile step on the extracted PANEL BUFFER ``pan`` (the
    window rows x the panel's local columns [pl_c0, pl_c1)): ``kt`` and the
    window offsets are Python ints, so every slice is static and the
    trailing structure is exact. The caller extracts ``pan`` from the local
    shard once per wide panel and writes it back once — each tile step
    updating the full shard directly made XLA's layout assignment flip the
    O(n^2) buffer between row- and column-major across the tail writes
    (full-matrix relayout copies).

    Returns (pan, w, wtT): the updated panel buffer, the solved below-rows
    panel (window rows, nb), and its TRANSPOSED (+ conjugated) extraction
    (nb, cols-from-pl_c0) ready for the wide trailing GEMM (stored
    transposed so every GEMM is a plain NN matmul).
    """
    p = lax.axis_index(ROW_AXIS)
    q = lax.axis_index(COL_AXIS)
    Pn = lax.axis_size(ROW_AXIS)
    Qn = lax.axis_size(COL_AXIS)
    owner_p, owner_q = kt % Pn, kt % Qn
    lk_r, lk_c = kt // Pn, kt // Qn
    r0 = offr * nb
    jc = (lk_c - pl_c0) * nb           # panel-local column offset
    c0, c1 = (lk_r - offr) * nb, (lk_r - offr + 1) * nb

    # 1. factor + 2-D broadcast of the diagonal tile (non-owners factor
    #    junk that the masked psum discards)
    tile = pan[c0:c1, jc:jc + nb]
    lkk = leaf.potrf_leaf(tile)
    lkk = coll.bcast2d(lkk, (owner_p, owner_q), (ROW_AXIS, COL_AXIS))

    # 2. panel solve on the owning grid column (window rows only): one
    #    tile-scope inverse + ONE wide GEMM (local-path inverted-diagonal
    #    scheme, ops/blocked.py potrf_lower)
    slab = pan[:, jc:jc + nb]
    solved = jnp.matmul(slab, ct(tri_inv(lkk, lower=True, nb=64)),
                        precision=matmul_precision())
    below = (row_tile[offr:].repeat(nb) > kt)[:, None]
    newslab = jnp.where(below, solved, slab)
    cur = newslab[c0:c1]
    merged = jnp.where(jnp.tril(jnp.ones((nb, nb), jnp.bool_)), lkk, cur)
    newslab = newslab.at[c0:c1].set(jnp.where(p == owner_p, merged, cur))
    pan = pan.at[:, jc:jc + nb].set(jnp.where(q == owner_q, newslab, slab))

    # 3. row-axis broadcast of the solved panel
    wl = jnp.where(below, newslab, jnp.zeros_like(newslab))
    w = coll.bcast(jnp.where(q == owner_q, wl, jnp.zeros_like(wl)),
                   owner_q, COL_AXIS)

    # 4. transposed panel for local cols >= the panel start (clamp-into-
    #    padding invariant: junk rows are masked by col_tile > kt; padding
    #    col tiles update only padding columns)
    wtT = panel.take_tiles(panel.all_tiles(w, ROW_AXIS, nb),
                           col_tile[pl_c0:] - offr * Pn)
    wtT = jnp.conj(wtT.transpose(2, 0, 1).reshape(nb, (lnt - pl_c0) * nb))
    wtT = jnp.where((col_tile[pl_c0:].repeat(nb) > kt)[None, :], wtT,
                    jnp.zeros_like(wtT))

    # 5. panel-restricted rank-nb trailing update, on the statically
    #    remaining panel cols only: min over ranks q of the first local tile
    #    holding a global tile > kt is floor((kt+1)/Q)
    pu_c0 = max(pl_c0, (kt + 1) // Qn)
    if pu_c0 < pl_c1:
        o = (pu_c0 - pl_c0) * nb
        pw = (pl_c1 - pl_c0) * nb
        ych = wtT[:, o:pw]
        upd = jnp.matmul(w, ych, precision=matmul_precision())
        mask = (glob_row[r0:, None] >=
                glob_col[None, pu_c0 * nb:pl_c1 * nb]) & \
            (col_tile[pu_c0:pl_c1].repeat(nb) < pl_end)[None, :]
        po = (pu_c0 - pl_c0) * nb
        pan = pan.at[:, po:].set(pan[:, po:] - jnp.where(mask, upd, 0))
    return pan, w, wtT


def _tile_step_static_u(pan, kt, *, nb, lmt, offc, pl_r0, pl_r1, pl_end,
                        row_tile, col_tile, glob_row, glob_col):
    """Upper-uplo mirror of :func:`_tile_step_static` (A = U^H U): panels are
    block ROWS, the panel solve is a LEFT solve U_kj = U_kk^-H A_kj, the
    solved row panel broadcasts down the grid COLUMN, and the trailing
    update subtracts U(kt,i)^H U(kt,j) on the stored upper triangle —
    the native distributed ``call_U`` the reference implements at
    ``factorization/cholesky/impl.h:351`` (U used to
    pay an O(n^2) transpose round-trip at the API layer).

    ``pan`` is the extracted panel buffer: the panel's local rows
    [pl_r0, pl_r1) x the window's local columns [offc, lnt).
    """
    p = lax.axis_index(ROW_AXIS)
    q = lax.axis_index(COL_AXIS)
    Pn = lax.axis_size(ROW_AXIS)
    Qn = lax.axis_size(COL_AXIS)
    owner_p, owner_q = kt % Pn, kt % Qn
    lk_r, lk_c = kt // Pn, kt // Qn
    c0g = offc * nb
    jr = (lk_r - pl_r0) * nb           # panel-local row offset
    d0, d1 = (lk_c - offc) * nb, (lk_c - offc + 1) * nb

    # 1. factor + 2-D broadcast of the diagonal tile
    tile = pan[jr:jr + nb, d0:d1]
    ukk = leaf.potrf_leaf(tile, upper=True)
    ukk = coll.bcast2d(ukk, (owner_p, owner_q), (ROW_AXIS, COL_AXIS))

    # 2. row-panel solve on the owning grid row (window cols only):
    #    U_kj = U_kk^-H A_kj as ONE wide GEMM
    slab = pan[jr:jr + nb, :]
    solved = jnp.matmul(ct(tri_inv(ukk, lower=False, nb=64)), slab,
                        precision=matmul_precision())
    right = (col_tile[offc:].repeat(nb) > kt)[None, :]
    newslab = jnp.where(right, solved, slab)
    cur = newslab[:, d0:d1]
    merged = jnp.where(jnp.triu(jnp.ones((nb, nb), jnp.bool_)), ukk, cur)
    newslab = newslab.at[:, d0:d1].set(jnp.where(q == owner_q, merged, cur))
    pan = pan.at[jr:jr + nb, :].set(jnp.where(p == owner_p, newslab, slab))

    # 3. column-axis broadcast of the solved row panel
    wl = jnp.where(right, newslab, jnp.zeros_like(newslab))
    w = coll.bcast(jnp.where(p == owner_p, wl, jnp.zeros_like(wl)),
                   owner_p, ROW_AXIS)

    # 4. transposed panel for local rows >= the panel start: block row i
    #    holds U(kt, i)^H (clamp-into-padding invariant as in the L path)
    wt = panel.take_tiles(panel.all_tiles(w, COL_AXIS, nb),
                          row_tile[pl_r0:] - offc * Qn)
    wt = jnp.conj(wt.transpose(0, 2, 1)).reshape((lmt - pl_r0) * nb, nb)
    wt = jnp.where((row_tile[pl_r0:].repeat(nb) > kt)[:, None], wt,
                   jnp.zeros_like(wt))

    # 5. panel-restricted rank-nb trailing update on the remaining panel rows
    pu_r0 = max(pl_r0, (kt + 1) // Pn)
    if pu_r0 < pl_r1:
        o = (pu_r0 - pl_r0) * nb
        ph = (pl_r1 - pl_r0) * nb
        xch = wt[o:ph]
        upd = jnp.matmul(xch, w, precision=matmul_precision())
        mask = (glob_row[pu_r0 * nb:pl_r1 * nb, None] <=
                glob_col[None, c0g:]) & \
            (row_tile[pu_r0:pl_r1].repeat(nb) < pl_end)[:, None]
        pan = pan.at[o:].set(pan[o:] - jnp.where(mask, upd, 0))
    return pan, w, wt


def _dist_potrf_unrolled_shardfn_u(a4, *, nb, nrt, wt_tiles,
                                   trail_chunks):
    """Upper-uplo unrolled panel loop (mirror of
    :func:`_dist_potrf_unrolled_shardfn`; see :func:`_tile_step_static_u`)."""
    a = a4[0, 0]
    p = lax.axis_index(ROW_AXIS)
    q = lax.axis_index(COL_AXIS)
    Pn = lax.axis_size(ROW_AXIS)
    Qn = lax.axis_size(COL_AXIS)
    lm, ln = a.shape
    lmt, lnt = lm // nb, ln // nb
    row_tile = jnp.arange(lmt) * Pn + p
    col_tile = jnp.arange(lnt) * Qn + q
    glob_row = row_tile.repeat(nb) * nb + jnp.tile(jnp.arange(nb), lmt)
    glob_col = col_tile.repeat(nb) * nb + jnp.tile(jnp.arange(nb), lnt)

    npanels = -(-nrt // wt_tiles)
    for pk in range(npanels):
        kt0 = pk * wt_tiles
        offc = kt0 // Qn
        pl_r0 = kt0 // Pn
        pl_r1 = min(pl_r0 + wt_tiles // Pn, lmt)
        c0 = offc * nb
        pan = a[pl_r0 * nb:pl_r1 * nb, c0:]
        ws, wts = [], []
        for j in range(wt_tiles):
            kt = kt0 + j
            if kt >= nrt:
                break
            pan, w, wtj = _tile_step_static_u(
                pan, kt, nb=nb, lmt=lmt, offc=offc, pl_r0=pl_r0,
                pl_r1=pl_r1, pl_end=kt0 + wt_tiles, row_tile=row_tile,
                col_tile=col_tile, glob_row=glob_row, glob_col=glob_col)
            ws.append(w)
            wts.append(wtj)
        a = a.at[pl_r0 * nb:pl_r1 * nb, c0:].set(pan)
        if pl_r1 >= lmt:
            continue

        # wide staircase trailing update over local row tiles [pl_r1, lmt):
        # row chunks, each chunk's columns starting at its conservative
        # diagonal tile (upper mirror of the L staircase)
        wide = jnp.concatenate(ws, axis=0)                     # (wt*nb, ln_w)
        wide_t = jnp.concatenate(wts, axis=1)[(pl_r1 - pl_r0) * nb:]
        lmt_tr = lmt - pl_r1
        nch = min(trail_chunks, lmt_tr)
        rw = -(-lmt_tr // nch)
        for r0 in range(pl_r1, lmt, rw):
            r1 = min(lmt, r0 + rw)
            gmin = r0 * Pn   # min global row tile of the chunk over ranks
            t0 = min(max(offc, -(-(gmin - Qn + 1) // Qn)), lnt - 1)
            ych = wide[:, (t0 - offc) * nb:]
            xch = wide_t[(r0 - pl_r1) * nb:(r1 - pl_r1) * nb]
            ach = a[r0 * nb:r1 * nb, t0 * nb:]
            u = jnp.matmul(xch, ych, precision=matmul_precision())
            triu = glob_row[r0 * nb:r1 * nb, None] <= \
                glob_col[None, t0 * nb:]
            a = a.at[r0 * nb:r1 * nb, t0 * nb:].set(
                ach - jnp.where(triu, u, jnp.zeros_like(u)))
    return a[None, None]


def _dist_potrf_unrolled_shardfn(a4, *, nb, nrt, wt_tiles,
                                 trail_chunks):
    """Python-unrolled panel loop: each wide panel gets exact static window
    offsets (offr = kt0 // P, pl_c0 = kt0 // Q), so the staircase trailing
    chunks compute no stale columns and need no runtime cond — the measured
    1.8x dist/local overhead of the bucketed path was mostly stale-column
    flops + ``lax.cond`` copy traffic. Used when the panel count is small
    enough to unroll (see ``cholesky``)."""
    a = a4[0, 0]
    p = lax.axis_index(ROW_AXIS)
    q = lax.axis_index(COL_AXIS)
    Pn = lax.axis_size(ROW_AXIS)
    Qn = lax.axis_size(COL_AXIS)
    lm, ln = a.shape
    lmt, lnt = lm // nb, ln // nb
    row_tile = jnp.arange(lmt) * Pn + p
    col_tile = jnp.arange(lnt) * Qn + q
    glob_row = row_tile.repeat(nb) * nb + jnp.tile(jnp.arange(nb), lmt)
    glob_col = col_tile.repeat(nb) * nb + jnp.tile(jnp.arange(nb), lnt)

    npanels = -(-nrt // wt_tiles)
    for pk in range(npanels):
        kt0 = pk * wt_tiles
        offr = kt0 // Pn
        pl_c0 = kt0 // Qn
        pl_c1 = min(pl_c0 + wt_tiles // Qn, lnt)
        r0 = offr * nb
        # factor the whole wide panel on an extracted buffer; ONE shard
        # write-back per panel (see _tile_step_static docstring)
        pan = a[r0:, pl_c0 * nb:pl_c1 * nb]
        ws, wts = [], []
        for j in range(wt_tiles):
            kt = kt0 + j
            if kt >= nrt:
                break
            pan, w, wtj = _tile_step_static(
                pan, kt, nb=nb, lnt=lnt, offr=offr, pl_c0=pl_c0,
                pl_c1=pl_c1, pl_end=kt0 + wt_tiles, row_tile=row_tile,
                col_tile=col_tile, glob_row=glob_row, glob_col=glob_col)
            ws.append(w)
            wts.append(wtj)
        a = a.at[r0:, pl_c0 * nb:pl_c1 * nb].set(pan)
        if pl_c1 >= lnt:
            continue

        # wide staircase trailing update over local col tiles [pl_c1, lnt):
        # k = len(ws)*nb GEMM per chunk, rows starting at the chunk's
        # conservative diagonal tile (reference trailing herk/gemm,
        # factorization/cholesky/impl.h:273-300). Computed area =
        # (1/2 + 1/(2*chunks)) of the full rectangle.
        wide = jnp.concatenate(ws, axis=1)
        wide_t = jnp.concatenate(wts, axis=0)[:, (pl_c1 - pl_c0) * nb:]
        lnt_tr = lnt - pl_c1
        nch = min(trail_chunks, lnt_tr)
        cw = -(-lnt_tr // nch)
        for c0 in range(pl_c1, lnt, cw):
            c1 = min(lnt, c0 + cw)
            gmin = c0 * Qn   # min global col tile of the chunk over ranks
            t0 = min(max(offr, -(-(gmin - Pn + 1) // Pn)), lmt - 1)
            xm = wide[(t0 - offr) * nb:]
            ych = wide_t[:, (c0 - pl_c1) * nb:(c1 - pl_c1) * nb]
            ach = a[t0 * nb:, c0 * nb:c1 * nb]
            u = jnp.matmul(xm, ych, precision=matmul_precision())
            tril = glob_row[t0 * nb:, None] >= glob_col[None,
                                                        c0 * nb:c1 * nb]
            # slice + subtract + .set (NOT .at[].add): scatter-add lowers to
            # an XLA scatter whose layout assignment inserts full-matrix
            # relayout copies
            a = a.at[t0 * nb:, c0 * nb:c1 * nb].set(
                ach - jnp.where(tril, u, jnp.zeros_like(u)))
    return a[None, None]


def _dist_potrf_shardfn(a4, *, nb, nrt, wt_tiles, trail_chunks):
    a = a4[0, 0]
    p = lax.axis_index(ROW_AXIS)
    q = lax.axis_index(COL_AXIS)
    Pn = lax.axis_size(ROW_AXIS)
    Qn = lax.axis_size(COL_AXIS)
    lm, ln = a.shape
    lmt, lnt = lm // nb, ln // nb
    row_tile = (jnp.arange(lmt) * Pn + p)
    col_tile = (jnp.arange(lnt) * Qn + q)
    row_tile_el = row_tile.repeat(nb)
    glob_row = row_tile_el * nb + jnp.tile(jnp.arange(nb), lmt)
    glob_col = col_tile.repeat(nb) * nb + jnp.tile(jnp.arange(nb), lnt)

    npanels = -(-nrt // wt_tiles)

    def panel_step(pk, a, *, offr, offc, row_tile_w, col_tile_w, glob_row_w,
                   glob_col_w):
        lm_w = a.shape[0]
        lnt_w = a.shape[1] // nb
        kt0 = pk * wt_tiles
        # contiguous local columns of this panel (wt_tiles % Q == 0); the
        # static width is capped by the bucket's window (the tail panel's
        # overshoot tiles are invalid and provably fit the clamped slab)
        pl_lc0 = kt0 // Qn - offc
        pl_w = min(wt_tiles // Qn, lnt_w)

        ws, wts = [], []
        for j in range(wt_tiles):
            kt = kt0 + j
            a, w, wtj = _tile_step(
                a, kt, nb=nb, offr=offr, offc=offc,
                row_tile=row_tile_w, col_tile=col_tile_w,
                pl_lc0=pl_lc0, pl_w=pl_w, pl_end=kt0 + wt_tiles,
                valid=kt < nrt)
            ws.append(w)
            wts.append(wtj)

        # wide trailing update: k = wt*nb GEMMs right of the panel
        # (reference trailing herk/gemm over the whole panel,
        # factorization/cholesky/impl.h:273-300). A single window-wide GEMM
        # computes the full (lm_w x ln_w) rectangle and masks the upper
        # triangle away — ~2x the herk flops (measured 1.76x local time on a
        # 1x1 grid). Instead: a STAIRCASE of static column chunks, each
        # starting its rows at the chunk's conservative diagonal tile, with
        # chunks entirely left of the trailing region skipped at runtime.
        wide = jnp.concatenate(ws, axis=1)               # (lm, wt*nb)
        wide_t = jnp.concatenate(wts, axis=0)            # (wt*nb, ln)
        # zero the panel's own columns so only tiles >= kt0+wt update
        right = (col_tile_w.repeat(nb) >= kt0 + wt_tiles)[None, :]
        wide_t = jnp.where(right, wide_t, 0)
        lmt_w = lm_w // nb
        nch = min(trail_chunks, lnt_w)
        cw = -(-lnt_w // nch)
        for c0t in range(0, lnt_w, cw):
            c1t = min(lnt_w, c0t + cw)
            # rows needed: global row tile >= min global col tile in chunk
            # (over ranks q); conservative static start over ranks p
            gmin = (offc + c0t) * Qn
            t0 = max(0, -(-(gmin - Pn + 1) // Pn) - offr)
            if t0 >= lmt_w:
                continue
            r0 = t0 * nb

            def upd_chunk(ac, c0t=c0t, c1t=c1t, r0=r0):
                u = jnp.matmul(wide[r0:], wide_t[:, c0t * nb:c1t * nb],
                               precision=matmul_precision())
                tril = glob_row_w[r0:, None] >= \
                    glob_col_w[None, c0t * nb:c1t * nb]
                return ac - jnp.where(tril, u, 0)

            # skip when the chunk's last possible global col tile is still
            # left of the trailing region (kt0 is traced -> runtime branch)
            has_work = (offc + c1t - 1) * Qn + (Qn - 1) >= kt0 + wt_tiles
            achunk = a[r0:, c0t * nb:c1t * nb]
            achunk = lax.cond(has_work, upd_chunk, lambda ac: ac, achunk)
            a = a.at[r0:, c0t * nb:c1t * nb].set(achunk)
        return a

    for k0, k1, offr, offc in window_buckets(npanels, Pn, Qn,
                                             stride=wt_tiles):
        offr = min(offr, lmt - 1)
        offc = min(offc, lnt - 1)
        w = a[offr * nb:, offc * nb:]
        step = functools.partial(
            panel_step, offr=offr, offc=offc,
            row_tile_w=row_tile[offr:], col_tile_w=col_tile[offc:],
            glob_row_w=glob_row[offr * nb:], glob_col_w=glob_col[offc * nb:])
        w = lax.fori_loop(k0, k1, lambda k, x: step(k, x), w)
        a = a.at[offr * nb:, offc * nb:].set(w)
    return a[None, None]


def _dist_potrf_impl(data, *, nb, nrt, wt_tiles, mesh, unroll,
                     trail_chunks, uplo="L"):
    spec = P(ROW_AXIS, COL_AXIS, None, None)
    if uplo == "U":
        assert unroll, "native distributed upper POTRF is unrolled-only"
        shardfn = _dist_potrf_unrolled_shardfn_u
    elif unroll:
        shardfn = _dist_potrf_unrolled_shardfn
    else:
        shardfn = _dist_potrf_shardfn
    fn = jax.shard_map(
        functools.partial(shardfn, nb=nb, nrt=nrt, wt_tiles=wt_tiles,
                          trail_chunks=trail_chunks),
        mesh=mesh, in_specs=(spec,), out_specs=spec,
        check_vma=False)
    return fn(data)


_dist_potrf = functools.partial(jax.jit, static_argnames=(
    "nb", "nrt", "wt_tiles", "mesh", "unroll",
    "trail_chunks", "uplo"))(_dist_potrf_impl)
# in-place variant (reference potrf overwrites A): halves peak HBM at scale
_dist_potrf_donate = functools.partial(jax.jit, static_argnames=(
    "nb", "nrt", "wt_tiles", "mesh", "unroll", "trail_chunks",
    "uplo"), donate_argnums=(0,))(_dist_potrf_impl)

# The factorization body computes in column-major, so row-major canonical inputs/outputs pay one full-shard relayout
# copy each way. Preferred-layout variant: when the INPUT already carries
# the column-major shard layout, compile with matching in/out formats and
# both boundary copies vanish (the result then also carries this layout;
# any later jit adapts at its own boundary, which it would have anyway).
_CM_MAJOR_TO_MINOR = (0, 1, 3, 2)


def preferred_format(grid):
    """The I/O Format under which distributed Cholesky runs copy-free."""
    from jax.experimental.layout import Format, Layout
    return Format(Layout(_CM_MAJOR_TO_MINOR), grid.canonical_sharding())


@functools.lru_cache(maxsize=None)
def _dist_potrf_cm(nb, nrt, wt_tiles, unroll, grid, trail_chunks):
    fmt = preferred_format(grid)

    def wrap(data):
        return _dist_potrf_impl(data, nb=nb, nrt=nrt, wt_tiles=wt_tiles,
                                mesh=grid.mesh, unroll=unroll,
                                trail_chunks=trail_chunks)

    return jax.jit(wrap, donate_argnums=(0,), in_shardings=(fmt,),
                   out_shardings=fmt)


def _input_is_cm(data) -> bool:
    fmt = getattr(data, "format", None)
    lay = getattr(fmt, "layout", None)
    return lay is not None and \
        tuple(lay.major_to_minor) == _CM_MAJOR_TO_MINOR


# unroll the panel loop up to this many wide panels (beyond it, compile time
# grows linearly and the bucketed fori_loop path takes over)
UNROLL_MAX_PANELS = 32


def cholesky(a: DistMatrix, donate: bool = False,
             uplo: str = "L") -> DistMatrix:
    """Distributed Cholesky: factor in the global ``uplo`` triangle, the
    opposite strict triangle keeps the original content (reference
    semantics; ``uplo="U"`` is the native distributed ``call_U``,
    reference ``factorization/cholesky/impl.h:351`` — row panels +
    left solves, no transpose round-trip).

    Wide-panel k-loop: each panel of ``wt_tiles`` block columns (rows for U)
    is factored with panel-restricted rank-nb updates, then the trailing
    matrix gets ONE k = wt*nb GEMM — the same flops at GEMM-efficient
    contraction depth (the per-tile loop's rank-nb full-trailing updates
    ran at < half the GEMM ceiling).
    """
    m, n = a.dist.size
    assert m == n, "cholesky needs a square matrix"
    assert uplo in ("L", "U"), uplo
    nb = a.block_size
    nrt = a.dist.nr_tiles[0]
    Pn, Qn = a.grid.grid_size
    tune = get_tune_parameters()
    # panel width, a multiple of Q tiles (contiguous local cols); for U the
    # panel is a block ROW, so the multiple is of P tiles
    ax = Pn if uplo == "U" else Qn
    wt_tiles = ax * max(1, -(-tune.potrf_dist_panel_width // (nb * ax)))
    wt_tiles = min(wt_tiles, max(ax, (nrt // ax) * ax or ax))
    npanels = -(-nrt // wt_tiles)
    unroll = npanels <= UNROLL_MAX_PANELS
    if uplo == "U" and not unroll:
        # the native U path is unrolled-only: widen panels until it fits
        wt_tiles = ax * (-(-nrt // (UNROLL_MAX_PANELS * ax)))
        npanels = -(-nrt // wt_tiles)
        unroll = True
    tch = max(1, tune.potrf_dist_trail_chunks)
    if donate and uplo == "L" and _input_is_cm(a.data):
        out = _dist_potrf_cm(nb, nrt, wt_tiles, unroll, a.grid, tch)(a.data)
    else:
        jitfn = _dist_potrf_donate if donate else _dist_potrf
        out = jitfn(a.data, nb=nb, nrt=nrt, wt_tiles=wt_tiles,
                    mesh=a.grid.mesh, unroll=unroll, trail_chunks=tch,
                    uplo=uplo)
    return DistMatrix(out, a.dist, a.grid)


def cholesky_info(a: DistMatrix):
    """Distributed Cholesky plus LAPACK-style info: (L, info).

    info == 0 on success, else the 1-based index of the first non-positive /
    non-finite factor pivot (reference ``tile::potrfInfo``,
    ``lapack/tile.h:615-616``). The diagonal check runs device-side
    (``DistMatrix.diagonal``) — no host gather of the matrix.
    """
    out = cholesky(a)
    d = jnp.real(out.diagonal())
    bad = (~jnp.isfinite(d)) | (d <= 0)
    info = jnp.where(jnp.any(bad), jnp.argmax(bad) + 1, 0).astype(jnp.int32)
    return out, info
