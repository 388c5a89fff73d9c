"""Shared panel gather/broadcast/reindex primitives (inside shard_map).

Analog of the reference's reusable ``Panel`` workspace
(``matrix/panel.h:43``) and its transposed broadcast
(``communication/broadcast_panel.h:61,125``): every distributed algorithm
needs some combination of

  - broadcasting a column (or row) slab of the canonical local shard from
    its owning grid column (row) to the whole axis,
  - re-indexing a gathered slab into arbitrary global tile ids (the
    transposed-Panel / StoreTransposed pattern), and
  - assembling a replicated, contiguous-global-rows column panel.

These were re-implemented with subtle variations in cholesky, triangular,
dist_red2band and dist_stage23; this module is the single audited copy.

Clamp-into-padding invariant (applies to :func:`take_tiles`): requested tile
ids may fall OUTSIDE the gathered range — padding tiles (global tile id >=
nr_tiles) or tiles below a shrinking window's base. ``jnp.take``'s 'clip'
gather semantics return junk rows there; every caller masks those rows out
immediately after (trailing masks / validity masks). A caller that stops
masking must clamp its ids explicitly.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from . import collectives as coll
from .mesh import COL_AXIS, ROW_AXIS


def bcast_col_slab(a, lc, owner_q, width):
    """Broadcast ``a[:, lc:lc+width]`` (local column slab) from grid column
    ``owner_q`` along the row of grid ranks (reference panel broadcast
    col-comm direction, ``broadcast_panel.h:61``). ``lc`` may be traced."""
    lm = a.shape[0]
    slab = lax.dynamic_slice(a, (jnp.int32(0), jnp.asarray(lc, jnp.int32)),
                             (lm, width))
    q = lax.axis_index(COL_AXIS)
    return coll.bcast(jnp.where(q == owner_q, slab, jnp.zeros_like(slab)),
                      owner_q, COL_AXIS)


def bcast_row_slab(a, lr, owner_p, width):
    """Broadcast ``a[lr:lr+width, :]`` (local row slab) from grid row
    ``owner_p`` along the column of grid ranks."""
    ln = a.shape[1]
    slab = lax.dynamic_slice(a, (jnp.asarray(lr, jnp.int32), jnp.int32(0)),
                             (width, ln))
    p = lax.axis_index(ROW_AXIS)
    return coll.bcast(jnp.where(p == owner_p, slab, jnp.zeros_like(slab)),
                      owner_p, ROW_AXIS)


def all_tiles(slab, axis: str, nb: int):
    """all_gather a slab over ``axis`` and return it tile-major.

    ``slab`` is either a column slab (lm, w) — tiles along axis 0, gathered
    over the row axis — or a row slab (w, ln) — tiles along axis 1, gathered
    over the column axis. Returns (ntiles_global, tile_rows, tile_cols) where
    global tile g = local_tile * axis_size + axis_index (the block-cyclic
    inverse map), i.e. ``out[g]`` is the slab block of global tile g.
    """
    n_ax = lax.axis_size(axis)
    g = lax.all_gather(slab, axis)                       # (n_ax, *slab.shape)
    if axis == ROW_AXIS:
        lm, w = slab.shape
        lt = lm // nb
        return g.reshape(n_ax, lt, nb, w).transpose(1, 0, 2, 3) \
            .reshape(lt * n_ax, nb, w)
    w, ln = slab.shape
    lt = ln // nb
    return g.reshape(n_ax, w, lt, nb).transpose(2, 0, 1, 3) \
        .reshape(lt * n_ax, w, nb)


def take_tiles(tiles, ids):
    """Select tiles by (possibly out-of-range) global tile ids; see the
    clamp-into-padding invariant in the module docstring."""
    return jnp.take(tiles, ids, axis=0)


def gather_col_panel(a, j0, width, nb, lmt, offc=0):
    """Window-local shard -> replicated (P * lmt * nb, width) global column
    panel at (traced) global column ``j0``; rows are the window's contiguous
    global range starting at tile offr*P (the caller masks). The reference's
    Panel-gather + broadcast for the stage-1 V panels
    (``reduction_to_band/impl.h:616-689``, ``matrix/panel.h:43``)."""
    Qn = lax.axis_size(COL_AXIS)
    j0 = jnp.asarray(j0, jnp.int32)
    kt = j0 // nb
    lc = (kt // Qn - offc) * nb + j0 % nb
    slab = bcast_col_slab(a, lc, kt % Qn, width)
    return all_tiles(slab, ROW_AXIS, nb).reshape(-1, width)
