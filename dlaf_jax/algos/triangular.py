"""Distributed triangular solve (TRSM) and multiply (TRMM).

Re-design of the reference's distributed triangular solver
(``solver/triangular/impl.h:476-1195``) and triangular multiplication
(``multiplication/triangular``): SPMD loop over tile-rows of B; per step the
diagonal tile is broadcast, the owning grid-row solves/multiplies its B row
slab, the slab is broadcast down the row axis and the trailing rows of B are
updated with one masked local GEMM.

Left cases are implemented natively; Right cases reduce to Left on the
adjoint problem at the API layer (one distributed transpose), mirroring how
the reference shares kernels between its 8 cases.
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
from ..ops import blocked
from ..ops.core import matmul_precision
from ..tune import get_tune_parameters
from ..types import is_complex_dtype


def _mult_panel(a, kt, *, nb, trans, lmt_b, row_tile_b, offr=0):
    """Gather op(A)(i, kt) for the B row-tile window [offr, offr + lmt_b) of
    this rank -> (lmt_b * nb, nb) panel (zero where masked later)."""
    Pn = lax.axis_size(ROW_AXIS)
    Qn = lax.axis_size(COL_AXIS)
    lm, ln = a.shape
    if trans == "N":
        # column kt of A lives on grid col kt % Q; broadcast along 'c'.
        # Rows of the slab are already this rank's local row tiles (A and B
        # share the row distribution); slice to the window
        col = panel.bcast_col_slab(a, (kt // Qn) * nb, kt % Qn, nb)
        return col[offr * nb:offr * nb + lmt_b * nb]
    # op(A)(i, kt) = op of A(kt, i): row kt of A, on grid row kt % P;
    # broadcast along 'r', then redistribute row->col (transposed-Panel
    # pattern). row_tile_b entries past the gathered extent are padding
    # tiles — the clamp-into-padding invariant (comm/panel.py) applies;
    # the caller's mask discards those rows.
    row = panel.bcast_row_slab(a, (kt // Pn) * nb, kt % Pn, nb)
    tiles = panel.take_tiles(panel.all_tiles(row, COL_AXIS, nb),
                             row_tile_b)               # (lmt_b, nb, nb)
    if trans == "C" and is_complex_dtype(a.dtype):
        tiles = jnp.conj(tiles)
    # op transposes each tile: panel rows = global row elements
    return tiles.transpose(0, 2, 1).reshape(lmt_b * nb, nb)


def _trsm_step(carry, kt, *, nb, leaf_nb, lower, trans, unit, forward, offr,
               row_tile_el_b):
    """One step on the B row window starting at local tile ``offr`` (forward
    solves shrink the window from the top; backward windows are sliced at the
    caller as b[:end] with offr == 0)."""
    a, b = carry
    p = lax.axis_index(ROW_AXIS)
    Pn = lax.axis_size(ROW_AXIS)
    Qn = lax.axis_size(COL_AXIS)
    lmt_b = b.shape[0] // nb
    row_tile_b = (jnp.arange(lmt_b) + offr) * Pn + p

    owner_p = kt % Pn
    owner_q = kt % Qn
    lk_r_a = kt // Pn                      # a is the full local shard
    lk_r = kt // Pn - (offr if forward else 0)   # b is the row window
    lk_c = kt // Qn

    # diag tile of A
    tile = lax.dynamic_slice(a, (lk_r_a * nb, lk_c * nb), (nb, nb))
    akk = coll.bcast2d(tile, (owner_p, owner_q), (ROW_AXIS, COL_AXIS))

    # solve the B row slab on the owning grid row
    brow = lax.dynamic_slice(b, (lk_r * nb, 0), (nb, b.shape[1]))
    xrow = blocked.trsm(brow, akk, side="L", lower=lower, trans=trans,
                        unit=unit, nb=leaf_nb)
    b = lax.dynamic_update_slice(b, jnp.where(p == owner_p, xrow, brow),
                                 (lk_r * nb, 0))
    # broadcast solved slab down the row axis
    xrow = coll.bcast(jnp.where(p == owner_p, xrow, jnp.zeros_like(xrow)),
                      owner_p, ROW_AXIS)

    # update remaining rows: B(i) -= op(A)(i, kt) @ X(kt) for unsolved i
    panel = _mult_panel(a, kt, nb=nb, trans=trans, lmt_b=lmt_b,
                        row_tile_b=row_tile_b, offr=offr if forward else 0)
    mask = (row_tile_el_b > kt) if forward else (row_tile_el_b < kt)
    panel = jnp.where(mask[:, None], panel, jnp.zeros_like(panel))
    b = b - jnp.matmul(panel, xrow, precision=matmul_precision())
    return (a, b), None


def _dist_trsm_shardfn(a4, b4, *, nb, nrt, leaf_nb, lower, trans, unit, alpha):
    a = a4[0, 0]
    b = b4[0, 0] * alpha
    p = lax.axis_index(ROW_AXIS)
    Pn = lax.axis_size(ROW_AXIS)
    Qn = lax.axis_size(COL_AXIS)
    lmt_b = b.shape[0] // nb

    forward = (lower == (trans == "N"))
    # work-optimal shrinking windows (see algos/cholesky.py): forward solves
    # shrink the unsolved B rows from the top, backward from the bottom
    from .cholesky import window_buckets
    buckets = window_buckets(nrt, Pn, Qn)
    if forward:
        for k0, k1, offr, _ in buckets:
            offr = min(offr, lmt_b - 1)
            lmw = lmt_b - offr
            row_tile_el_b = ((jnp.arange(lmw) + offr) * Pn + p).repeat(nb)
            step = functools.partial(
                _trsm_step, nb=nb, leaf_nb=leaf_nb, lower=lower, trans=trans,
                unit=unit, forward=True, offr=offr,
                row_tile_el_b=row_tile_el_b)
            bw = b[offr * nb:]
            (a, bw), _ = lax.scan(step, (a, bw), jnp.arange(k0, k1))
            b = b.at[offr * nb:].set(bw)
    else:
        for k0, k1, _, _ in reversed(buckets):
            end = min((max(k1 - 1, 0)) // Pn + 1, lmt_b)
            row_tile_el_b = (jnp.arange(end) * Pn + p).repeat(nb)
            step = functools.partial(
                _trsm_step, nb=nb, leaf_nb=leaf_nb, lower=lower, trans=trans,
                unit=unit, forward=False, offr=0,
                row_tile_el_b=row_tile_el_b)
            bw = b[:end * nb]
            (a, bw), _ = lax.scan(step, (a, bw),
                                  jnp.arange(k1 - 1, k0 - 1, -1))
            b = b.at[:end * nb].set(bw)
    return b[None, None]


@functools.partial(jax.jit, static_argnames=("nb", "nrt", "leaf_nb", "lower",
                                             "trans", "unit", "mesh"))
def _dist_trsm(a_data, b_data, *, nb, nrt, leaf_nb, lower, trans, unit, alpha, mesh):
    spec = P(ROW_AXIS, COL_AXIS, None, None)
    fn = jax.shard_map(
        functools.partial(_dist_trsm_shardfn, nb=nb, nrt=nrt, leaf_nb=leaf_nb,
                          lower=lower, trans=trans, unit=unit, alpha=alpha),
        mesh=mesh, in_specs=(spec, spec), out_specs=spec,
        check_vma=False)
    return fn(a_data, b_data)


def triangular_solver(a: DistMatrix, b: DistMatrix, *, side: str = "L",
                      uplo: str = "L", trans: str = "N", diag: str = "N",
                      alpha=1.0) -> DistMatrix:
    """Distributed op(A) X = alpha B / X op(A) = alpha B — all 8 cases of the
    reference's distributed triangular solver
    (``solver/triangular/impl.h:476-1195``). Left cases run natively; Right
    cases reduce to Left by one distributed transpose on each side of the
    solve (X op(A) = B  <=>  op(A)^T X^T = B^T).
    """
    if side == "R":
        if trans == "C":
            y = triangular_solver(a, b.transpose(conj=True), side="L",
                                  uplo=uplo, trans="N", diag=diag,
                                  alpha=jnp.conj(alpha))
            return y.transpose(conj=True)
        tt = {"N": "T", "T": "N"}[trans]
        y = triangular_solver(a, b.transpose(conj=False), side="L",
                              uplo=uplo, trans=tt, diag=diag, alpha=alpha)
        return y.transpose(conj=False)
    assert a.dist.size[0] == a.dist.size[1] == b.dist.size[0]
    assert a.block_size == b.block_size
    assert a.grid.grid_size == b.grid.grid_size
    nb = a.block_size
    nrt = a.dist.nr_tiles[0]
    leaf = min(get_tune_parameters().leaf_block_size, nb)
    out = _dist_trsm(a.data, b.data, nb=nb, nrt=nrt, leaf_nb=leaf,
                     lower=(uplo == "L"), trans=trans, unit=(diag == "U"),
                     alpha=alpha, mesh=a.grid.mesh)
    return DistMatrix(out, b.dist, b.grid)
