"""Distributed general/hermitian/triangular matrix multiplication.

Equivalents of the reference's ``multiplication/general``
(``multiplication/general/impl.h:35-151``), ``multiplication/hermitian``
(``multiplication/hermitian/impl.h:68-212``) and the multiply side of
``multiplication/triangular``: a SUMMA-style SPMD loop — for each k-panel,
broadcast A's column panel along the column axis and B's row panel along the
row axis, then one local GEMM accumulation per rank. This is the same
round-robin k-panel structure the reference uses, with MPI broadcasts replaced
by masked ``psum`` over mesh axes.

Hermitian/triangular operands never materialize globally: the k-panel of a
triangle-stored matrix is assembled per step from the stored column (rows
>= k) and the conj-transposed stored row (rows < k), exactly the split the
reference performs with its lower/diag/upper panel contributions.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ..comm import collectives as coll
from ..comm.mesh import COL_AXIS, ROW_AXIS
from ..matrix.dist_matrix import DistMatrix
from ..ops.core import matmul_precision, take_tri
from ..types import is_complex_dtype


def _col_panel(a, kt, nb, row_tile):
    """Panel holding A(i, kt) for this rank's local row tiles -> (lm, nb);
    broadcast from the owning grid column."""
    Qn = lax.axis_size(COL_AXIS)
    q = lax.axis_index(COL_AXIS)
    lm = a.shape[0]
    col = lax.dynamic_slice(a, (0, (kt // Qn) * nb), (lm, nb))
    return coll.bcast(jnp.where(q == kt % Qn, col, jnp.zeros_like(col)),
                      kt % Qn, COL_AXIS)


def _row_panel(b, kt, nb):
    """Panel holding B(kt, j) for this rank's local col tiles -> (nb, ln);
    broadcast from the owning grid row."""
    Pn = lax.axis_size(ROW_AXIS)
    p = lax.axis_index(ROW_AXIS)
    ln = b.shape[1]
    row = lax.dynamic_slice(b, ((kt // Pn) * nb, 0), (nb, ln))
    return coll.bcast(jnp.where(p == kt % Pn, row, jnp.zeros_like(row)),
                      kt % Pn, ROW_AXIS)


def _row_panel_as_col(a, kt, nb, row_tile, conj: bool):
    """A(kt, gi) redistributed so row r holds (op of) tile (kt, gi(r)) ->
    (lm, nb): the conj-transposed stored row used for the i < kt half of a
    triangle-stored operand (and for op(A) panels in trans cases)."""
    Pn = lax.axis_size(ROW_AXIS)
    Qn = lax.axis_size(COL_AXIS)
    p = lax.axis_index(ROW_AXIS)
    lm, ln = a.shape
    lnt = ln // nb
    row = lax.dynamic_slice(a, ((kt // Pn) * nb, 0), (nb, ln))
    row = coll.bcast(jnp.where(p == kt % Pn, row, jnp.zeros_like(row)),
                     kt % Pn, ROW_AXIS)
    rall = lax.all_gather(row, COL_AXIS)            # (Q, nb, ln)
    rg = rall.reshape(Qn, nb, lnt, nb).transpose(2, 0, 1, 3).reshape(lnt * Qn, nb, nb)
    # row_tile entries past rg's extent are padding tiles; jnp.take clamps and
    # the junk lands only in masked padding rows (see note in algos/cholesky.py)
    tiles = jnp.take(rg, row_tile, axis=0)          # (lmt, nb, nb)
    if conj and is_complex_dtype(a.dtype):
        tiles = jnp.conj(tiles)
    return tiles.transpose(0, 2, 1).reshape(-1, nb)


def _gemm_shardfn(a4, b4, c4, *, nb, kt_count, alpha, beta, a_mode):
    """c += alpha * opA(A) @ B over k-panels. ``a_mode``:
    'full'      plain A
    'herm_L'    A hermitian, lower stored
    'herm_U'    A hermitian, upper stored
    'tril'/'triu'/'tril_unit'/'triu_unit'  A triangular
    """
    a, b, c = a4[0, 0], b4[0, 0], c4[0, 0]
    p = lax.axis_index(ROW_AXIS)
    Pn = lax.axis_size(ROW_AXIS)
    lmt = a.shape[0] // nb
    row_tile = jnp.arange(lmt) * Pn + p
    row_tile_el = row_tile.repeat(nb)
    c = c * beta

    def step(kt, c):
        bp = _row_panel(b, kt, nb)                      # (nb, ln)
        if a_mode == "full":
            ap = _col_panel(a, kt, nb, row_tile)
        else:
            colp = _col_panel(a, kt, nb, row_tile)      # stored col (valid i >= kt / i <= kt)
            lower = a_mode in ("herm_L", "tril", "tril_unit")
            unit = a_mode.endswith("unit")
            # diagonal tile: take the stored triangle only
            dmask = (row_tile_el == kt)[:, None]
            if a_mode.startswith("herm"):
                # only the hermitian modes need the transposed stored row
                # (triangular modes read one triangle only) — building it
                # unconditionally would pay an all_gather per k-step
                rowp = _row_panel_as_col(a, kt, nb, row_tile, conj=True)
                below = (row_tile_el > kt)[:, None]
                ap = jnp.where(below, colp if lower else rowp,
                               jnp.where(dmask, 0.0, colp if not lower else rowp))
                # diag tile of hermitian: full tile from stored triangle
                from ..ops.core import symmetrize_tri
                dtile = jnp.where(dmask, colp, 0.0)
                # symmetrize each nb x nb diag tile: only one local tile can
                # match; reshape to tiles and symmetrize
                dt = dtile.reshape(lmt, nb, nb)
                dt = jnp.vectorize(lambda t: symmetrize_tri(t, lower),
                                   signature="(i,j)->(i,j)")(dt)
                ap = ap + jnp.where(dmask, dt.reshape(-1, nb), 0.0)
            else:
                keep = (row_tile_el > kt) if lower else (row_tile_el < kt)
                ap = jnp.where(keep[:, None], colp, jnp.zeros_like(colp))
                dt = jnp.where(dmask, colp, 0.0).reshape(lmt, nb, nb)
                dt = jnp.vectorize(lambda t: take_tri(t, lower, unit),
                                   signature="(i,j)->(i,j)")(dt)
                ap = ap + jnp.where(dmask, dt.reshape(-1, nb), 0.0)
        return c + alpha * jnp.matmul(ap, bp, precision=matmul_precision())

    return lax.fori_loop(0, kt_count, step, c)[None, None]


@functools.partial(jax.jit, static_argnames=("nb", "kt_count", "a_mode", "mesh"))
def _dist_gemm(a_data, b_data, c_data, *, nb, kt_count, alpha, beta, a_mode, mesh):
    spec = P(ROW_AXIS, COL_AXIS, None, None)
    fn = jax.shard_map(
        functools.partial(_gemm_shardfn, nb=nb, kt_count=kt_count, alpha=alpha,
                          beta=beta, a_mode=a_mode),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False)
    return fn(a_data, b_data, c_data)


def _run(a: DistMatrix, b: DistMatrix, c, alpha, beta, a_mode) -> DistMatrix:
    assert a.grid.grid_size == b.grid.grid_size
    nb = a.block_size
    if c is None:
        from ..dist import Distribution
        m = a.dist.size[0]
        n = b.dist.size[1]
        d = Distribution((m, n), (nb, nb), a.grid.grid_size)
        lmt, lnt = d.max_local_nr_tiles
        Pq = a.grid.grid_size
        shape = (Pq[0], Pq[1], lmt * nb, lnt * nb)
        c_data = jnp.zeros(shape, a.data.dtype)
        c_data = jax.device_put(c_data, a.grid.canonical_sharding())
        c = DistMatrix(c_data, d, a.grid)
        beta = 0.0
    kt_count = a.dist.nr_tiles[1]
    out = _dist_gemm(a.data, b.data, c.data, nb=nb, kt_count=kt_count,
                     alpha=alpha, beta=beta, a_mode=a_mode, mesh=a.grid.mesh)
    return DistMatrix(out, c.dist, c.grid)


def general_multiplication(a: DistMatrix, b: DistMatrix, c=None,
                           alpha=1.0, beta=0.0) -> DistMatrix:
    """C <- alpha A B + beta C (reference ``multiplication/general.h:52``,
    NoTrans/NoTrans distributed case)."""
    return _run(a, b, c, alpha, beta, "full")


def hermitian_multiplication(a: DistMatrix, b: DistMatrix, c=None, *,
                             uplo: str = "L", alpha=1.0, beta=0.0) -> DistMatrix:
    """C <- alpha A B + beta C with A hermitian, triangle-stored
    (reference ``dlaf::hermitian_multiplication``, Left side)."""
    return _run(a, b, c, alpha, beta, "herm_L" if uplo == "L" else "herm_U")


def triangular_multiplication(a: DistMatrix, b: DistMatrix, *, side: str = "L",
                              uplo: str = "L", diag: str = "N",
                              alpha=1.0) -> DistMatrix:
    """B <- alpha A B (side='L') or alpha B A (side='R'), A triangular.

    The reference distributes exactly the four NoTrans cases LLN/LUN/RLN/RUN
    (``multiplication/triangular/api.h:17-75``); Right reduces to Left by a
    distributed transpose (B A = (A^T B^T)^T, triangle flips).
    """
    if side == "R":
        at = a.transpose(conj=False)
        bt = b.transpose(conj=False)
        y = triangular_multiplication(at, bt, side="L",
                                      uplo=("U" if uplo == "L" else "L"),
                                      diag=diag, alpha=alpha)
        return y.transpose(conj=False)
    mode = ("tril" if uplo == "L" else "triu") + ("_unit" if diag == "U" else "")
    return _run(a, b, None, alpha, 0.0, mode)
