"""comm.panel — the shared Panel gather/broadcast/reindex primitives.

Reference analog: ``matrix/panel.h`` unit tests (``test/unit/matrix/
test_panel.cpp``) — exercised on non-square grids with padding tiles, the
configurations where the four pre-refactor copies diverged.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import PartitionSpec as P

from dlaf_jax.comm import panel
from dlaf_jax.comm.mesh import COL_AXIS, ROW_AXIS, Grid
from dlaf_jax.dist import Distribution, scatter_to_shards
from dlaf_jax.matrix.dist_matrix import DistMatrix


def _make(m, n, nb, grid_size, seed=0):
    """Global array + its canonical shard layout (padded with zeros)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n)).astype(np.float32)
    g = Grid(grid_size)
    dm = DistMatrix.from_global(jnp.asarray(a), nb, g)
    return a, dm, g


def _run(g, fn, data, out_spec):
    shard = jax.shard_map(fn, mesh=g.mesh,
                          in_specs=(P(ROW_AXIS, COL_AXIS, None, None),),
                          out_specs=out_spec, check_vma=False)
    return jax.jit(shard)(data)


# m=72, nb=16 -> 5 row tiles: on a (2, 4) grid the last row tile of grid row
# 1 and the 2nd col tile of grid cols 2, 3 are PADDING tiles
@pytest.mark.parametrize("grid_size", [(2, 4), (4, 2), (1, 8), (2, 2)])
def test_gather_col_panel(grid_size):
    m, nb, band = 72, 16, 8
    a, dm, g = _make(m, m, nb, grid_size)
    pm = dm.dist.padded_size[0]
    lmt = dm.dist.max_local_nr_tiles[0]
    Pn = grid_size[0]

    for j0 in (0, 8, 16, 40):
        fn = functools.partial(
            lambda a4, j0: panel.gather_col_panel(a4[0, 0], j0, band, nb, lmt),
            j0=j0)
        out = np.asarray(_run(g, fn, dm.data, P(None, None)))
        assert out.shape == (Pn * lmt * nb, band)
        ref = np.zeros_like(out)
        ref[:pm] = np.pad(a, ((0, pm - m), (0, pm - m)))[:, j0:j0 + band]
        np.testing.assert_allclose(out[:pm], ref[:pm], atol=1e-6)


@pytest.mark.parametrize("grid_size", [(2, 4), (4, 2)])
def test_bcast_slabs(grid_size):
    m, nb = 64, 16
    a, dm, g = _make(m, m, nb, grid_size, seed=1)
    Pn, Qn = grid_size
    kt = 2  # global tile owned by col kt % Q / row kt % P

    def col_fn(a4):
        return panel.bcast_col_slab(a4[0, 0], (kt // Qn) * nb, kt % Qn, nb)

    out = np.asarray(_run(g, col_fn, dm.data, P(ROW_AXIS, None)))
    # every grid row holds its local rows of global column block kt
    lmt = dm.dist.max_local_nr_tiles[0]
    for p in range(Pn):
        loc = out[p * lmt * nb:(p + 1) * lmt * nb]
        for lt in range(lmt):
            gr = (lt * Pn + p) * nb
            np.testing.assert_allclose(loc[lt * nb:(lt + 1) * nb],
                                       a[gr:gr + nb, kt * nb:(kt + 1) * nb],
                                       atol=1e-6)

    def row_fn(a4):
        return panel.bcast_row_slab(a4[0, 0], (kt // Pn) * nb, kt % Pn, nb)

    out = np.asarray(_run(g, row_fn, dm.data, P(None, COL_AXIS)))
    lnt = dm.dist.max_local_nr_tiles[1]
    for q in range(Qn):
        loc = out[:, q * lnt * nb:(q + 1) * lnt * nb]
        for lt in range(lnt):
            gc = (lt * Qn + q) * nb
            np.testing.assert_allclose(loc[:, lt * nb:(lt + 1) * nb],
                                       a[kt * nb:(kt + 1) * nb, gc:gc + nb],
                                       atol=1e-6)


@pytest.mark.parametrize("grid_size", [(2, 4), (4, 2), (2, 2)])
def test_all_tiles_take_tiles_roundtrip(grid_size):
    """The transposed-Panel reindex: a column slab gathered over the row axis
    must reproduce any requested global tile; in-range ids only (the
    clamp-into-padding invariant says out-of-range rows are caller-masked)."""
    m, nb = 96, 16
    a, dm, g = _make(m, m, nb, grid_size, seed=2)
    Pn, Qn = grid_size
    kt = 1
    nrt = m // nb

    def fn(a4):
        slab = panel.bcast_col_slab(a4[0, 0], (kt // Qn) * nb, kt % Qn, nb)
        tiles = panel.all_tiles(slab, ROW_AXIS, nb)
        ids = jnp.arange(nrt)
        return panel.take_tiles(tiles, ids)

    out = np.asarray(_run(g, fn, dm.data, P(None, None, None)))
    for t in range(nrt):
        np.testing.assert_allclose(out[t],
                                   a[t * nb:(t + 1) * nb,
                                     kt * nb:(kt + 1) * nb], atol=1e-6)


@pytest.mark.parametrize("grid_size", [(2, 4), (4, 2)])
def test_all_tiles_row_slab(grid_size):
    """Row-slab orientation (triangular solver's trans path)."""
    m, nb = 96, 16
    a, dm, g = _make(m, m, nb, grid_size, seed=3)
    Pn, Qn = grid_size
    kt = 3
    nrt = m // nb

    def fn(a4):
        slab = panel.bcast_row_slab(a4[0, 0], (kt // Pn) * nb, kt % Pn, nb)
        tiles = panel.all_tiles(slab, COL_AXIS, nb)
        return panel.take_tiles(tiles, jnp.arange(nrt))

    out = np.asarray(_run(g, fn, dm.data, P(None, None, None)))
    for t in range(nrt):
        np.testing.assert_allclose(out[t],
                                   a[kt * nb:(kt + 1) * nb,
                                     t * nb:(t + 1) * nb], atol=1e-6)
