"""DistMatrix device-resident methods: diagonal, transpose (non-square
grids), symmetrize — plus the distributed Cholesky info channel.

Reference analogs: ``matrix/matrix.h`` views/copy, ``tile::potrfInfo``
(``lapack/tile.h:615-616``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dlaf_jax.comm.mesh import Grid
from dlaf_jax.matrix import generators as gen
from dlaf_jax.matrix.dist_matrix import DistMatrix


@pytest.mark.parametrize("grid_size", [(2, 4), (1, 8), (2, 2)])
def test_diagonal(grid_size, dtype):
    n, nb = 72, 16
    g = Grid(grid_size)
    a = gen.random_hermitian(jax.random.PRNGKey(0), n, dtype)
    dm = DistMatrix.from_global(a, nb, g)
    d = dm.diagonal()
    np.testing.assert_allclose(np.asarray(d), np.diagonal(np.asarray(a)))


@pytest.mark.parametrize("grid_size", [(2, 4), (4, 2), (1, 8), (2, 3),
                                       (3, 2)])
@pytest.mark.parametrize("conj", [True, False])
def test_transpose_nonsquare_device(grid_size, conj, dtype):
    m, n, nb = 80, 48, 16
    g = Grid(grid_size)
    a = gen.random_general(jax.random.PRNGKey(1), (m, n), dtype)
    dm = DistMatrix.from_global(a, nb, g)
    t = dm.transpose(conj=conj)
    an = np.asarray(a)
    ref = an.conj().T if conj else an.T
    assert t.dist.size == (n, m)
    np.testing.assert_allclose(np.asarray(t.to_global()), ref)


@pytest.mark.parametrize("lower", [True, False])
def test_symmetrize(lower, dtype):
    n, nb = 64, 16
    g = Grid((2, 4))
    a = gen.random_general(jax.random.PRNGKey(2), (n, n), dtype)
    dm = DistMatrix.from_global(a, nb, g)
    s = np.asarray(dm.symmetrize(lower=lower).to_global())
    an = np.asarray(a)
    if lower:
        ref = np.tril(an) + np.tril(an, -1).conj().T
    else:
        ref = np.triu(an) + np.triu(an, 1).conj().T
    np.testing.assert_allclose(s, ref)


def test_cholesky_info(real_dtype_p):
    from dlaf_jax.algos.cholesky import cholesky_info
    n, nb = 64, 16
    g = Grid((2, 4))
    a = gen.random_hermitian_positive_definite(jax.random.PRNGKey(3), n,
                                               real_dtype_p)
    dm = DistMatrix.from_global(a, nb, g, pad_identity=True)
    out, info = cholesky_info(dm)
    assert int(info) == 0
    l = np.tril(np.asarray(out.to_global()))
    np.testing.assert_allclose(l @ l.T, np.asarray(a), atol=1e-4 * n)

    bad = np.asarray(a).copy()
    bad[33, 33] = -100.0  # non-SPD pivot inside tile 2 (rows 32..47)
    dmb = DistMatrix.from_global(jnp.asarray(bad), nb, g, pad_identity=True)
    _, info_bad = cholesky_info(dmb)
    # info points into the failing tile (tile-granular, like potrfInfo)
    assert 32 < int(info_bad) <= 48


def test_potrf_info_local(real_dtype_p):
    import dlaf_jax as dt
    n = 96
    a = gen.random_hermitian_positive_definite(jax.random.PRNGKey(4), n,
                                               real_dtype_p)
    _, info = dt.potrf_info(a, nb=32)
    assert int(info) == 0
    bad = np.asarray(a).copy()
    bad[70, 70] = -50.0
    _, info_bad = dt.potrf_info(jnp.asarray(bad), nb=32)
    assert 64 < int(info_bad) <= 96


def test_from_callback_matches_from_global():
    """Multi-host construction path: per-shard callback fills only locally
    addressable shards; layout identical to from_global."""
    rng = np.random.default_rng(7)
    for gs in ((2, 4), (2, 2)):
        for n, nb in ((100, 16), (64, 32)):
            a = rng.standard_normal((n, n))
            dm = DistMatrix.from_callback(lambda idx: a[idx], (n, n), nb,
                                          Grid(gs), np.float64)
            dm2 = DistMatrix.from_global(jnp.asarray(a), nb, Grid(gs))
            assert np.array_equal(np.asarray(dm.data), np.asarray(dm2.data))
            assert np.array_equal(np.asarray(dm.to_global()), a)


def test_from_callback_pad_identity_matches_from_global():
    """pad_identity contract on the callback path: ones on the padded
    diagonal, shard-identical to from_global(pad_identity=True)."""
    rng = np.random.default_rng(11)
    for gs in ((2, 4), (3, 2)):
        for n, nb in ((40, 16), (100, 16)):
            a = rng.standard_normal((n, n))
            dm = DistMatrix.from_callback(lambda idx: a[idx], (n, n), nb,
                                          Grid(gs), np.float64,
                                          pad_identity=True)
            dm2 = DistMatrix.from_global(jnp.asarray(a), nb, Grid(gs),
                                         pad_identity=True)
            assert np.array_equal(np.asarray(dm.data), np.asarray(dm2.data))


def test_dist_permute_device_resident():
    """Distributed permutation via all_gather + local gather (no host)."""
    from dlaf_jax.algos.permutations import permute
    rng = np.random.default_rng(8)
    for gs in ((2, 4), (1, 4)):
        n, nb = 96, 16
        a = jnp.asarray(rng.standard_normal((n, n)))
        dm = DistMatrix.from_global(a, nb, Grid(gs))
        for axis in (0, 1):
            perm = jnp.asarray(rng.permutation(n), jnp.int32)
            out = permute(dm, perm, axis=axis)
            ref = np.take(np.asarray(a), np.asarray(perm), axis=axis)
            assert np.array_equal(np.asarray(out.to_global()), ref)


def test_cols_to_canonical_all_to_all():
    """Explicit uniform all-to-all reshard (tile-aligned fast path)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from dlaf_jax.algos.eigensolver.dist_stage23 import cols_to_canonical
    from dlaf_jax.comm.mesh import COL_AXIS, ROW_AXIS
    from dlaf_jax.dist import gather_from_shards
    from dlaf_jax.dist.distribution import Distribution
    rng = np.random.default_rng(9)
    for gs, n, nb, m in (((2, 4), 96, 16, 256), ((2, 2), 200, 16, 256),
                         ((2, 2), 128, 16, 128)):
        grid = Grid(gs)
        dist = Distribution((n, n), (nb, nb), gs)
        pm, pn = dist.padded_size
        qfull = jnp.asarray(rng.standard_normal((m, m)))
        qc = jax.device_put(qfull, NamedSharding(
            grid.mesh, P(None, (ROW_AXIS, COL_AXIS))))
        out = cols_to_canonical(qc, dist=dist,
                                sharding=grid.canonical_sharding())
        got = np.asarray(gather_from_shards(out, dist))
        assert np.array_equal(got, np.asarray(qfull)[:pm, :pn])


@pytest.mark.parametrize("grid_size", [(2, 2), (2, 3), (1, 8), (4, 2)])
@pytest.mark.parametrize("off_t", [(0, 0), (1, 2), (3, 1)])
def test_sub_matrix_extract_insert(grid_size, off_t):
    """Device-resident sub-matrix view (reference MatrixRef,
    matrix/matrix_ref.h:34): extraction matches the host slice, write-back
    round-trips, and the parent outside the window is untouched."""
    n, nb = 96, 8
    rng = np.random.default_rng(7)
    a = jnp.asarray(rng.standard_normal((n, n)))
    dm = DistMatrix.from_global(a, nb, Grid(grid_size))
    oi, oj = off_t[0] * nb, off_t[1] * nb
    m2, n2 = 40, 33          # deliberately not tile multiples
    sub = dm.sub_matrix(off_t, (m2, n2))
    np.testing.assert_allclose(np.asarray(sub.to_global()),
                               np.asarray(a)[oi:oi + m2, oj:oj + n2])
    # modify the sub view, write back
    sub2 = DistMatrix(jnp.asarray(sub.data) * 2.0, sub.dist, sub.grid)
    back = dm.set_sub_matrix(sub2, off_t)
    want = np.asarray(a).copy()
    want[oi:oi + m2, oj:oj + n2] *= 2.0
    np.testing.assert_allclose(np.asarray(back.to_global()), want)


def test_algorithm_on_sub_matrix_view():
    """An algorithm runs on a device-side sub-matrix view: Cholesky of the
    trailing block of a larger matrix, without host gathers (the reference
    runs algorithms on MatrixRef sub-matrices the same way)."""
    from dlaf_jax.algos.cholesky import cholesky

    n, nb, off = 96, 8, 4
    rng = np.random.default_rng(8)
    g = rng.standard_normal((n, n))
    spd = g @ g.T + n * np.eye(n)
    dm = DistMatrix.from_global(jnp.asarray(spd), nb, Grid((2, 2)))
    m2 = n - off * nb
    sub = dm.sub_matrix((off, off), (m2, m2), pad_identity=True)
    out = cholesky(sub)
    l = np.tril(np.asarray(out.to_global()))
    want = np.linalg.cholesky(spd[off * nb:, off * nb:])
    np.testing.assert_allclose(l, want, atol=1e-8)
    # and the result goes back into the parent device-side
    back = dm.set_sub_matrix(out, (off, off))
    bg = np.asarray(back.to_global())
    np.testing.assert_allclose(np.tril(bg[off * nb:, off * nb:]), want,
                               atol=1e-8)


def test_retiled_view():
    n, nb = 64, 16
    a = jnp.asarray(np.random.default_rng(9).standard_normal((n, n)))
    dm = DistMatrix.from_global(a, nb, Grid((2, 2)))
    r = dm.retiled((4, 4))
    assert r.dist.tile == (4, 4)
    assert r.dist.nr_tiles == (16, 16)
    # same buffers, same global content
    assert r.data is dm.data
    np.testing.assert_array_equal(np.asarray(r.to_global()), np.asarray(a))
    # ownership consistent: finer tile (i,j) owned by its block's owner
    assert r.dist.rank_global_tile((7, 2)) == dm.dist.rank_global_tile((1, 0))
