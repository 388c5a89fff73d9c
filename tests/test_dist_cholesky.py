"""Distributed Cholesky on multi-device CPU meshes.

Analog of the reference's grid-sweeping distributed tests
(test/unit/factorization/test_cholesky.cpp with CommunicatorGrid6RanksEnvironment):
several mesh shapes including degenerate 1xN / Nx1, sizes including
non-tile-multiples.
"""
import jax
import numpy as np
import pytest

from dlaf_jax.algos.cholesky import cholesky
from dlaf_jax.comm.mesh import Grid
from dlaf_jax.matrix import generators as gen
from dlaf_jax.matrix.dist_matrix import DistMatrix

from conftest import tol

# degenerate Nx1/1xN grids move to the slow lane: they exercise the same
# code paths as (1,1)+(2,3)+(2,4) plus the axis-degeneracy handled by
# collectives; the full sweep still runs with -m "slow or not slow"
GRIDS = [(1, 1), (2, 2), (2, 4),
         pytest.param((4, 1), marks=pytest.mark.slow),
         pytest.param((1, 8), marks=pytest.mark.slow),
         (2, 3)]


@pytest.mark.parametrize("grid_size", GRIDS)
@pytest.mark.parametrize("n,nb", [(64, 16), (100, 16), (16, 16), (7, 16)])
def test_dist_cholesky(grid_size, n, nb, real_dtype_p):
    dtype = real_dtype_p
    key = jax.random.PRNGKey(n + grid_size[0])
    a = gen.random_hermitian_positive_definite(key, n, dtype)
    grid = Grid(grid_size)
    dm = DistMatrix.from_global(a, nb, grid, pad_identity=True)
    out = cholesky(dm)
    lfull = np.asarray(out.to_global())
    l = np.tril(lfull)
    an = np.asarray(a)
    res = np.max(np.abs(l @ l.conj().T - an)) / max(n, 1)
    assert res <= tol(dtype, n, 50), (res, grid_size, n)
    # strict upper triangle must keep the original content
    np.testing.assert_array_equal(np.triu(lfull, 1), np.triu(an, 1))


@pytest.mark.parametrize("grid_size", [(2, 2), (2, 3)])
def test_dist_matches_local(grid_size):
    import dlaf_jax as dt
    n, nb = 96, 16
    a = gen.random_hermitian_positive_definite(jax.random.PRNGKey(0), n, np.dtype("float64"))
    grid = Grid(grid_size)
    dm = DistMatrix.from_global(a, nb, grid, pad_identity=True)
    ldist = np.tril(np.asarray(cholesky(dm).to_global()))
    lloc = np.asarray(dt.potrf(a, nb=16))
    assert np.max(np.abs(ldist - lloc)) <= tol(np.dtype("float64"), n, 100)


@pytest.mark.parametrize("grid_size,n,nb", [
    ((2, 3), 200, 32),   # tail panel overshoots padded local tiles
    ((2, 2), 304, 16),   # many panels, partial tail
    ((1, 4), 64, 64),    # single-tile matrix, wide-panel clamp
])
def test_dist_cholesky_wide_panel_tails(grid_size, n, nb):
    a = gen.random_hermitian_positive_definite(
        jax.random.PRNGKey(4), n, np.dtype("float64"))
    dm = DistMatrix.from_global(a, nb, Grid(grid_size), pad_identity=True)
    out = cholesky(dm)
    l = np.tril(np.asarray(out.to_global()))
    res = np.max(np.abs(l @ l.conj().T - np.asarray(a)))
    assert res <= 100 * n * np.finfo(np.float64).eps * \
        np.max(np.abs(np.asarray(a)))


@pytest.mark.parametrize("grid_size", [
    (1, 1), (2, 2), (2, 3),
    pytest.param((4, 1), marks=pytest.mark.slow),
    pytest.param((1, 8), marks=pytest.mark.slow)])
@pytest.mark.parametrize("n,nb", [(64, 16), (100, 16), (16, 16)])
def test_dist_cholesky_upper_native(grid_size, n, nb, real_dtype_p):
    """Native distributed upper-uplo POTRF (reference call_U,
    factorization/cholesky/impl.h:351) — no DistMatrix.transpose round-trip."""
    dtype = real_dtype_p
    key = jax.random.PRNGKey(n + 7 * grid_size[0])
    a = gen.random_hermitian_positive_definite(key, n, dtype)
    grid = Grid(grid_size)
    dm = DistMatrix.from_global(a, nb, grid, pad_identity=True)
    out = cholesky(dm, uplo="U")
    ufull = np.asarray(out.to_global())
    u = np.triu(ufull)
    an = np.asarray(a)
    res = np.max(np.abs(u.conj().T @ u - an)) / max(n, 1)
    assert res <= tol(dtype, n, 50), (res, grid_size, n)
    # strict lower triangle must keep the original content
    np.testing.assert_array_equal(np.tril(ufull, -1), np.tril(an, -1))
    # U must equal the L factor's adjoint
    l = np.tril(np.asarray(cholesky(dm).to_global()))
    np.testing.assert_allclose(u, l.conj().T, atol=tol(dtype, n, 50))


def test_dist_cholesky_upper_many_panels():
    """U path beyond UNROLL_MAX_PANELS panels widens its panels."""
    n, nb = 256, 16
    a = gen.random_hermitian_positive_definite(
        jax.random.PRNGKey(11), n, np.dtype("float64"))
    import dlaf_jax
    old = dlaf_jax.get_tune_parameters().potrf_dist_panel_width
    dlaf_jax.set_tune_parameters(potrf_dist_panel_width=16)
    try:
        dm = DistMatrix.from_global(a, nb, Grid((2, 2)), pad_identity=True)
        u = np.triu(np.asarray(cholesky(dm, uplo="U").to_global()))
        res = np.max(np.abs(u.conj().T @ u - np.asarray(a)))
        assert res <= 100 * n * np.finfo(np.float64).eps * \
            np.max(np.abs(np.asarray(a)))
    finally:
        dlaf_jax.set_tune_parameters(potrf_dist_panel_width=old)
