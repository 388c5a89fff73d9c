"""Distributed GEMM / HEMM / TRMM (SUMMA) tests."""
import jax
import numpy as np
import pytest

from dlaf_jax.algos import general as g
from dlaf_jax.comm.mesh import Grid
from dlaf_jax.matrix import generators as gen
from dlaf_jax.matrix.dist_matrix import DistMatrix

from conftest import tol

GRIDS = [(2, 2), (2, 3), (1, 4)]


@pytest.mark.parametrize("grid_size", GRIDS)
def test_dist_gemm(grid_size, dtype):
    m, k, n, nb = 64, 48, 32, 16
    a = gen.random_general(jax.random.PRNGKey(0), (m, k), dtype)
    b = gen.random_general(jax.random.PRNGKey(1), (k, n), dtype)
    c0 = gen.random_general(jax.random.PRNGKey(2), (m, n), dtype)
    grid = Grid(grid_size)
    da = DistMatrix.from_global(a, nb, grid)
    db = DistMatrix.from_global(b, nb, grid)
    dc = DistMatrix.from_global(c0, nb, grid)
    out = g.general_multiplication(da, db, dc, alpha=2.0, beta=-1.0)
    ref = 2.0 * np.asarray(a) @ np.asarray(b) - np.asarray(c0)
    assert np.max(np.abs(np.asarray(out.to_global()) - ref)) <= tol(dtype, k, 100)


@pytest.mark.parametrize("grid_size", [(2, 2), (2, 3)])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_dist_hemm(grid_size, uplo, dtype):
    n, m, nb = 64, 32, 16
    a = gen.random_hermitian(jax.random.PRNGKey(5), n, dtype)
    an = np.asarray(a)
    poison = np.full_like(an, 7.0)
    stored = np.tril(an) + np.triu(poison, 1) if uplo == "L" else \
        np.triu(an) + np.tril(poison, -1)
    b = gen.random_general(jax.random.PRNGKey(6), (n, m), dtype)
    grid = Grid(grid_size)
    da = DistMatrix.from_global(jax.numpy.asarray(stored), nb, grid)
    db = DistMatrix.from_global(b, nb, grid)
    out = g.hermitian_multiplication(da, db, uplo=uplo, alpha=0.5)
    ref = 0.5 * an @ np.asarray(b)
    assert np.max(np.abs(np.asarray(out.to_global()) - ref)) <= tol(dtype, n, 100)


@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("diag", ["N", "U"])
def test_dist_trmm(uplo, diag, dtype):
    n, m, nb = 64, 32, 16
    a = gen.random_triangular(jax.random.PRNGKey(7), n, dtype,
                              lower=(uplo == "L"), unit=(diag == "U"))
    b = gen.random_general(jax.random.PRNGKey(8), (n, m), dtype)
    grid = Grid((2, 2))
    da = DistMatrix.from_global(a, nb, grid)
    db = DistMatrix.from_global(b, nb, grid)
    out = g.triangular_multiplication(da, db, uplo=uplo, diag=diag, alpha=1.5)
    an = np.asarray(a)
    if diag == "U":
        an = an - np.diag(np.diag(an)) + np.eye(n, dtype=an.dtype)
    ref = 1.5 * an @ np.asarray(b)
    assert np.max(np.abs(np.asarray(out.to_global()) - ref)) <= tol(dtype, n, 100)
