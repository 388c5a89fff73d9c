"""Distributed triangular solver tests (Left cases, several grids)."""
import jax
import numpy as np
import pytest

from dlaf_jax.algos.triangular import triangular_solver
from dlaf_jax.comm.mesh import Grid
from dlaf_jax.matrix import generators as gen
from dlaf_jax.matrix.dist_matrix import DistMatrix

from conftest import tol


@pytest.mark.parametrize("grid_size", [(2, 2), (2, 4), (1, 1), (2, 3)])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["N", "T", "C"])
def test_dist_trsm_left(grid_size, uplo, trans):
    dtype = np.dtype("float64")
    n, m, nb = 80, 48, 16
    a = gen.random_triangular(jax.random.PRNGKey(3), n, dtype, lower=(uplo == "L"))
    b = gen.random_general(jax.random.PRNGKey(4), (n, m), dtype)
    grid = Grid(grid_size)
    da = DistMatrix.from_global(a, nb, grid, pad_identity=True)
    db = DistMatrix.from_global(b, nb, grid)
    x = triangular_solver(da, db, uplo=uplo, trans=trans, alpha=2.0)
    xn = np.asarray(x.to_global())
    an = np.asarray(a)
    opa = {"N": an, "T": an.T, "C": an.conj().T}[trans]
    res = np.max(np.abs(opa @ xn - 2.0 * np.asarray(b)))
    assert res <= tol(dtype, n, 100), (res, grid_size, uplo, trans)


@pytest.mark.parametrize("case_dtype", ["complex128"])
@pytest.mark.parametrize("trans", ["N", "C", "T"])
def test_dist_trsm_complex(case_dtype, trans):
    dtype = np.dtype(case_dtype)
    n, m, nb = 64, 32, 16
    a = gen.random_triangular(jax.random.PRNGKey(3), n, dtype, lower=True)
    b = gen.random_general(jax.random.PRNGKey(4), (n, m), dtype)
    grid = Grid((2, 2))
    da = DistMatrix.from_global(a, nb, grid, pad_identity=True)
    db = DistMatrix.from_global(b, nb, grid)
    x = triangular_solver(da, db, uplo="L", trans=trans)
    xn = np.asarray(x.to_global())
    an = np.asarray(a)
    opa = {"N": an, "T": an.T, "C": an.conj().T}[trans]
    res = np.max(np.abs(opa @ xn - np.asarray(b)))
    assert res <= tol(dtype, n, 100), (res, trans)
