"""Distributed Right-side TRSM/TRMM (transpose reduction)."""
import jax
import numpy as np
import pytest

from dlaf_jax.algos.general import triangular_multiplication
from dlaf_jax.algos.triangular import triangular_solver
from dlaf_jax.comm.mesh import Grid
from dlaf_jax.matrix import generators as gen
from dlaf_jax.matrix.dist_matrix import DistMatrix

from conftest import tol


@pytest.mark.parametrize("grid_size", [(2, 2), (2, 3)])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["N", "T", "C"])
def test_dist_trsm_right(grid_size, uplo, trans):
    dtype = np.dtype("float64")
    m, k, nb = 48, 64, 16
    a = gen.random_triangular(jax.random.PRNGKey(0), k, dtype, lower=(uplo == "L"))
    b = gen.random_general(jax.random.PRNGKey(1), (m, k), dtype)
    grid = Grid(grid_size)
    da = DistMatrix.from_global(a, nb, grid, pad_identity=True)
    db = DistMatrix.from_global(b, nb, grid)
    x = triangular_solver(da, db, side="R", uplo=uplo, trans=trans, alpha=1.5)
    xn = np.asarray(x.to_global())
    an = np.asarray(a)
    opa = {"N": an, "T": an.T, "C": an.conj().T}[trans]
    res = np.max(np.abs(xn @ opa - 1.5 * np.asarray(b)))
    assert res <= tol(dtype, k, 200), (res, grid_size, uplo, trans)


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_dist_trmm_right(uplo):
    dtype = np.dtype("float64")
    m, k, nb = 48, 64, 16
    a = gen.random_triangular(jax.random.PRNGKey(2), k, dtype, lower=(uplo == "L"))
    b = gen.random_general(jax.random.PRNGKey(3), (m, k), dtype)
    grid = Grid((2, 2))
    da = DistMatrix.from_global(a, nb, grid)
    db = DistMatrix.from_global(b, nb, grid)
    y = triangular_multiplication(da, db, side="R", uplo=uplo, alpha=2.0)
    ref = 2.0 * np.asarray(b) @ np.asarray(a)
    assert np.max(np.abs(np.asarray(y.to_global()) - ref)) <= tol(dtype, k, 200)
