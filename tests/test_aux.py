"""Norms, permutations, gen_to_std, distributed transpose."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dlaf_jax as dt
from dlaf_jax.algos import gen_to_std, norm, permutations
from dlaf_jax.comm.mesh import Grid
from dlaf_jax.matrix import generators as gen
from dlaf_jax.matrix.dist_matrix import DistMatrix

from conftest import tol


@pytest.mark.parametrize("uplo", ["G", "L", "U"])
def test_max_norm(uplo, dtype):
    n = 48
    a = gen.random_general(jax.random.PRNGKey(0), (n, n), dtype)
    an = np.asarray(a)
    ref = {"G": np.abs(an), "L": np.abs(np.tril(an)), "U": np.abs(np.triu(an))}[uplo].max()
    assert abs(float(norm.max_norm_local(a, uplo)) - ref) < 1e-12
    grid = Grid((2, 3))
    dm = DistMatrix.from_global(a, 16, grid)
    assert abs(float(norm.max_norm(dm, uplo)) - ref) < 1e-12


def test_permute(dtype):
    m, n = 32, 24
    a = gen.random_general(jax.random.PRNGKey(1), (m, n), dtype)
    perm = np.random.default_rng(0).permutation(m)
    out = permutations.permute_local(a, jnp.asarray(perm), axis=0)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(a)[perm])
    grid = Grid((2, 2))
    dm = DistMatrix.from_global(a, 8, grid)
    dout = permutations.permute(dm, perm, axis=0)
    np.testing.assert_allclose(np.asarray(dout.to_global()), np.asarray(a)[perm])


def test_gen_to_std(dtype):
    n = 64
    a = gen.random_hermitian(jax.random.PRNGKey(2), n, dtype)
    b = gen.random_hermitian_positive_definite(jax.random.PRNGKey(3), n, dtype)
    l = dt.potrf(b, nb=16)
    astd = gen_to_std.generalized_to_standard(a, l, nb=16)
    an = np.asarray(a)
    ln = np.asarray(l)
    linv = np.linalg.inv(ln)
    ref = linv @ an @ linv.conj().T
    assert np.max(np.abs(np.asarray(astd) - ref)) <= tol(dtype, n, 500)


def test_dist_transpose_square_grid(dtype):
    m, n = 48, 32
    a = gen.random_general(jax.random.PRNGKey(4), (m, n), dtype)
    grid = Grid((2, 2))
    dm = DistMatrix.from_global(a, 8, grid)
    t = dm.transpose()
    np.testing.assert_allclose(np.asarray(t.to_global()),
                               np.asarray(a).conj().T)


def test_dist_gen_to_std():
    n = 64
    dtype = np.dtype("float64")
    a = gen.random_hermitian(jax.random.PRNGKey(5), n, dtype)
    b = gen.random_hermitian_positive_definite(jax.random.PRNGKey(6), n, dtype)
    l = dt.potrf(b, nb=16)
    from dlaf_jax.ops.core import symmetrize_tri
    grid = Grid((2, 2))
    da = DistMatrix.from_global(symmetrize_tri(a, True), 16, grid)
    dl = DistMatrix.from_global(l, 16, grid, pad_identity=True)
    dastd = gen_to_std.generalized_to_standard_dist(da, dl)
    linv = np.linalg.inv(np.asarray(l))
    ref = linv @ np.asarray(a) @ linv.conj().T
    assert np.max(np.abs(np.asarray(dastd.to_global()) - ref)) <= tol(dtype, n, 500)


def test_dist_gen_to_std_upper():
    """uplo='U' distributed gen-to-std (one device-resident transpose)."""
    import dlaf_jax as dt
    from dlaf_jax.algos.gen_to_std import generalized_to_standard_dist
    from dlaf_jax.comm.mesh import Grid
    from dlaf_jax.matrix.dist_matrix import DistMatrix

    n, nb = 96, 16
    a = gen.random_hermitian(jax.random.PRNGKey(0), n, np.dtype("float64"))
    b = gen.random_hermitian_positive_definite(jax.random.PRNGKey(1), n,
                                               np.dtype("float64"))
    u = dt.potrf(b, uplo="U", nb=32)
    grid = Grid((2, 4))
    da = DistMatrix.from_global(a, nb, grid)
    du = DistMatrix.from_global(jnp.triu(u), nb, grid, pad_identity=True)
    out = generalized_to_standard_dist(da, du, uplo="U")
    un = np.triu(np.asarray(u))
    uinv = np.linalg.inv(un)
    ref = uinv.T @ np.asarray(a) @ uinv
    got = np.asarray(out.to_global())
    assert np.max(np.abs(got - ref)) <= 1e-10
