"""ScaLAPACK-flavored API + io tests (reference test/unit/c_api/**)."""
import numpy as np
import pytest

import dlaf_jax as dt
from dlaf_jax.api import scalapack as sl
from dlaf_jax.matrix import generators as gen
from dlaf_jax.matrix.io import MatrixFile

import jax


def test_grid_registry():
    ctx = sl.dlaf_create_grid(2, 2)
    ctx2 = sl.dlaf_create_grid(1, 4)
    assert ctx != ctx2
    assert sl.dlaf_get_grid(ctx).grid_size == (2, 2)
    sl.dlaf_free_grid(ctx)
    with pytest.raises(KeyError):
        sl.dlaf_get_grid(ctx)
    sl.dlaf_free_all_grids()


def test_descriptor_from_scalapack():
    desc9 = [1, 0, 100, 80, 16, 16, 0, 0, 50]
    d = sl.DLAF_descriptor.from_scalapack(desc9)
    assert (d.m, d.n, d.mb, d.nb, d.ld) == (100, 80, 16, 16, 50)


def test_scalapack_local_roundtrip():
    a = np.arange(23 * 17, dtype=np.float64).reshape(23, 17)
    desc = sl.DLAF_descriptor(m=23, n=17, mb=4, nb=4)
    locs = sl.to_scalapack_locals(a, desc, (2, 3))
    # numroc sizes
    total = sum(l.size for row in locs for l in row)
    assert total == 23 * 17 + sum(l.size for row in locs for l in row) - 23 * 17
    back = sl.from_scalapack_locals(locs, desc, (2, 3))
    np.testing.assert_array_equal(a, back)


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_pdpotrf(uplo):
    n = 40
    a = np.asarray(gen.random_hermitian_positive_definite(
        jax.random.PRNGKey(0), n, np.float64))
    ctx = sl.dlaf_create_grid(2, 2)
    desc = sl.DLAF_descriptor(m=n, n=n, mb=8, nb=8)
    out = sl.dlaf_pdpotrf(uplo, n, a, 1, 1, desc, ctx)
    if uplo == "L":
        l = np.tril(out)
        np.testing.assert_allclose(l @ l.T, a, atol=1e-10)
        np.testing.assert_array_equal(np.triu(out, 1), np.triu(a, 1))
    else:
        u = np.triu(out)
        np.testing.assert_allclose(u.T @ u, a, atol=1e-10)
    sl.dlaf_free_grid(ctx)


def test_pdsyevd():
    n = 48
    a = np.asarray(gen.random_hermitian(jax.random.PRNGKey(1), n, np.float64))
    ctx = sl.dlaf_create_grid(1, 1)
    desc = sl.DLAF_descriptor(m=n, n=n, mb=16, nb=16)
    import dlaf_jax
    dlaf_jax.set_tune_parameters(eigensolver_min_band=8, default_block_size=16)
    try:
        w, z = sl.dlaf_pdsyevd("L", n, a, 1, 1, desc, ctx)
        np.testing.assert_allclose(a @ z, z * w[None, :], atol=1e-10)
    finally:
        dlaf_jax.tune.reset_tune_parameters()
        sl.dlaf_free_grid(ctx)


def test_pdsyevd_routes_through_grid():
    """The eigensolver entry must solve DISTRIBUTED through the ctx grid
    (reference src/c_api/eigensolver/eigensolver.cpp builds the Matrix on
    the registered grid)."""
    n = 48
    a = np.asarray(gen.random_hermitian(jax.random.PRNGKey(2), n, np.float64))
    ctx = sl.dlaf_create_grid(2, 3)
    import dlaf_jax
    dlaf_jax.set_tune_parameters(eigensolver_min_band=8, default_block_size=16)
    try:
        desc = sl.DLAF_descriptor(m=n, n=n, mb=16, nb=16)
        w, z = sl.dlaf_pdsyevd("L", n, a, 1, 1, desc, ctx)
        np.testing.assert_allclose(a @ z, z * w[None, :], atol=1e-9)
        np.testing.assert_allclose(z.T @ z, np.eye(n), atol=1e-9)
    finally:
        dlaf_jax.tune.reset_tune_parameters()
        sl.dlaf_free_grid(ctx)


@pytest.mark.slow
def test_pdsygvd_grid():
    n = 48
    a = np.asarray(gen.random_hermitian(jax.random.PRNGKey(3), n, np.float64))
    b = np.asarray(gen.random_hermitian_positive_definite(
        jax.random.PRNGKey(4), n, np.float64))
    ctx = sl.dlaf_create_grid(2, 2)
    import dlaf_jax
    dlaf_jax.set_tune_parameters(eigensolver_min_band=8, default_block_size=16)
    try:
        desc = sl.DLAF_descriptor(m=n, n=n, mb=16, nb=16)
        w, x = sl.dlaf_pdsygvd("L", n, a, b, 1, 1, desc, ctx)
        np.testing.assert_allclose(a @ x, b @ x * w[None, :], atol=1e-8)
    finally:
        dlaf_jax.tune.reset_tune_parameters()
        sl.dlaf_free_grid(ctx)


def test_pdpotrf_submatrix_offset():
    """Tile-aligned ia/ja sub-matrix offsets (reference DLAF_descriptor i/j,
    include/dlaf_c/desc.h:16)."""
    m, nsub, nb = 64, 32, 8
    rng = np.random.default_rng(5)
    full = rng.standard_normal((m, m))
    spd = np.eye(nsub) * nsub + 0.1 * np.ones((nsub, nsub))
    i0 = j0 = 16  # tile-aligned offset
    full[i0:i0 + nsub, j0:j0 + nsub] = spd
    ctx = sl.dlaf_create_grid(2, 2)
    desc = sl.DLAF_descriptor(m=m, n=m, mb=nb, nb=nb)
    out = sl.dlaf_pdpotrf("L", nsub, full, i0 + 1, j0 + 1, desc, ctx)
    l = np.tril(out[i0:i0 + nsub, j0:j0 + nsub])
    np.testing.assert_allclose(l @ l.T, spd, atol=1e-10)
    # the rest of the matrix is untouched
    mask = np.ones((m, m), bool)
    mask[i0:i0 + nsub, j0:j0 + nsub] = False
    np.testing.assert_array_equal(out[mask], full[mask])
    sl.dlaf_free_grid(ctx)


def test_pdsygvd_submatrix_offset():
    """Tile-aligned ia/ja offsets on the GENERALIZED entry (reference
    dlaf_pssygvd per-matrix (i, j, desc) triplets,
    include/dlaf_c/eigensolver/gen_eigensolver.h:147-164)."""
    m, nsub, nb = 64, 32, 16
    rng = np.random.default_rng(6)
    fulla = rng.standard_normal((m, m))
    fullb = rng.standard_normal((m, m))
    asub = np.asarray(gen.random_hermitian(jax.random.PRNGKey(7), nsub,
                                           np.float64))
    bsub = np.asarray(gen.random_hermitian_positive_definite(
        jax.random.PRNGKey(8), nsub, np.float64))
    i0, j0 = 16, 32   # distinct tile-aligned offsets
    fulla[i0:i0 + nsub, j0:j0 + nsub] = asub
    ib0 = jb0 = 0
    fullb[ib0:ib0 + nsub, jb0:jb0 + nsub] = bsub
    ctx = sl.dlaf_create_grid(2, 2)
    import dlaf_jax
    dlaf_jax.set_tune_parameters(eigensolver_min_band=8, default_block_size=16)
    try:
        desc = sl.DLAF_descriptor(m=m, n=m, mb=nb, nb=nb)
        w, x = sl.dlaf_pdsygvd("L", nsub, fulla, fullb, i0 + 1, j0 + 1, desc,
                               ctx, ib=ib0 + 1, jb=jb0 + 1)
        np.testing.assert_allclose(asub @ x, bsub @ x * w[None, :], atol=1e-8)
    finally:
        dlaf_jax.tune.reset_tune_parameters()
        sl.dlaf_free_grid(ctx)


def test_matrix_file(tmp_path):
    f = MatrixFile(str(tmp_path / "dump"))
    a = np.random.default_rng(0).standard_normal((8, 8))
    w = np.arange(8.0)
    f.write(**{"/input": a, "/evals": w})
    np.testing.assert_array_equal(f.read("/input"), a)
    np.testing.assert_array_equal(f.read("evals"), w)
    f.write(**{"/evecs": a})  # append keeps old datasets
    assert set(f.read_all()) == {"input", "evals", "evecs"}


def test_pzheevd_and_pchegvd():
    """Complex ScaLAPACK entries (reference dlaf_pcheevd/pzheevd,
    pchegvd/pzhegvd typed surface, include/dlaf_c/eigensolver/)."""
    n = 48
    a = np.asarray(gen.random_hermitian(jax.random.PRNGKey(3), n,
                                        np.complex128))
    b = np.asarray(gen.random_hermitian_positive_definite(
        jax.random.PRNGKey(4), n, np.complex128))
    ctx = sl.dlaf_create_grid(2, 2)
    import dlaf_jax
    dlaf_jax.set_tune_parameters(eigensolver_min_band=8, default_block_size=16)
    try:
        desc = sl.DLAF_descriptor(m=n, n=n, mb=16, nb=16)
        w, z = sl.dlaf_pzheevd("L", n, a, 1, 1, desc, ctx)
        assert w.dtype.kind == "f"
        np.testing.assert_allclose(a @ z, z * w[None, :], atol=1e-9)
        np.testing.assert_allclose(z.conj().T @ z, np.eye(n), atol=1e-9)
        wg, x = sl.dlaf_pzhegvd("L", n, a, b, 1, 1, desc, ctx)
        np.testing.assert_allclose(a @ x, b @ x * wg[None, :], atol=1e-8)
        np.testing.assert_allclose(x.conj().T @ b @ x, np.eye(n), atol=1e-8)
    finally:
        dlaf_jax.tune.reset_tune_parameters()
        sl.dlaf_free_grid(ctx)
