"""Distributed eigensolver tests (reference distributed
test_eigensolver.cpp / test_gen_eigensolver.cpp over grids)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dlaf_jax
from dlaf_jax.algos.eigensolver.dist_driver import eigh_dist, eigh_gen_dist
from dlaf_jax.algos.eigensolver.dist_red2band import reduction_to_band_dist
from dlaf_jax.algos.eigensolver.red2band import reduction_to_band
from dlaf_jax.comm.mesh import Grid
from dlaf_jax.matrix import generators as gen
from dlaf_jax.matrix.dist_matrix import DistMatrix
from dlaf_jax.types import eps


@pytest.mark.parametrize("grid_size", [(2, 2), (2, 3), (1, 4)])
def test_dist_red2band_matches_local(grid_size):
    n, nb = 64, 8
    a = gen.random_hermitian(jax.random.PRNGKey(0), n, np.float64)
    dm = DistMatrix.from_global(a, nb, Grid(grid_size))
    packed_d, taus_d = reduction_to_band_dist(dm)
    packed_l, taus_l = reduction_to_band(a, nb)
    # the packed contract covers ONLY the lower triangle (band diagonals +
    # reflectors strictly below; extract_band/packed_to_strips/
    # bt_reduction_to_band never read above the diagonal) — the dead upper
    # wedge legitimately differs between the local symmetric-window update
    # and the distributed panel sweep
    np.testing.assert_allclose(np.tril(np.asarray(packed_d.to_global())),
                               np.tril(np.asarray(packed_l)), atol=1e-12)
    np.testing.assert_allclose(np.asarray(taus_d)[:n], np.asarray(taus_l),
                               atol=1e-12)


def test_merge_tree_idle_fraction():
    """Idle cap on non-power-of-2 grids (reference supports ragged grids in
    mergeDistSubproblems, merge.h:1810-1941; here the stage-3 tree runs on
    the pow2 subset and the idle share is quantified + surfaced)."""
    from dlaf_jax.algos.eigensolver.tridiag_dc_dist import (
        merge_tree_idle_fraction)
    assert merge_tree_idle_fraction(1) == 0.0
    assert merge_tree_idle_fraction(4) == 0.0
    assert merge_tree_idle_fraction(6) == pytest.approx(1 / 3)
    assert merge_tree_idle_fraction(8) == 0.0


@pytest.mark.parametrize("grid_size", [(2, 2),
                                       # 6 ranks: the reference's ragged
                                       # fixture shape (grids_6_ranks.h)
                                       pytest.param((2, 3), marks=pytest.mark.slow),
                                       pytest.param((2, 4), marks=pytest.mark.slow)])
@pytest.mark.parametrize("n", [64,
                               pytest.param(90, marks=pytest.mark.slow)])
def test_dist_eigh(grid_size, n):
    dtype = np.dtype("float64")
    nb = 16
    a = gen.random_hermitian(jax.random.PRNGKey(1), n, dtype)
    dm = DistMatrix.from_global(a, nb, Grid(grid_size))
    w, v = eigh_dist(dm)
    w = np.asarray(w)
    vg = np.asarray(v.to_global())
    an = np.asarray(a)
    ref = np.linalg.eigvalsh(an)
    tol = 500 * n * eps(dtype)
    assert np.max(np.abs(w - ref)) <= tol
    assert np.max(np.abs(vg.T @ vg - np.eye(n))) <= tol
    assert np.max(np.abs(an @ vg - vg * w[None, :])) <= tol * np.max(np.abs(an))


def test_dist_eigh_gen():
    n, nb = 64, 16
    dtype = np.dtype("float64")
    a = gen.random_hermitian(jax.random.PRNGKey(2), n, dtype)
    b = gen.random_hermitian_positive_definite(jax.random.PRNGKey(3), n, dtype)
    grid = Grid((2, 2))
    da = DistMatrix.from_global(a, nb, grid)
    db = DistMatrix.from_global(b, nb, grid, pad_identity=True)
    w, x = eigh_gen_dist(da, db)
    w = np.asarray(w)
    xg = np.asarray(x.to_global())
    an, bn = np.asarray(a), np.asarray(b)
    tol = 2000 * n * eps(dtype) * np.max(np.abs(an))
    assert np.max(np.abs(an @ xg - bn @ xg * w[None, :])) <= tol
    assert np.max(np.abs(xg.T @ bn @ xg - np.eye(n))) <= tol


def test_dist_red2band_band_lt_nb():
    """band < nb (reference getBandSize + retiling): the distributed
    reduction with band-wide panels inside nb-tiles matches the spectrum."""
    from dlaf_jax.algos.eigensolver.dist_red2band import reduction_to_band_dist
    from dlaf_jax.algos.eigensolver.red2band import extract_band

    n, nb, band = 128, 32, 8
    a = gen.random_hermitian(jax.random.PRNGKey(5), n, np.dtype("float64"))
    dm = DistMatrix.from_global(a, nb, Grid((2, 4)))
    packed, taus = reduction_to_band_dist(dm, band)
    bandm = np.asarray(extract_band(jnp.asarray(packed.to_global()), band))
    ev = np.sort(np.linalg.eigvalsh(bandm))[:n]
    ref = np.linalg.eigvalsh(np.asarray(a))
    assert np.max(np.abs(ev - ref)) <= 100 * n * eps(np.float64) * \
        max(np.max(np.abs(ref)), 1)


def test_dist_eigh_band_lt_nb():
    """Full eigh_dist with the tuned band < nb path."""
    import dlaf_jax as dt

    old = dt.get_tune_parameters().eigensolver_min_band
    dt.set_tune_parameters(eigensolver_min_band=8)
    try:
        n, nb = 128, 32
        a = gen.random_hermitian(jax.random.PRNGKey(6), n, np.dtype("float64"))
        dm = DistMatrix.from_global(a, nb, Grid((2, 2)))
        w, v = eigh_dist(dm)
        w, vg = np.asarray(w), np.asarray(v.to_global())
        an = np.asarray(a)
        tol = 500 * n * eps(np.float64)
        assert np.max(np.abs(vg.T @ vg - np.eye(n))) <= tol
        assert np.max(np.abs(an @ vg - vg * w[None, :])) <= \
            tol * max(np.max(np.abs(an)), 1)
    finally:
        dt.set_tune_parameters(eigensolver_min_band=old)


def test_eigvalsh_dist():
    """Distributed eigenvalues-only driver (device-resident + fallback)."""
    from dlaf_jax.algos.eigensolver.dist_driver import eigvalsh_dist

    for gs, n, nb in (((2, 4), 128, 16), ((2, 3), 96, 16)):
        a = gen.random_hermitian(jax.random.PRNGKey(7), n, np.dtype("float64"))
        dm = DistMatrix.from_global(a, nb, Grid(gs))
        w = np.asarray(eigvalsh_dist(dm))
        ref = np.linalg.eigvalsh(np.asarray(a))
        assert np.max(np.abs(w - ref)) <= 100 * n * eps(np.float64) * \
            max(np.max(np.abs(ref)), 1)


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_dist_eigh_complex(dtype):
    """Hermitian (complex) distributed eigensolver: the subdiagonal phase
    normalization + complex back-transformations end-to-end on the mesh
    (reference dispatches {c,z} through the same pipeline,
    miniapp/include/dlaf/miniapp/dispatch.h:17-60)."""
    dtype = np.dtype(dtype)
    n, nb = 64, 16
    a = gen.random_hermitian(jax.random.PRNGKey(7), n, dtype)
    dm = DistMatrix.from_global(a, nb, Grid((2, 2)))
    w, v = eigh_dist(dm)
    w = np.asarray(w)
    vg = np.asarray(v.to_global())
    an = np.asarray(a)
    ref = np.linalg.eigvalsh(an)
    tol = 2000 * n * eps(dtype)
    assert w.dtype.kind == "f"
    assert np.max(np.abs(w - ref)) <= tol
    assert np.max(np.abs(vg.conj().T @ vg - np.eye(n))) <= tol
    assert np.max(np.abs(an @ vg - vg * w[None, :])) <= tol * np.abs(an).max()


def test_dist_eigh_complex_pipelined():
    """Complex + compute-distributed stage 2 (the pipelined chase supports
    all dtypes)."""
    from dlaf_jax.tune import get_tune_parameters, set_tune_parameters

    dtype = np.dtype("complex128")
    n, nb = 64, 16
    a = gen.random_hermitian(jax.random.PRNGKey(8), n, dtype)
    dm = DistMatrix.from_global(a, nb, Grid((2, 3)))
    old = get_tune_parameters().band_to_tridiag_dist_mode
    set_tune_parameters(band_to_tridiag_dist_mode="pipelined")
    try:
        w, v = eigh_dist(dm)
    finally:
        set_tune_parameters(band_to_tridiag_dist_mode=old)
    w = np.asarray(w)
    vg = np.asarray(v.to_global())
    an = np.asarray(a)
    ref = np.linalg.eigvalsh(an)
    tol = 2000 * n * eps(dtype)
    assert np.max(np.abs(w - ref)) <= tol
    assert np.max(np.abs(an @ vg - vg * w[None, :])) <= tol * np.abs(an).max()
