"""Wavefront (pipelined) bulge-chase schedule tests.

The t = 3s + c schedule must be bit-identical to the sequential sweep loop
(band_strips.band_to_tridiag_strips) — the property that makes the
compute-distributed stage 2 exact, not approximate (reference pipelines
sweeps the same way via SweepWorkerDist handoff,
eigensolver/band_to_tridiag/mc.h:568-661).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dlaf_jax.algos.eigensolver.band_strips import (
    band_to_strips, band_to_tridiag_strips, band_to_tridiag_wavefront)


def _band_matrix(n, b, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal((n, n))
    a = a + a.conj().T
    r = np.arange(n)
    mask = np.abs(r[:, None] - r[None, :]) <= b
    return jnp.asarray(np.where(mask, a, 0).astype(dtype))


@pytest.mark.parametrize("n,b", [(16, 2), (24, 3), (33, 4), (20, 5)])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_wavefront_matches_sequential(n, b, dtype):
    a = _band_matrix(n, b, dtype)
    strips = band_to_strips(a, b)
    d0, e0, vs0, t0 = band_to_tridiag_strips(strips, n, b)
    d1, e1, vs1, t1 = band_to_tridiag_wavefront(strips, n, b)
    np.testing.assert_array_equal(np.asarray(d0), np.asarray(d1))
    np.testing.assert_array_equal(np.asarray(e0), np.asarray(e1))
    np.testing.assert_array_equal(np.asarray(vs0), np.asarray(vs1))
    np.testing.assert_array_equal(np.asarray(t0), np.asarray(t1))


@pytest.mark.parametrize("grid_size,n,b", [
    ((2, 4), 40, 3), ((2, 3), 40, 3), ((1, 8), 40, 3), ((8, 1), 40, 3),
    ((1, 1), 40, 3),
    # larger shape: catches handoff-merge rounding the tiny cases cannot
    # (an additive delta merge only diverges once many handoffs compound)
    ((2, 4), 256, 16), ((2, 3), 256, 16)])
def test_pipelined_dist_matches_sequential(grid_size, n, b):
    """Compute-distributed (pipelined) stage 2 on the CPU mesh: identical
    (d, e) and sweep-sharded reflector record as the sequential kernel."""
    from dlaf_jax.algos.eigensolver.dist_stage23 import (
        band_to_tridiag_dist_pipelined)
    from dlaf_jax.comm.mesh import Grid

    a = _band_matrix(n, b, "float64", seed=3)
    strips = band_to_strips(a, b)
    d0, e0, vs0, t0 = band_to_tridiag_strips(strips, n, b)
    mesh = Grid(grid_size).mesh
    d1, e1, vs1, t1 = band_to_tridiag_dist_pipelined(strips, n, b, mesh)
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d0))
    np.testing.assert_array_equal(np.asarray(e1), np.asarray(e0))
    nsweeps = n - 2
    v1 = np.asarray(vs1)
    tt1 = np.asarray(t1)
    np.testing.assert_array_equal(v1[:nsweeps], np.asarray(vs0))
    np.testing.assert_array_equal(tt1[:nsweeps], np.asarray(t0))
    # padded sweeps are no-ops
    assert np.all(tt1[nsweeps:] == 0)


def test_pipelined_dist_complex():
    from dlaf_jax.algos.eigensolver.dist_stage23 import (
        band_to_tridiag_dist_pipelined)
    from dlaf_jax.comm.mesh import Grid

    n, b = 30, 4
    a = _band_matrix(n, b, "complex128", seed=4)
    strips = band_to_strips(a, b)
    d0, e0, vs0, t0 = band_to_tridiag_strips(strips, n, b)
    d1, e1, vs1, t1 = band_to_tridiag_dist_pipelined(
        strips, n, b, Grid((2, 4)).mesh)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d0), atol=1e-13)
    np.testing.assert_allclose(np.asarray(e1), np.asarray(e0), atol=1e-13)
    np.testing.assert_allclose(np.asarray(vs1)[:n - 2], np.asarray(vs0),
                               atol=1e-13)


def test_eigh_dist_pipelined_mode():
    """End-to-end eigh_dist with the pipelined stage 2 (tune knob)."""
    import dlaf_jax
    from dlaf_jax.algos.eigensolver.dist_driver import eigh_dist
    from dlaf_jax.comm.mesh import Grid
    from dlaf_jax.matrix import generators as gen
    from dlaf_jax.matrix.dist_matrix import DistMatrix
    from dlaf_jax.tune import get_tune_parameters, set_tune_parameters

    n, nb = 64, 16
    a = gen.random_hermitian(jax.random.PRNGKey(6), n, np.dtype("float64"))
    dm = DistMatrix.from_global(a, nb, Grid((2, 2)))
    old = get_tune_parameters().band_to_tridiag_dist_mode
    set_tune_parameters(band_to_tridiag_dist_mode="pipelined")
    try:
        w, v = eigh_dist(dm)
    finally:
        set_tune_parameters(band_to_tridiag_dist_mode=old)
    w = np.asarray(w)
    an = np.asarray(a)
    vg = np.asarray(v.to_global())
    ref = np.linalg.eigvalsh(an)
    tol = 500 * n * np.finfo(np.float64).eps
    assert np.max(np.abs(w - ref)) <= tol
    assert np.max(np.abs(an @ vg - vg * w[None, :])) <= tol * np.abs(an).max()
