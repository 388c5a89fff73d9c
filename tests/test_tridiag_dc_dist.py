"""Distributed tridiagonal D&C (reference merge.h:1810-1941 parity)."""
import jax
import numpy as np
import jax.numpy as jnp
import pytest

from dlaf_jax.algos.eigensolver.tridiag_dc_dist import (dc_dist_supported,
                                                        tridiag_eigh_dist)
from dlaf_jax.comm.mesh import Grid

from conftest import tol


@pytest.mark.parametrize("grid_size", [(2, 4), (2, 3), (2, 2), (1, 2),
                                       (1, 1)])
@pytest.mark.parametrize("n", [64, 100,
                               pytest.param(256, marks=pytest.mark.slow)])
def test_tridiag_dc_dist(real_dtype_p, grid_size, n):
    dtype = real_dtype_p
    grid = Grid(grid_size)
    assert dc_dist_supported(n, grid_size[0] * grid_size[1])
    d = jax.random.normal(jax.random.PRNGKey(0), (n,)).astype(dtype)
    e = jax.random.normal(jax.random.PRNGKey(1), (n - 1,)).astype(dtype)
    lam, q, m = tridiag_eigh_dist(d, e, grid.mesh)
    lam, q = np.asarray(lam)[:n], np.asarray(q)[:n, :n]
    t = np.diag(np.asarray(d)) + np.diag(np.asarray(e), 1) + \
        np.diag(np.asarray(e), -1)
    bound = tol(dtype, n, 100)
    assert np.max(np.abs(q.T @ q - np.eye(n))) <= bound
    assert np.max(np.abs(t @ q - q * lam[None, :])) <= bound
    ref = np.linalg.eigvalsh(t.astype(np.float64))
    assert np.max(np.abs(np.sort(lam) - ref)) <= bound


def test_dc_dist_supported_gate():
    assert dc_dist_supported(256, 8)
    assert dc_dist_supported(256, 6)          # non-power-of-2: pow2 subset
    assert dc_dist_supported(256, 12)
    assert dc_dist_supported(31, 1)
    assert not dc_dist_supported(31, 64)      # more devices than padded size


@pytest.mark.parametrize("grid_size", [(2, 3), (1, 6)])
def test_eigh_dist_non_pow2(grid_size):
    """Non-power-of-2 device counts run the device-resident pipeline
    (merge tree on the pow2 subset, reference 6-rank fixture analog,
    grids_6_ranks.h:25-70)."""
    from dlaf_jax.algos.eigensolver.dist_driver import eigh_dist
    from dlaf_jax.matrix import generators as gen
    from dlaf_jax.matrix.dist_matrix import DistMatrix
    n, nb = 64, 16
    grid = Grid(grid_size)
    h = gen.random_hermitian(jax.random.PRNGKey(3), n, jnp.float64)
    dh = DistMatrix.from_global(h, nb, grid)
    w, v = eigh_dist(dh)
    w, vg = np.asarray(w), np.asarray(v.to_global())
    hn = np.asarray(h)
    bound = tol(np.dtype("float64"), n, 100)
    assert np.max(np.abs(hn @ vg - vg * w[None, :])) <= bound
    assert np.max(np.abs(vg.T.conj() @ vg - np.eye(n))) <= bound


def test_stage2_sweep_chunked_record():
    """Sweep-chunked vs/taus reassemble to the full record."""
    from dlaf_jax.algos.eigensolver import band_strips as bs
    n, b = 50, 8
    a = jax.random.normal(jax.random.PRNGKey(0), (n, n), jnp.float64)
    a = a + a.T
    rows = jnp.arange(n)
    band = jnp.where(abs(rows[:, None] - rows[None, :]) <= b, a, 0)
    strips = bs.band_to_strips(band, b)
    d0, e0, vs0, t0 = bs.band_to_tridiag_strips(strips, n, b)
    nsweeps = n - 2
    chunk = -(-nsweeps // 4)
    parts = [bs.band_to_tridiag_strips(strips, n, b, sweep_lo=k * chunk,
                                       sweep_chunk=chunk)
             for k in range(4)]
    vs_cat = np.concatenate([np.asarray(p[2]) for p in parts])[:nsweeps]
    t_cat = np.concatenate([np.asarray(p[3]) for p in parts])[:nsweeps]
    assert np.allclose(vs_cat, np.asarray(vs0))
    assert np.allclose(t_cat, np.asarray(t0))


def test_tridiag_dc_dist_orthogonality_matches_local():
    """The row-sharded merges (mode B) must keep the local D&C's
    orthogonality: the Gu/Eisenstat zhat needs lam - ds_i formed with the
    pole difference first. A tridiagonal from a real band reduction has the
    close roots that expose a rounded form (2e-12 vs 5e-15 at n = 512)."""
    from dlaf_jax.algos.eigensolver.band2tridiag import band_to_tridiag_auto
    from dlaf_jax.algos.eigensolver.red2band import (extract_band,
                                                     reduction_to_band)
    from dlaf_jax.matrix import generators as gen
    n, b = 512, 64
    a = gen.random_hermitian(jax.random.PRNGKey(3), n, jnp.float64)
    packed, _ = reduction_to_band(a, b)
    d, e, _, _ = band_to_tridiag_auto(extract_band(packed, b), b)
    lam, q, _ = tridiag_eigh_dist(jnp.real(d), jnp.real(e),
                                  Grid((2, 2)).mesh, col_align=b)
    q = np.asarray(q)[:n, :n]
    assert np.max(np.abs(q.T @ q - np.eye(n))) <= tol(np.float64, n, 10)
