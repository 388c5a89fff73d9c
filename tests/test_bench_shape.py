"""Bench-shape-class distributed tests (VERDICT r2 #9).

The regular distributed tests run tiny shapes (n <= 256, nb <= 32); the
benchmark runs nb=512 with band=128 and many tiles per rank.  That shape
class exercises different code: the wide-panel distributed Cholesky
buckets/clamps (algos/cholesky.py staircase trailing chunks), band < nb
panel retiling inside stage 1, and the strip-storage stage-2 layout at a
real band/nb ratio.  These tests run exactly that shape class on the
8-device CPU mesh — the analog of the reference exercising its benchmark
configuration under ctest (miniapp shapes are the test shapes,
miniapp/miniapp_cholesky.cpp:128-199).

Residuals use probe vectors (O(n^2) per probe) so host-side checking does
not dominate the single-core CPU budget at n in the thousands.
"""
import jax
import numpy as np
import pytest

from dlaf_jax.algos.cholesky import cholesky
from dlaf_jax.algos.eigensolver.dist_driver import eigh_dist
from dlaf_jax.comm.mesh import Grid
from dlaf_jax.matrix import generators as gen
from dlaf_jax.matrix.dist_matrix import DistMatrix

pytestmark = pytest.mark.slow


def _probes(n, k, seed, dtype):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, k)).astype(dtype)
    return u / np.linalg.norm(u, axis=0, keepdims=True)


def test_dist_cholesky_bench_shape():
    """n=8192, nb=512 on a 2x4 grid: 16 tile-rows over 2 process rows means
    the wide-panel loop sees full buckets, a staircase of trailing chunks,
    and the final clamped panel — the exact geometry bench.py times."""
    n, nb = 8192, 512
    dtype = np.dtype("float32")
    a = gen.random_hermitian_positive_definite(jax.random.PRNGKey(11), n, dtype)
    dm = DistMatrix.from_global(a, nb, Grid((2, 4)), pad_identity=True)
    out = cholesky(dm)
    l = np.tril(np.asarray(out.to_global()))
    an = np.asarray(a)
    u = _probes(n, 4, 0, dtype)
    # ||(A - L L^T) u|| / ||A u|| per probe, O(n^2) each
    ref = an @ u
    res = np.abs(l @ (l.T @ u) - ref)
    rel = res.max() / np.abs(ref).max()
    assert rel <= 100 * n * np.finfo(dtype).eps, rel


def test_dist_eigh_bench_shape():
    """n=4096, nb=512 (so band=128 via get_band_size) on a 2x4 grid: the
    band<nb retiled stage 1, strip-storage stage 2, and the sharded back
    transformations all at the bench band/nb ratio."""
    n, nb = 4096, 512
    dtype = np.dtype("float32")
    a = gen.random_hermitian(jax.random.PRNGKey(13), n, dtype)
    dm = DistMatrix.from_global(a, nb, Grid((2, 4)))
    w, v = eigh_dist(dm)
    w = np.asarray(w)
    vg = np.asarray(v.to_global())
    an = np.asarray(a)
    anorm = np.abs(an).max()
    tol = 500 * n * np.finfo(dtype).eps
    u = _probes(n, 4, 1, dtype)
    # orthonormality probe: V^T V u == u
    orth = np.abs(vg.T @ (vg @ u) - u).max()
    assert orth <= tol, orth
    # residual probe: A V u == V (w * u)
    res = np.abs(an @ (vg @ u) - vg @ (w[:, None] * u)).max() / anorm
    assert res <= tol, res
    # eigenvalue sanity: trace preserved, sorted ascending
    assert np.all(np.diff(w) >= -tol * anorm)
    assert abs(w.sum() - np.trace(an)) <= tol * anorm * np.sqrt(n)
