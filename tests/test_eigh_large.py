"""eigh_large: the memory-planned stage-split pipeline must match the
single-jit driver bit-for-bit in structure (same stages) and numerically
(same eps-scaled gates) — including the chunked stage-2 reflector record
(re-chase) and the j-chunked top-level merge GEMM.

Reference checks mirrored: eigensolver correctness residuals
``test/include/dlaf_test/eigensolver/test_eigensolver_correctness.h:71-96``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import dlaf_jax as dt
from dlaf_jax.algos.eigensolver.large import eigh_large
from dlaf_jax.matrix import generators as gen

from conftest import tol


def _check(an, w, v, n, dtype, factor=60):
    wn, vn = np.asarray(w), np.asarray(v)
    assert np.all(np.diff(wn) >= -tol(dtype, n))
    orth = np.max(np.abs(vn.T.conj() @ vn - np.eye(n)))
    res = np.max(np.abs(an @ vn - vn * wn[None, :]))
    scale = max(np.max(np.abs(an)), 1.0)
    assert orth <= factor * n * np.finfo(dtype).eps, orth
    assert res <= factor * n * np.finfo(dtype).eps * scale, res
    wref = np.linalg.eigvalsh(an)
    assert np.max(np.abs(wn - wref)) <= factor * n * np.finfo(dtype).eps * scale


@pytest.mark.parametrize("n,b,chunks", [
    (128, 32, 1),
    # n=256 sweeps in the slow lane (the fast gate keeps one size per
    # dtype; each of these costs 3-11s warm and compiles a second jumbo
    # dt.eigh program)
    pytest.param(256, 32, 2, marks=pytest.mark.slow),
    pytest.param(256, 64, 3, marks=pytest.mark.slow),
])
def test_eigh_large_matches_driver(n, b, chunks, real_dtype_p):
    dtype = real_dtype_p
    a = gen.random_hermitian(jax.random.PRNGKey(n + chunks), n,
                             jnp.dtype(dtype))
    an = np.asarray(a)
    w, v = eigh_large(a + 0, band=b, rec_chunks=chunks)
    _check(an, w, v, n, dtype)
    # same eigenvalues as the one-shot driver
    w1, _ = dt.eigh(a, band=b)
    np.testing.assert_allclose(np.asarray(w), np.asarray(w1),
                               atol=tol(dtype, n) * max(np.abs(an).max(), 1))


@pytest.mark.parametrize("dtype,n,b,chunks", [
    (np.complex64, 128, 32, 1),
    pytest.param(np.complex64, 256, 64, 2,
                 marks=pytest.mark.slow),
    pytest.param(np.complex128, 128, 32, 1, marks=pytest.mark.slow),
])
def test_eigh_large_complex(dtype, n, b, chunks):
    """Complex path: phase-normalized real tridiagonal (stage 3), phases
    folded into the stage-4 workspace pad, complex back-transforms
    (reference z-dispatch: miniapp/include/dlaf/miniapp/dispatch.h:17-60)."""
    from dlaf_jax.algos.eigensolver.large import eigvalsh_large
    a = gen.random_hermitian(jax.random.PRNGKey(n + chunks), n,
                             jnp.dtype(dtype))
    an = np.asarray(a)
    w, v = eigh_large(a + 0, band=b, rec_chunks=chunks)
    rdt = np.finfo(dtype).dtype
    _check(an, w, v, n, rdt)
    wv = eigvalsh_large(a + 0, band=b)
    np.testing.assert_allclose(np.asarray(wv), np.asarray(w),
                               atol=tol(rdt, n) * max(np.abs(an).max(), 1))


@pytest.mark.slow
def test_eigh_large_small_group_chunks():
    # chunk boundaries at multiples of a small WY group size exercise > 2
    # chunks without contract-scale shapes
    old = dt.get_tune_parameters().bt_band_to_tridiag_hh_apply_group_size
    dt.set_tune_parameters(bt_band_to_tridiag_hh_apply_group_size=16)
    try:
        n, b = 192, 32
        a = gen.random_hermitian(jax.random.PRNGKey(7), n, jnp.float32)
        an = np.asarray(a)
        w, v = eigh_large(a, band=b, rec_chunks=5)
        _check(an, w, v, n, np.float32)
    finally:
        dt.set_tune_parameters(bt_band_to_tridiag_hh_apply_group_size=old)


def test_eigh_large_timers_and_guards():
    a = gen.random_hermitian(jax.random.PRNGKey(3), 128, jnp.float32)
    w, v, stage_s = eigh_large(a, band=32, timers=True)
    assert set(stage_s) == {"stage1_red2band", "stage2_band2tridiag",
                            "stage3_tridiag_dc", "stage4_bt_band2tridiag",
                            "stage4a_rechase", "stage4b_apply",
                            "stage5_bt_red2band"}
    # the sub-stage split accounts for (almost all of) stage 4
    assert stage_s["stage4a_rechase"] + stage_s["stage4b_apply"] <= \
        stage_s["stage4_bt_band2tridiag"] * 1.01 + 0.05
    with pytest.raises(ValueError):
        eigh_large(jnp.zeros((100, 100), jnp.float32), band=32)  # n % b
    with pytest.raises(ValueError):
        eigh_large(jnp.zeros((32, 32), jnp.float32), band=32)    # n <= b


def test_merge_vectors_j_chunked_matches():
    """The fused j-chunked rank-one contraction (the huge-merge memory
    plan) must reproduce the one-shot path."""
    from dlaf_jax.algos.eigensolver.tridiag_dc import (_jacobi_eigh, _merge,
                                                       _merge_vectors)
    rng = np.random.default_rng(0)
    n = 64
    d = jnp.asarray(np.sort(rng.standard_normal(n)).astype(np.float64))
    z = jnp.asarray(rng.standard_normal(n).astype(np.float64))
    rho = jnp.asarray(0.7, jnp.float64)
    t1 = jax.vmap(_jacobi_eigh)(jnp.stack([
        jnp.diag(d[:32]), jnp.diag(d[32:])]))
    q1t, q2t = t1[1][0].T, t1[1][1].T
    lam, zhat, ds, perm, root, defl, rots = _merge(d, z, rho,
                                                   jnp.asarray(2.0), 60)
    lam_a, q_a = _merge_vectors(q1t, q2t, lam, zhat, perm, root, defl, rots,
                                ds, j_chunk=None)
    lam_b, q_b = _merge_vectors(q1t, q2t, lam, zhat, perm, root, defl, rots,
                                ds, j_chunk=16)
    np.testing.assert_allclose(np.asarray(lam_a), np.asarray(lam_b),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(np.asarray(q_a), np.asarray(q_b),
                               rtol=0, atol=1e-12)


def test_tridiag_top_merge_j_chunked_matches(monkeypatch):
    """The driver's vmapped top merge with the j-chunk plan switched on (at
    a tiny threshold) reproduces the unchunked solve."""
    from dlaf_jax.algos.eigensolver import tridiag_dc as tdc
    rng = np.random.default_rng(1)
    n = 256
    d = jnp.asarray(rng.standard_normal(n))
    e = jnp.asarray(rng.standard_normal(n - 1))
    w0, q0 = tdc.tridiag_eigh(d, e, 60)
    monkeypatch.setattr(tdc, "J_CHUNK_MIN", n)
    monkeypatch.setattr(tdc, "J_CHUNK", 64)
    jax.clear_caches()       # the plan is fixed at trace time
    w1, q1 = tdc.tridiag_eigh(d, e, 60)
    jax.clear_caches()
    np.testing.assert_allclose(np.asarray(w1), np.asarray(w0), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(np.abs(np.asarray(q1)), np.abs(np.asarray(q0)),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_argsort_int32_stable(dtype):
    from dlaf_jax.algos.eigensolver.tridiag_dc import argsort
    x = jnp.asarray(np.array([3.0, 1.0, 2.0, 1.0, np.nan, -1.0], dtype))
    idx = argsort(x)
    assert idx.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(idx), [5, 1, 3, 2, 0, 4])
