"""Eigensolver correctness tests.

Ports the reference's test strategy
(test/unit/eigensolver/test_eigensolver.cpp sweeping sizes incl. degenerate
cases; residual bounds from
test/include/dlaf_test/eigensolver/test_eigensolver_correctness.h:71-96):
sorted eigenvalues, ||E^H E - I|| <= c m eps, ||A E - E Lambda|| <= c 2 m eps ||A||.
"""
import jax
import numpy as np
import pytest

import dlaf_jax
from dlaf_jax.algos.eigensolver.driver import eigh, eigh_gen, get_band_size
from dlaf_jax.algos.eigensolver.tridiag_dc import tridiag_eigh
from dlaf_jax.matrix import generators as gen
from dlaf_jax.types import eps


@pytest.fixture(autouse=True)
def small_bands():
    dlaf_jax.set_tune_parameters(eigensolver_min_band=8, default_block_size=16)
    yield
    dlaf_jax.tune.reset_tune_parameters()


def _check_eigh(a, w, v, factor=200):
    a = np.asarray(a)
    w = np.asarray(w)
    v = np.asarray(v)
    n = a.shape[0]
    tol = factor * max(n, 1) * eps(a.dtype) * max(1.0, np.max(np.abs(a)) if a.size else 1.0)
    assert np.all(np.diff(w) >= -tol), "eigenvalues not ascending"
    if n:
        assert np.max(np.abs(v.conj().T @ v - np.eye(n))) <= tol
        assert np.max(np.abs(a @ v - v * w[None, :])) <= tol


@pytest.mark.parametrize("n", [0, 1, 2, 5, 16, 34, 64,
                               pytest.param(150, marks=pytest.mark.slow)])
def test_eigh_sizes(n, real_dtype_p):
    a = gen.random_hermitian(jax.random.PRNGKey(n + 1), n, real_dtype_p)
    w, v = eigh(a)
    factor = 2000 if real_dtype_p == np.dtype("float32") else 200
    _check_eigh(a, w, v, factor)


@pytest.mark.parametrize("cdtype", ["complex64", "complex128"])
@pytest.mark.parametrize("n", [5, 48,
                               pytest.param(100, marks=pytest.mark.slow)])
def test_eigh_complex(n, cdtype):
    dtype = np.dtype(cdtype)
    a = gen.random_hermitian(jax.random.PRNGKey(n), n, dtype)
    w, v = eigh(a)
    factor = 2000 if dtype == np.dtype("complex64") else 200
    _check_eigh(a, w, v, factor)


def test_eigh_gen_complex():
    n = 64
    dtype = np.dtype("complex128")
    a = gen.random_hermitian(jax.random.PRNGKey(1), n, dtype)
    b = gen.random_hermitian_positive_definite(jax.random.PRNGKey(2), n, dtype)
    w, x = eigh_gen(a, b)
    an, bn = np.asarray(a), np.asarray(b)
    w, x = np.asarray(w), np.asarray(x)
    tol_ = 1000 * n * eps(dtype) * np.max(np.abs(an))
    assert np.max(np.abs(an @ x - bn @ x * w[None, :])) <= tol_
    assert np.max(np.abs(x.conj().T @ bn @ x - np.eye(n))) <= tol_


def test_eigh_uplo_upper():
    n = 48
    a = gen.random_hermitian(jax.random.PRNGKey(3), n, np.dtype("float64"))
    an = np.asarray(a)
    # poison the lower triangle; algorithm must only read the upper
    poisoned = np.triu(an) + np.tril(np.full_like(an, 99.0), -1)
    w, v = eigh(jax.numpy.asarray(poisoned), uplo="U")
    _check_eigh(an, w, v)


def test_eigh_multiple_eigenvalues():
    n = 64
    d = np.repeat([1.0, 2.0, 3.0, 4.0], 16)
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * d[None, :]) @ q.T
    a = (a + a.T) / 2
    w, v = eigh(jax.numpy.asarray(a))
    _check_eigh(a, w, v)
    assert np.max(np.abs(np.asarray(w) - np.sort(d))) < 1e-12


def test_tridiag_direct():
    rng = np.random.default_rng(7)
    n = 300
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    lam, q = tridiag_eigh(jax.numpy.asarray(d), jax.numpy.asarray(e))
    t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    _check_eigh(t, lam, q)


@pytest.mark.parametrize("factorized", [False, True])
def test_eigh_gen(factorized):
    n = 80
    dtype = np.dtype("float64")
    a = gen.random_hermitian(jax.random.PRNGKey(1), n, dtype)
    b = gen.random_hermitian_positive_definite(jax.random.PRNGKey(2), n, dtype)
    if factorized:
        import dlaf_jax as dt
        l = dt.potrf(b, nb=16)
        w, x = eigh_gen(a, l, factorized=True)
    else:
        w, x = eigh_gen(a, b)
    an, bn = np.asarray(a), np.asarray(b)
    w, x = np.asarray(w), np.asarray(x)
    tol = 1000 * n * eps(dtype) * np.max(np.abs(an))
    assert np.max(np.abs(an @ x - bn @ x * w[None, :])) <= tol
    assert np.max(np.abs(x.T @ bn @ x - np.eye(n))) <= tol


def test_get_band_size():
    dlaf_jax.set_tune_parameters(eigensolver_min_band=64)
    assert get_band_size(256) == 64
    assert get_band_size(96) == 96
    dlaf_jax.set_tune_parameters(eigensolver_min_band=8)
    assert get_band_size(96) == 8
