"""Local (single-device) POTRF/TRSM/TRMM/HERK/HEMM/GEMM correctness.

Mirrors the reference's per-algorithm local tests
(test/unit/factorization/test_cholesky.cpp, test/unit/solver/test_triangular.cpp,
...): size sweeps including degenerate and non-tile-multiple cases, residuals
checked against eps-scaled bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dlaf_jax as dt
from dlaf_jax.matrix import generators as gen
from dlaf_jax.types import eps

from conftest import tol

SIZES = [1, 7, 64, 130, 300]


def _norm(x):
    return float(jnp.max(jnp.abs(x))) if x.size else 0.0


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_potrf(n, uplo, dtype):
    key = jax.random.PRNGKey(n)
    a = gen.random_hermitian_positive_definite(key, n, dtype)
    f = dt.potrf(a, uplo=uplo, nb=64)
    f = np.asarray(f)
    an = np.asarray(a)
    rec = f @ f.conj().T if uplo == "L" else f.conj().T @ f
    res = _norm(rec - an) / max(n, 1)
    assert res <= tol(dtype, n, 50), res
    # other triangle zeroed
    tri = np.triu(f, 1) if uplo == "L" else np.tril(f, -1)
    assert _norm(tri) == 0.0


@pytest.mark.parametrize("case_dtype", ["float64", "complex128"])
@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["N", "T", "C"])
@pytest.mark.parametrize("diag", ["N", "U"])
def test_trsm_trmm_cases(side, uplo, trans, diag, case_dtype):
    _check_trsm_trmm(130, 70, side, uplo, trans, diag, np.dtype(case_dtype))


@pytest.mark.parametrize("m,n", [(1, 1), (7, 3), (64, 64), (96, 200)])
def test_trsm_trmm_sizes(m, n, real_dtype_p):
    _check_trsm_trmm(m, n, "L", "L", "N", "N", real_dtype_p)


def _check_trsm_trmm(m, n, side, uplo, trans, diag, dtype):
    na = m if side == "L" else n
    key = jax.random.PRNGKey(7 * m + n)
    a = gen.random_triangular(key, na, dtype, lower=(uplo == "L"), unit=(diag == "U"))
    b = gen.random_general(jax.random.PRNGKey(1), (m, n), dtype)
    alpha = 1.5
    x = dt.trsm(a, b, side=side, uplo=uplo, trans=trans, diag=diag, alpha=alpha, nb=64)
    # check op(A) X = alpha B via trmm (independent path uses numpy)
    an = np.asarray(a)
    opa = {"N": an, "T": an.T, "C": an.conj().T}[trans]
    if diag == "U":
        opa = opa - np.diag(np.diag(opa)) + np.eye(na, dtype=opa.dtype)
    xn = np.asarray(x)
    lhs = opa @ xn if side == "L" else xn @ opa
    res = _norm(lhs - alpha * np.asarray(b))
    assert res <= tol(dtype, max(m, n), 100), res

    y = dt.trmm(a, b, side=side, uplo=uplo, trans=trans, diag=diag, alpha=alpha, nb=64)
    ref = alpha * (opa @ np.asarray(b)) if side == "L" else alpha * (np.asarray(b) @ opa)
    assert _norm(np.asarray(y) - ref) <= tol(dtype, max(m, n), 100)


@pytest.mark.parametrize("n,k", [(64, 32), (130, 70), (7, 130)])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["N", "C"])
def test_herk(n, k, uplo, trans, dtype):
    key = jax.random.PRNGKey(3)
    shape = (n, k) if trans == "N" else (k, n)
    a = gen.random_general(key, shape, dtype)
    c0 = gen.random_hermitian(jax.random.PRNGKey(4), n, dtype)
    c = dt.herk(a, c0, uplo=uplo, trans=trans, alpha=0.5, beta=2.0)
    an = np.asarray(a)
    g = an @ an.conj().T if trans == "N" else an.conj().T @ an
    full = 2.0 * np.asarray(c0) + 0.5 * g
    cn = np.asarray(c)
    if uplo == "L":
        assert _norm(np.tril(cn) - np.tril(full)) <= tol(dtype, max(n, k), 100)
        assert _norm(np.triu(cn, 1) - np.triu(np.asarray(c0), 1)) == 0.0
    else:
        assert _norm(np.triu(cn) - np.triu(full)) <= tol(dtype, max(n, k), 100)
        assert _norm(np.tril(cn, -1) - np.tril(np.asarray(c0), -1)) == 0.0


@pytest.mark.parametrize("n,m", [(64, 32), (130, 70)])
@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_hemm(n, m, side, uplo, dtype):
    key = jax.random.PRNGKey(5)
    a = gen.random_hermitian(key, n, dtype)
    # store only the referenced triangle, poison the other
    an = np.asarray(a)
    poison = np.full_like(an, 42.0)
    stored = np.tril(an) + np.triu(poison, 1) if uplo == "L" else \
        np.triu(an) + np.tril(poison, -1)
    bshape = (n, m) if side == "L" else (m, n)
    b = gen.random_general(jax.random.PRNGKey(6), bshape, dtype)
    c0 = gen.random_general(jax.random.PRNGKey(8), bshape, dtype)
    c = dt.hemm(jnp.asarray(stored), b, c0, side=side, uplo=uplo, alpha=0.5, beta=-1.0)
    ref = 0.5 * (an @ np.asarray(b)) - np.asarray(c0) if side == "L" else \
        0.5 * (np.asarray(b) @ an) - np.asarray(c0)
    assert _norm(np.asarray(c) - ref) <= tol(dtype, max(n, m), 100)


@pytest.mark.parametrize("transa", ["N", "T", "C"])
@pytest.mark.parametrize("transb", ["N", "T", "C"])
def test_gemm(transa, transb, dtype):
    m, n, k = 40, 30, 50
    sa = (m, k) if transa == "N" else (k, m)
    sb = (k, n) if transb == "N" else (n, k)
    a = gen.random_general(jax.random.PRNGKey(0), sa, dtype)
    b = gen.random_general(jax.random.PRNGKey(1), sb, dtype)
    c0 = gen.random_general(jax.random.PRNGKey(2), (m, n), dtype)
    c = dt.gemm(a, b, c0, transa=transa, transb=transb, alpha=2.0, beta=-0.5)
    def op(x, t):
        x = np.asarray(x)
        return {"N": x, "T": x.T, "C": x.conj().T}[t]
    ref = 2.0 * op(a, transa) @ op(b, transb) - 0.5 * np.asarray(c0)
    assert _norm(np.asarray(c) - ref) <= tol(dtype, k, 100)
