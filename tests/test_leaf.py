"""Single-tile leaves (dlaf_jax/ops/leaf.py) against numpy, for every
dtype of the reference's {s,d,c,z} matrix."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dlaf_jax.matrix import generators as gen
from dlaf_jax.ops.leaf import potrf_leaf, trsm_leaf

from conftest import tol

NB = 48


@pytest.mark.parametrize("upper", [False, True])
def test_potrf_leaf(dtype, upper):
    a = gen.random_hermitian_positive_definite(jax.random.PRNGKey(0), NB,
                                               dtype)
    f = np.asarray(potrf_leaf(a, upper=upper))
    an = np.asarray(a)
    ref = np.linalg.cholesky(an)
    if upper:
        ref = ref.conj().T
        assert np.all(np.tril(f, -1) == 0)
    else:
        assert np.all(np.triu(f, 1) == 0)
    scale = np.abs(an).max()
    assert np.abs(f - ref).max() <= tol(dtype, NB) * np.sqrt(scale)


@pytest.mark.parametrize("left", [True, False])
@pytest.mark.parametrize("lower", [True, False])
def test_trsm_leaf(dtype, left, lower):
    a = gen.random_triangular(jax.random.PRNGKey(1), NB, dtype, lower=lower)
    shape = (NB, 24) if left else (24, NB)
    b = gen.random_general(jax.random.PRNGKey(2), shape, dtype)
    trans = "C" if np.issubdtype(dtype, np.complexfloating) else "T"
    for tr in ("N", trans):
        x = np.asarray(trsm_leaf(a, b, left=left, lower=lower, trans=tr,
                                 unit=False))
        an = np.asarray(a)
        op = an if tr == "N" else an.conj().T
        lhs = op @ x if left else x @ op
        scale = np.abs(an).max() * max(np.abs(x).max(), 1.0)
        assert np.abs(lhs - np.asarray(b)).max() <= tol(dtype, NB) * scale
