"""Strip-storage stage 2: the strip kernel against the dense reference
kernel (reference parity:
``eigensolver/band_to_tridiag/mc.h``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dlaf_jax.algos.eigensolver import band_strips as bs
from dlaf_jax.algos.eigensolver.band2tridiag import band_to_tridiag as dense_ref

from conftest import tol


def _band(n, b, dtype, key=0):
    a = jax.random.normal(jax.random.PRNGKey(key), (n, n)).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * jax.random.normal(jax.random.PRNGKey(key + 7), (n, n)).astype(dtype)
    a = a + a.conj().T
    rows = jnp.arange(n)
    return jnp.where(abs(rows[:, None] - rows[None, :]) <= b, a, 0)


def test_strips_roundtrip():
    n, b = 37, 4
    band = _band(n, b, np.float64)
    strips = bs.band_to_strips(band, b)
    d, e = bs.strips_extract_tridiag(strips, n, b)
    assert np.allclose(np.asarray(d), np.real(np.diagonal(band)))
    assert np.allclose(np.asarray(e), np.asarray(jnp.diagonal(band, -1)))


@pytest.mark.parametrize("n,b", [
    (37, 4),
    pytest.param(64, 8, marks=pytest.mark.slow),
    pytest.param(50, 5, marks=pytest.mark.slow),
    (20, 16),
])
def test_strips_kernel_matches_dense(dtype, n, b):
    band = _band(n, b, dtype)
    d0, e0, vs0, t0 = dense_ref(band, b)
    strips = bs.band_to_strips(band, b)
    d1, e1, vs1, t1 = bs.band_to_tridiag_strips(strips, n, b)
    bound = tol(dtype, n, 1000)
    assert float(jnp.max(jnp.abs(d0 - d1))) <= bound
    assert float(jnp.max(jnp.abs(e0 - e1))) <= bound
    assert float(jnp.max(jnp.abs(vs0 - vs1))) <= bound
    assert float(jnp.max(jnp.abs(t0 - t1))) <= bound


def test_packed_to_strips_matches_extract_band():
    from dlaf_jax.algos.eigensolver.red2band import extract_band, reduction_to_band
    n, b = 64, 8
    a = jax.random.normal(jax.random.PRNGKey(1), (n, n), jnp.float64)
    a = a + a.T
    packed, _ = reduction_to_band(a, b)
    band = extract_band(packed, b)
    s_ref = bs.band_to_strips(band, b)
    s_new = bs.packed_to_strips(packed, b)
    assert np.allclose(np.asarray(s_ref), np.asarray(s_new))
