"""GPU lane: the local drivers compiled for the card, at modest sizes.

Run in one process on one card with
``DLAF_JAX_GPU_LANE=1 python -m pytest tests -m gpu``; on the CPU lane
every test here skips. The sizes are small, but a cold run still takes
more than five minutes: each eigensolver dtype is a fresh compile of one to
two minutes. ``chip_smoke.py`` covers ``eigh_large``, ``eigh_gen`` and the
full sizes.
"""
import jax.numpy as jnp
import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


def _passed(results):
    for r in results:
        print(r.line(), flush=True)
    return all(r.ok for r in results)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_potrf_gpu(dtype):
    assert _passed(cs.phase_potrf(2048, 256, dtype,
                                  canary=dtype == jnp.float32))


def test_trsm_gpu():
    assert _passed(cs.phase_trsm(2048, 512, 256))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.complex128])
def test_eigh_gpu(dtype):
    assert _passed(cs.phase_heev(512, dtype, large=False))
