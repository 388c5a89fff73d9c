"""No single-precision product runs at DEFAULT precision.

On the GPU a float32 ``dot_general`` without an explicit precision may run
in TF32 on the tensor cores (~3 decimal digits). This walks the jaxpr of
POTRF, TRSM, every eigensolver stage and the distributed drivers at
float32 / complex64 (tracing
only, no compile) and asserts each single-precision ``dot_general``
carries a precision above DEFAULT, so a TF32 leak fails here without a
card.
"""
import jax
import jax.numpy as jnp
import pytest
from jax.extend import core as jcore

import dlaf_jax as dt
from dlaf_jax.algos.eigensolver import band_strips as bs
from dlaf_jax.algos.eigensolver.band2tridiag import band_to_tridiag_auto
from dlaf_jax.algos.eigensolver.bt import (bt_band_to_tridiag,
                                           bt_reduction_to_band)
from dlaf_jax.algos.eigensolver.red2band import (extract_band,
                                                 reduction_to_band)
from dlaf_jax.algos.eigensolver.tridiag_dc import tridiag_eigh
from dlaf_jax.matrix import generators as gen

N, B = 64, 16
SINGLE = (jnp.float32, jnp.complex64)


def _subjaxprs(params):
    for v in params.values():
        for x in (v if isinstance(v, (tuple, list)) else (v,)):
            if isinstance(x, jcore.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jcore.Jaxpr):
                yield x


def default_precision_dots(jaxpr):
    """Single-precision dot_generals at DEFAULT precision, recursively."""
    bad = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and any(
                v.aval.dtype in SINGLE for v in eqn.invars):
            prec = eqn.params.get("precision")
            if prec is None or all(
                    p in (None, jax.lax.Precision.DEFAULT)
                    for p in (prec if isinstance(prec, tuple) else (prec,))):
                bad.append(str(eqn)[:160])
        for sub in _subjaxprs(eqn.params):
            bad += default_precision_dots(sub)
    return bad


def _inputs(dtype):
    a = gen.random_hermitian(jax.random.PRNGKey(0), N, dtype)
    spd = gen.random_hermitian_positive_definite(jax.random.PRNGKey(1), N,
                                                 dtype)
    packed, taus = reduction_to_band(a, B)
    band = extract_band(packed, B)
    d, e, vs, t2 = band_to_tridiag_auto(band, B)
    q = jnp.eye(N, dtype=dtype)
    return dict(a=a, spd=spd, packed=packed, taus=taus, band=band,
                d=jnp.real(d), e=jnp.real(e), vs=vs, t2=t2, q=q)


CASES = {
    "potrf_L": lambda x: (lambda s: dt.potrf(s, uplo="L", nb=B), x["spd"]),
    "potrf_U": lambda x: (lambda s: dt.potrf(s, uplo="U", nb=B), x["spd"]),
    "trsm": lambda x: (lambda s: dt.trsm(s, s, side="R", uplo="L",
                                         trans="C", nb=B), x["spd"]),
    "red2band": lambda x: (lambda a: reduction_to_band(a, B), x["a"]),
    "band2tridiag": lambda x: (lambda bd: band_to_tridiag_auto(bd, B),
                               x["band"]),
    "band2tridiag_strips": lambda x: (
        lambda bd: bs.band_to_tridiag_strips(bs.band_to_strips(bd, B), N, B),
        x["band"]),
    "bt_band2tridiag": lambda x: (
        lambda q: bt_band_to_tridiag(q, x["vs"], x["t2"], B, group_size=8),
        x["q"]),
    "bt_red2band": lambda x: (
        lambda q: bt_reduction_to_band(q, x["packed"], x["taus"], B),
        x["q"]),
    "eigh": lambda x: (lambda a: dt.eigh(a, band=B), x["a"]),
    "eigh_gen": lambda x: (lambda a: dt.eigh_gen(a, x["spd"], band=B),
                           x["a"]),
    "eigh_large": lambda x: (lambda a: dt.eigh_large(a, band=B), x["a"]),
    "eigh_dist": lambda x: (_eigh_dist, x["a"]),
    "cholesky_dist": lambda x: (_cholesky_dist, x["spd"]),
}


def _grid():
    from dlaf_jax.comm.mesh import Grid
    return Grid((2, 2), devices=jax.devices()[:4])


def _eigh_dist(a):
    from dlaf_jax.algos.eigensolver.dist_driver import eigh_dist
    from dlaf_jax.matrix.dist_matrix import DistMatrix
    w, v = eigh_dist(DistMatrix.from_global(a, B, _grid()))
    return w, v.data


def _cholesky_dist(a):
    from dlaf_jax.algos.cholesky import cholesky
    from dlaf_jax.matrix.dist_matrix import DistMatrix
    return cholesky(DistMatrix.from_global(a, B, _grid(),
                                           pad_identity=True)).data


@pytest.mark.parametrize("dtype", SINGLE, ids=["f32", "c64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_no_default_precision_dot(case, dtype):
    fn, arg = CASES[case](_inputs(dtype))
    bad = default_precision_dots(jax.make_jaxpr(fn)(arg).jaxpr)
    assert not bad, "\n".join(bad[:5])


def int64_sorts(jaxpr):
    """``sort`` equations carrying an int64 operand, recursively: XLA:GPU
    rejects the int64 argsort pattern (see tridiag_dc.argsort)."""
    bad = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "sort" and any(
                v.aval.dtype == jnp.int64 for v in eqn.invars):
            bad.append(str(eqn)[:160])
        for sub in _subjaxprs(eqn.params):
            bad += int64_sorts(sub)
    return bad


@pytest.mark.parametrize("case", ["eigh", "eigh_large", "eigh_dist"])
def test_no_int64_sort(case):
    fn, arg = CASES[case](_inputs(jnp.float64))
    assert not int64_sorts(jax.make_jaxpr(fn)(arg).jaxpr)


@pytest.mark.parametrize("dtype", [jnp.float32])
def test_tridiag_dc_no_default_precision_dot(dtype):
    d = jnp.linspace(1.0, 2.0, N, dtype=dtype)
    e = jnp.full((N - 1,), 0.5, dtype)
    bad = default_precision_dots(
        jax.make_jaxpr(lambda d, e: tridiag_eigh(d, e, 60))(d, e).jaxpr)
    assert not bad, "\n".join(bad[:5])


def test_walker_flags_an_int64_sort():
    x = jnp.arange(5.0)
    assert int64_sorts(jax.make_jaxpr(jnp.argsort)(x).jaxpr)


def test_walker_flags_a_default_dot():
    x = jnp.ones((4, 4), jnp.float32)
    jp = jax.make_jaxpr(lambda x: jax.lax.fori_loop(
        0, 2, lambda i, y: y @ x, x))(x).jaxpr
    assert default_precision_dots(jp)
