"""dlaf_jax — distributed dense linear algebra in JAX.

A ground-up rebuild of DLA-Future's capability surface (tiled Cholesky,
triangular solve/multiply, Hermitian multiply, general GEMM, two-stage
symmetric/Hermitian (generalized) eigensolver): SPMD over a 2-D device mesh
with block-cyclic sharding, tile operations lowered by XLA to the vendor
libraries (cuBLAS/cuSOLVER on the GPU), XLA collectives for row/column
broadcasts and reductions, and static recursive blocking in place of the
reference's dynamic sender/receiver task graph.
"""
from . import dist, ops, types
from .api.local import gemm, hemm, herk, potrf, potrf_info, trmm, trsm
from .tune import TuneParameters, get_tune_parameters, set_tune_parameters


def eigh(*args, **kw):
    """Hermitian eigensolver (two-stage); see algos.eigensolver.driver.eigh."""
    from .algos.eigensolver.driver import eigh as _eigh
    return _eigh(*args, **kw)


def eigh_gen(*args, **kw):
    """Generalized hermitian eigensolver; see algos.eigensolver.driver.eigh_gen."""
    from .algos.eigensolver.driver import eigh_gen as _eigh_gen
    return _eigh_gen(*args, **kw)


def eigh_large(*args, **kw):
    """Memory-planned stage-split eigensolver for contract-scale n
    (consumes its input); see algos.eigensolver.large.eigh_large."""
    from .algos.eigensolver.large import eigh_large as _eigh_large
    return _eigh_large(*args, **kw)


def hegst(*args, **kw):
    """Generalized-to-standard transform; see algos.gen_to_std."""
    from .algos.gen_to_std import generalized_to_standard
    return generalized_to_standard(*args, **kw)


def eigvalsh(a, uplo: str = "L", **kw):
    """Eigenvalues only (skips both back-transformations)."""
    from .algos.eigensolver.band2tridiag import band_to_tridiag_auto as band_to_tridiag_pipelined
    from .algos.eigensolver.driver import _phase_normalize, eigh, get_band_size
    from .algos.eigensolver.red2band import extract_band, reduction_to_band
    from .algos.eigensolver.tridiag_dc import tridiag_eigh
    import jax.numpy as jnp
    from .ops.core import ct

    a = jnp.asarray(a)
    n = a.shape[0]
    if uplo == "U":
        a = ct(a)
    tune = get_tune_parameters()
    b = kw.get("band") or get_band_size(tune.default_block_size)
    if n <= b or n % b:
        return eigh(a, **kw)[0]
    packed, _ = reduction_to_band(a, b)
    d, e, _, _ = band_to_tridiag_pipelined(extract_band(packed, b), b)
    er, _ = _phase_normalize(e, a.dtype)
    w, _ = tridiag_eigh(jnp.real(d), er, tune.laed4_max_iter)
    return w[:n]


__version__ = "0.1.0"

__all__ = [
    "dist", "ops", "types",
    "potrf", "potrf_info", "trsm", "trmm", "hemm", "herk", "gemm",
    "eigh", "eigh_gen", "eigh_large", "eigvalsh", "hegst",
    "TuneParameters", "get_tune_parameters", "set_tune_parameters",
]
