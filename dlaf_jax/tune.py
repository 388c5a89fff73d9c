"""Runtime-tunable parameters and the config override chain.

Analog of the reference's ``include/dlaf/tune.h:91-136`` +
``src/init.cpp:111-304`` config system: defaults live in a dataclass, each
field can be overridden by an environment variable ``DLAF_JAX_<NAME>`` and by
an explicit keyword to :func:`initialize` / :func:`set_tune_parameters`
(precedence: defaults < env < explicit, matching the reference's
defaults < ``DLAF_*`` env < ``--dlaf:*`` CLI chain).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

_ENV_PREFIX = "DLAF_JAX_"


@dataclasses.dataclass
class TuneParameters:
    # default tile/block size used by the LAPACK-flavored API when the caller
    # does not specify one (reference miniapps default nb=512; 256 was tuned
    # on earlier hardware and is not yet measured on the GPU)
    default_block_size: int = 256
    # leaf size at which blocked recursions switch to a single-tile kernel
    leaf_block_size: int = 128
    # distributed POTRF wide-panel width in ELEMENTS (rounded to a multiple
    # of Q tiles): the trailing update runs as one k = width GEMM per panel
    # (reference look-ahead panel, factorization/cholesky/impl.h:218-221)
    potrf_dist_panel_width: int = 2048
    # column chunks per wide distributed trailing update (staircase herk
    # approximation: computed area = 1/2 + 1/(2*chunks) of the rectangle;
    # more chunks waste fewer flops but add per-chunk dispatch/masking)
    potrf_dist_trail_chunks: int = 24
    # eigensolver: band size = smallest divisor of nb >= this (reference
    # include/dlaf/eigensolver/internal/get_band_size.h:20 and
    # tune.h eigensolver_min_band). Stage 2 runs ~n^2/b chase windows, so a
    # wider band means fewer sequential steps; the value is not yet
    # measured on the GPU
    eigensolver_min_band: int = 128
    # group size for applying band->tridiag Householder reflectors to the
    # eigenvector matrix (reference tune.h:130; the reference's own scaling
    # runs set 128, gen_dlaf_strong-gpu.py:20-38)
    bt_band_to_tridiag_hh_apply_group_size: int = 128
    # number of secular-equation (laed4) Newton iterations in the tridiagonal
    # divide & conquer merge (analog of tridiag_rank1_* tuning, tune.h:117-124)
    laed4_max_iter: int = 120
    # band->tridiag kernel: "pipelined" (batched dense wavefront, 8x faster
    # than "strips" at n = 10240 on an H100), "strips" (O(n*b) strip
    # storage, sequential chase) or "sequential" (dense sweep loop)
    band_to_tridiag_kernel: str = "pipelined"
    # distributed stage-2 mode: "replicated" chases the whole O(n*b) band on
    # every device; "pipelined" distributes the chase compute itself across
    # devices (wavefront schedule + 2-strip halo handoff between neighbour
    # devices, the reference's SweepWorkerDist analog,
    # band_to_tridiag/mc.h:568-661) -- ~D/2x less chase work per device
    band_to_tridiag_dist_mode: str = "replicated"
    # matmul precision for f32 inputs: "default" lets the GPU run f32
    # products on the tensor cores in TF32 (~3 decimal digits); "float32"
    # and "highest" both keep full f32 (LAPACK-grade residuals need it)
    matmul_precision: str = "float32"
    # debug dumps (reference tune.h:29-57 HDF5 debug switches)
    debug_dump_cholesky_data: bool = False
    debug_dump_eigensolver_data: bool = False
    debug_dump_path: str = "dlaf_jax_dump"


def _coerce(val: str, typ):
    if typ is bool:
        return val.strip().lower() in ("1", "true", "yes", "on")
    return typ(val)


def _from_env(base: TuneParameters) -> TuneParameters:
    kw = {}
    for f in dataclasses.fields(TuneParameters):
        env = os.environ.get(_ENV_PREFIX + f.name.upper())
        if env is not None:
            kw[f.name] = _coerce(env, f.type if isinstance(f.type, type) else type(getattr(base, f.name)))
    return dataclasses.replace(base, **kw)


_params: Optional[TuneParameters] = None


def get_tune_parameters() -> TuneParameters:
    """Singleton accessor (reference ``getTuneParameters()``)."""
    global _params
    if _params is None:
        _params = _validate(_from_env(TuneParameters()))
    return _params


# string-valued knobs with a closed set of values: a typo must error, not
# silently select the default dispatch branch
_CHOICES = {
    "band_to_tridiag_kernel": {"strips", "pipelined", "sequential"},
    "band_to_tridiag_dist_mode": {"replicated", "pipelined"},
    "matmul_precision": {"default", "float32", "highest"},
}


def _validate(params: TuneParameters) -> TuneParameters:
    for name, allowed in _CHOICES.items():
        v = getattr(params, name)
        if v not in allowed:
            raise ValueError(f"tune parameter {name}={v!r}: "
                             f"expected one of {sorted(allowed)}")
    return params


def set_tune_parameters(**overrides) -> TuneParameters:
    """Apply explicit overrides INCREMENTALLY on top of the current
    parameters (defaults < env < accumulated explicit overrides — the
    reference mutates its config singleton the same way,
    ``src/init.cpp:111-180``); use :func:`reset_tune_parameters` to drop
    all explicit overrides."""
    global _params
    base = get_tune_parameters()
    unknown = set(overrides) - {f.name for f in dataclasses.fields(TuneParameters)}
    if unknown:
        raise ValueError(f"unknown tune parameters: {sorted(unknown)}")
    _params = _validate(dataclasses.replace(base, **overrides))
    return _params


def reset_tune_parameters() -> None:
    global _params
    _params = None
