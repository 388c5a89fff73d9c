"""Distributed hermitian eigensolver driver.

Reference: distributed ``Eigensolver<B,D,T>::call``
(``eigensolver/eigensolver/impl.h:57-95``) and ``GenEigensolver::call``.

Device-resident end-to-end: every stage operates on sharded/replicated
jax.Arrays — there is no host gather between ``from_global`` and the result.

  - stage 1 (reduction to band, the dominant ~4n^3/3 flops): fully
    distributed 2-D SPMD (:mod:`dist_red2band`);
  - band extraction: one psum into replicated O(n*b) strip storage
    (:func:`dist_stage23.strips_from_packed_dist`) — the reference's 1-D
    band re-distribution analog;
  - stage 2 (band -> tridiag): replicated chasing of the O(n*b) band
    (latency-bound, like the reference's deliberately-CPU stage,
    ``band_to_tridiag/api.h:37-42``) with the O(n^2) reflector record
    sweep-sharded over devices;
  - stage 3 (tridiag D&C): explicitly distributed merges
    (:mod:`tridiag_dc_dist`), eigenvector matrix partitioned at every level;
  - both back-transformations: column-sharded eigenvector matrix, reflector
    groups broadcast, all flops local (:mod:`dist_stage23`);
  - final: one GSPMD resharding into the canonical block-cyclic layout.

Per-device peak memory: O(n^2/PQ + n*b). Any device count runs
device-resident: non-power-of-2 counts execute the D&C merge tree on the
largest power-of-2 device subset and re-engage every device for the
back-transformations (see :mod:`tridiag_dc_dist`). Only the degenerate
more-devices-than-padded-size case falls back to the gathered pipeline
(``_eigh_dist_gathered``).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ...matrix.dist_matrix import DistMatrix
from ...tune import get_tune_parameters
from ...types import is_complex_dtype
from .band2tridiag import band_to_tridiag_auto as band_to_tridiag
from .bt import bt_band_to_tridiag, bt_reduction_to_band
from .dist_red2band import reduction_to_band_dist
from .driver import _phase_normalize
from .red2band import extract_band
from .tridiag_dc import tridiag_eigh
from .tridiag_dc_dist import (dc_dist_supported, merge_tree_idle_fraction,
                              pow2_floor, tridiag_eigh_dist)


def _square_lattice(a: DistMatrix) -> DistMatrix:
    """Embed the canonical shards in a SQUARE padded lattice (pm == pn).

    ``Distribution.padded_size`` rounds rows up by P*mb and columns by Q*nb,
    so on grids with P != Q (or P == Q with uneven tail tiles) a square
    matrix can get a non-square canonical lattice — and when pm > pn the
    eigensolver's decoupled padding diagonal (rows/cols n..pm) would not be
    representable. Padding every shard with whole zero tiles up to the
    lcm(P, Q)-aligned square lattice is a purely LOCAL zero-pad in the
    canonical (P, Q, lm, ln) layout — no data movement.
    """
    import math

    from ...dist import Distribution
    P_, Q_ = a.grid.grid_size
    mb, nb = a.dist.block_size
    lmt, lnt = a.dist.max_local_nr_tiles
    lc = math.lcm(P_, Q_)
    mt = -(-max(lmt * P_, lnt * Q_) // lc) * lc
    if (mt * nb, mt * nb) == a.dist.padded_size:
        return a
    pad = ((0, 0), (0, 0), (0, (mt // P_ - lmt) * mb),
           (0, (mt // Q_ - lnt) * nb))
    dist = Distribution((mt * nb, mt * nb), (nb, nb), a.grid.grid_size)
    grid = a.grid
    data = _pad_shards(a.data, pad=pad, sharding=grid.canonical_sharding())
    return DistMatrix(data, dist, grid)


@functools.partial(jax.jit, static_argnames=("pad", "sharding"))
def _pad_shards(data, *, pad, sharding):
    return jax.lax.with_sharding_constraint(jnp.pad(data, pad), sharding)


def eigh_dist(a: DistMatrix, laed4_iter: int | None = None):
    """Eigen-decomposition of a distributed hermitian matrix (lower stored).

    Returns (w (n,), v DistMatrix over the same grid).
    """
    n = a.dist.size[0]
    tune = get_tune_parameters()
    laed4 = laed4_iter or tune.laed4_max_iter
    D = a.grid.mesh.devices.size
    orig_dist = a.dist
    a_sq = _square_lattice(a)
    pm = a_sq.dist.padded_size[0]
    if not dc_dist_supported(pm, D):
        return _eigh_dist_gathered(a, laed4)
    if D != pow2_floor(D) and not _IDLE_WARNED[0]:
        _IDLE_WARNED[0] = True
        print(f"dlaf_jax: {D}-device grid is not a power of two; the "
              f"stage-3 merge tree runs on {pow2_floor(D)} devices "
              f"({merge_tree_idle_fraction(D):.0%} idle during that stage "
              f"only; all other stages use all {D})")
    a = a_sq

    from . import dist_stage23 as s23

    nb = a.block_size
    mesh = a.grid.mesh
    dt_ = a.data.dtype
    # band < nb (reference getBandSize + retiling): stage 1 panels are
    # band-wide inside nb-tiles, stage 2 chases the cheap narrow band
    from .driver import get_band_size
    band = get_band_size(nb)

    # decouple the padding block device-side (large separated diagonal)
    data = s23._pad_fix(a.data, nb=nb, n=n, pm=pm, mesh=mesh)
    a = DistMatrix(data, a.dist, a.grid)

    packed, taus1 = reduction_to_band_dist(a, band)

    strips = s23.strips_from_packed_dist(packed, band)
    d, e, vs, taus2 = s23.band_to_tridiag_dist(strips, pm, band, mesh)
    er, phases = _phase_normalize(e, dt_)

    w, qc, m = tridiag_eigh_dist(jnp.real(d), er, mesh, laed4, col_align=nb)

    qc = qc.astype(dt_)
    if is_complex_dtype(dt_):
        ph = jnp.concatenate([phases, jnp.ones((m - pm,), dt_)])
        qc = ph[:, None] * qc
    qc = s23.bt_band_to_tridiag_dist(
        qc, vs.astype(dt_), taus2.astype(dt_), band, pm, mesh,
        group_size=tune.bt_band_to_tridiag_hh_apply_group_size)
    qc = s23.bt_reduction_to_band_dist(qc, packed, taus1, band)

    vdata = s23.cols_to_canonical(qc, dist=orig_dist,
                                  sharding=a.grid.canonical_sharding())
    return w[:n], DistMatrix(vdata, orig_dist, a.grid)


_GATHERED_WARNED = [False]
_IDLE_WARNED = [False]


def _eigh_dist_gathered(a: DistMatrix, laed4: int):
    """Fallback for the degenerate case of more devices than the padded
    problem size: distributed stage 1, host-gathered stages 2/3."""
    if not _GATHERED_WARNED[0]:
        _GATHERED_WARNED[0] = True
        import logging
        logging.getLogger("dlaf_jax").warning(
            "eigh_dist: %d devices exceed the padded problem size, which "
            "the device-resident D&C pipeline cannot shard; falling back "
            "to the host-gathered stages 2/3 — expect a large per-host "
            "memory/latency cliff", a.grid.mesh.devices.size)
    n = a.dist.size[0]
    nb = a.block_size
    pm = a.dist.padded_size[0]

    if pm > n:
        g = jnp.asarray(a.to_global())
        gersh = jnp.max(jnp.abs(g)) * (n + 1)
        gp = jnp.zeros((pm, pm), g.dtype)
        gp = gp.at[:n, :n].set(g)
        gp = gp.at[jnp.arange(n, pm), jnp.arange(n, pm)].set(
            gersh + 1.0 + jnp.arange(pm - n, dtype=jnp.abs(g).dtype))
        a = DistMatrix.from_global(gp, nb, a.grid)

    packed, taus1 = reduction_to_band_dist(a)

    packed_g = jnp.asarray(packed.to_global())
    band_dense = extract_band(packed_g, nb)
    d, e, vs, taus2 = band_to_tridiag(band_dense, nb)
    er, phases = _phase_normalize(e, packed_g.dtype)
    w, q = tridiag_eigh(jnp.real(d), er, laed4, mesh=a.grid.mesh)
    q = (phases[:, None] * q.astype(packed_g.dtype)).astype(packed_g.dtype)

    from jax.sharding import NamedSharding, PartitionSpec as P
    from ...comm.mesh import COL_AXIS, ROW_AXIS
    if q.shape[1] % a.grid.mesh.devices.size == 0:
        col_sharding = NamedSharding(a.grid.mesh, P(None, (ROW_AXIS, COL_AXIS)))
        q = jax.device_put(q, col_sharding)
    q = bt_band_to_tridiag(q, vs, taus2, nb)
    q = bt_reduction_to_band(q, packed_g, taus1, nb)

    v = DistMatrix.from_global(q[:n, :n], nb, a.grid)
    return w[:n], v


def eigvalsh_dist(a: DistMatrix, laed4_iter: int | None = None):
    """Distributed eigenvalues only: skips both back-transformations and the
    final reshard (reference ``hermitian_eigensolver`` with eigenvalues-only
    allocation, ``eigensolver/eigensolver.h:56``)."""
    n = a.dist.size[0]
    tune = get_tune_parameters()
    laed4 = laed4_iter or tune.laed4_max_iter
    D = a.grid.mesh.devices.size
    a_sq = _square_lattice(a)
    pm = a_sq.dist.padded_size[0]
    if not dc_dist_supported(pm, D):
        return _eigh_dist_gathered(a, laed4)[0]
    a = a_sq

    from . import dist_stage23 as s23
    from .driver import get_band_size

    nb = a.block_size
    mesh = a.grid.mesh
    band = get_band_size(nb)
    data = s23._pad_fix(a.data, nb=nb, n=n, pm=pm, mesh=mesh)
    a = DistMatrix(data, a.dist, a.grid)
    packed, _ = reduction_to_band_dist(a, band)
    strips = s23.strips_from_packed_dist(packed, band)
    d, e, _, _ = s23.band_to_tridiag_dist(strips, pm, band, mesh)
    er, _ = _phase_normalize(e, a.data.dtype)
    w, _, _ = tridiag_eigh_dist(jnp.real(d), er, mesh, laed4)
    return w[:n]


def eigh_gen_dist(a: DistMatrix, b: DistMatrix, laed4_iter: int | None = None,
                  b_factorized: bool = False):
    """Distributed generalized eigensolver:
    cholesky -> gen_to_std -> eigh -> TRSM back-substitution, each stage the
    distributed implementation (reference ``gen_eigensolver/impl.h:46-93``;
    ``b_factorized`` = the reference's ``already_factorized`` mode where ``b``
    already holds the Cholesky factor L). Device-resident end-to-end on
    supported grids.
    """
    from ..cholesky import cholesky
    from ..gen_to_std import generalized_to_standard_dist
    from ..triangular import triangular_solver

    l = b if b_factorized else cholesky(b)
    afull = a.symmetrize(lower=True)
    astd = generalized_to_standard_dist(afull, l)
    w, z = eigh_dist(astd, laed4_iter)
    x = triangular_solver(l, z, uplo="L", trans="C")
    return w, x
