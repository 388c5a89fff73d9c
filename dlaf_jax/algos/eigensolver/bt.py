"""Back-transformations: tridiagonal eigenvectors -> band -> full.

Equivalents of the reference's two back-transformations:

  - ``bt_band_to_tridiag`` (``eigensolver/bt_band_to_tridiag/impl.h``):
    applies the bulge-chasing reflectors recorded by
    :func:`band_to_tridiag` in reverse sweep order. All chases of one sweep
    act on disjoint row ranges, so each sweep is ONE batched rank-one update
    (the analog of the reference's ``hh_apply_group_size`` grouping).
  - ``bt_reduction_to_band`` (``eigensolver/bt_reduction_to_band/impl.h``):
    applies the stage-1 compact-WY panels in reverse panel order, each panel
    being two GEMMs (E -= V (T (V^H E))).

Convention (matches band2tridiag/red2band): the reductions computed
A_next = H A H^H per reflector in creation order, so the accumulated
transform is A = Q T Q^H with Q = H_1^H H_2^H ... H_N^H, and eigenvectors
map back as E <- H_k^H E applied in reverse creation order.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ...ops.core import ct, matmul_precision
from ...ops.householder import t_factor
from ...types import is_complex_dtype


@functools.partial(jax.jit, static_argnames=("b",))
def bt_band_to_tridiag_sweepwise(e_mat, vs, taus, b: int):
    """E <- Q_stage2 E, one batched rank-1 pass per sweep (reference
    ungrouped application; kept as the grouped kernel's test oracle —
    it streams the whole E once per sweep, O(n^3) HBM traffic).
    """
    if b == 1:
        return e_mat
    n, nev = e_mat.shape
    nsweeps, ncmax, _ = vs.shape
    dt = e_mat.dtype

    # pad rows so the batched per-sweep view [s+1, s+1+ncmax*b) is in-bounds
    pad_rows = ncmax * b + 1
    ep = jnp.concatenate([e_mat, jnp.zeros((pad_rows, nev), dt)], axis=0)

    def sweep_step(k, ep):
        s = nsweeps - 1 - k
        v = vs[s]                                  # (ncmax, b)
        tau = taus[s]                              # (ncmax,)
        blk = lax.dynamic_slice(ep, (s + 1, 0), (ncmax * b, nev))
        blk3 = blk.reshape(ncmax, b, nev)
        # w = v^H blk per chase; blk -= conj(tau) v w   (applying H^H)
        w = jnp.einsum("cb,cbe->ce", jnp.conj(v) if is_complex_dtype(dt) else v,
                       blk3, precision=matmul_precision())
        coef = (jnp.conj(tau) if is_complex_dtype(dt) else tau)[:, None, None]
        blk3 = blk3 - coef * v[:, :, None] * w[:, None, :]
        ep = lax.dynamic_update_slice(ep, blk3.reshape(ncmax * b, nev), (s + 1, 0))
        return ep

    ep = lax.fori_loop(0, nsweeps, sweep_step, ep)
    return ep[:n]


def wy_select_tensor(g: int, b: int, dtype):
    """Static selection tensor assembling the staggered WY trapezoid:
    V[r, j] = vs_rev[j, r - (g-1-j)] as einsum('rjt,jt->rj', SEL, vs_rev)
    (gather-free; SEL is a 0/1 tensor of shape (b+g-1, g, b))."""
    r = jnp.arange(b + g - 1)[:, None, None]
    j = jnp.arange(g)[None, :, None]
    t = jnp.arange(b)[None, None, :]
    from ...types import real_dtype
    return (r == (g - 1 - j) + t).astype(real_dtype(dtype))


def wy_group_vt(vs_g, taus_g, sel):
    """Compact-WY (V, T) of one group x chase block.

    vs_g/taus_g: the group's reflectors for one chase index, sweep-ascending
    ((g, b) / (g,)); the block operator is Q^H with Q = H_{s+g-1} ... H_s
    (highest sweep applied first), so V column j holds sweep s+g-1-j at row
    offset g-1-j — exactly the original application order for every
    overlapping pair.
    """
    vs_rev = vs_g[::-1]
    taus_rev = taus_g[::-1]
    # HIGHEST: the 0/1 selection contraction must be exact — as a default
    # (TF32 on the GPU) matmul it ROUNDS every reflector entry
    v = jnp.einsum("rjt,jt->rj", sel, vs_rev,
                   precision=jax.lax.Precision.HIGHEST).astype(vs_g.dtype)
    t = t_factor(v, taus_rev)
    return v, t


@functools.partial(jax.jit,
                   static_argnames=("b", "group_size", "prepadded"))
def bt_band_to_tridiag(e_mat, vs, taus, b: int, group_size: int = 64,
                       sweep_lo=0, prepadded: bool = False):
    """E <- Q_stage2 E with grouped compact-WY application.

    The reference groups reflector applications per eigenvector tile
    (``bt_band_to_tridiag/impl.h:177-535``, ``hh_apply_group_size``); here
    ``group_size`` consecutive sweeps' chase-c reflectors form one staggered
    WY block applied with two GEMMs, cutting HBM traffic from O(n^2) per
    sweep to O(n^2 (1/g + 1/b)) total and making every step GEMM-sized.
    Blocks run ascending in c, groups descending in sweeps; within a block
    the columns are sweep-descending — an exact linear extension of the
    original per-reflector order (only (higher sweep, lower c) pairs
    overlap (lower sweep, higher c) ones).

    With ``sweep_lo`` (traced) the record covers absolute sweeps
    [sweep_lo, sweep_lo + vs.shape[0]): callers holding a sweep-chunked
    record (the O(n^2) piece a memory-planned pipeline may not keep whole,
    see algos/eigensolver/large.py) apply the chunks in DESCENDING
    sweep_lo order, which — with chunk boundaries at multiples of
    ``group_size`` — reproduces the unchunked application order exactly.

    With ``prepadded`` the caller passes E already extended by the
    ``b + group_size - 1`` workspace rows (content irrelevant: out-of-range
    window slots carry zero reflectors, so the slice/update pair writes back
    what it read) and gets the padded buffer back. Chunked callers pad ONCE
    and thread the donated buffer through every chunk — the per-call
    concat would otherwise hold q twice at the peak.
    """
    if b == 1:
        return e_mat
    n, nev = e_mat.shape
    dt = e_mat.dtype
    nsweeps, ncmax, _ = vs.shape
    g = max(1, min(group_size, nsweeps))
    ngroups = -(-nsweeps // g)
    nspad = ngroups * g
    if nspad > nsweeps:   # padded sweeps have tau == 0: exact no-ops
        vs = jnp.concatenate(
            [vs, jnp.zeros((nspad - nsweeps, ncmax, b), dt)], axis=0)
        taus = jnp.concatenate(
            [taus, jnp.zeros((nspad - nsweeps, ncmax), dt)], axis=0)

    # workspace pad: every VALID chase has r0 = s + 1 + c*b <= n - 1
    # (c < ceil((n-1-s)/b)), touching rows < n - 1 + win; chases on padded /
    # out-of-chunk sweep slots carry v = 0, tau = 0, so their (clamped)
    # slice + update_slice pair writes back exactly what it read.
    win = b + g - 1
    if prepadded:
        ep, n = e_mat, n - win
    else:
        ep = jnp.concatenate([e_mat, jnp.zeros((win, nev), dt)], axis=0)
    sel = wy_select_tensor(g, b, dt)
    lo = jnp.asarray(sweep_lo, jnp.int32)

    def chase_step(c, carry):
        s0, ep = carry
        c = jnp.asarray(c, jnp.int32)
        tau_g = lax.dynamic_slice(taus, (s0, c), (g, 1))[:, 0]
        vs_g = lax.dynamic_slice(vs, (s0, c, jnp.int32(0)), (g, 1, b))[:, 0]
        v, t = wy_group_vt(vs_g, tau_g, sel)
        r0 = lo + s0 + 1 + c * b
        blk = lax.dynamic_slice(ep, (r0, jnp.int32(0)), (win, nev))
        # E <- Q^H E = E - V T^H (V^H E)
        w = jnp.matmul(ct(v), blk, precision=matmul_precision())
        blk = blk - jnp.matmul(v, jnp.matmul(ct(t), w,
                                             precision=matmul_precision()),
                               precision=matmul_precision())
        ep = lax.dynamic_update_slice(ep, blk, (r0, jnp.int32(0)))
        return s0, ep

    def group_step(k, ep):
        s0 = jnp.asarray((ngroups - 1 - k) * g, jnp.int32)
        _, ep = lax.fori_loop(0, ncmax, chase_step, (s0, ep))
        return ep

    ep = lax.fori_loop(0, ngroups, group_step, ep)
    return ep if prepadded else ep[:n]


@functools.partial(jax.jit, static_argnames=("band", "panel_group"))
def bt_reduction_to_band(e_mat, a_packed, taus, band: int,
                         panel_group: int = 4):
    """E <- Q_stage1 E using the panels stored in the packed stage-1 output.

    e_mat: (n, nev); a_packed/taus: outputs of :func:`reduction_to_band`.
    Stage 1 computed A_band = Q^H A Q with Q = prod_k (I - V_k T_k V_k^H)
    in panel order, so E <- Q E applies panels in reverse order:
    E -= V (T (V^H E)).

    ``panel_group`` consecutive panels are aggregated into ONE wide
    compact-WY block (the closed-form ``t_factor`` covers any ordered
    reflector sequence, so T is assembled directly from the (pg*b)-column
    V): E is streamed pg x fewer times (a per-panel version reads and
    writes E 3 times per b-wide panel) and the GEMM contraction widens
    from b to pg*b. Groups are start-aligned; the ragged tail group is
    applied separately with its TRUE static width (a full-width zero-pad
    would materialize a second (n, n + pg*b) copy of ``a_packed`` inside
    the donated stage-5 jit).
    """
    n, nev = e_mat.shape
    b = band
    npanels = max(n // b - 1, 0)
    if npanels == 0:
        return e_mat
    pg = max(1, min(panel_group, npanels))
    pgb = pg * b
    ngroups = -(-npanels // pg)
    rows = jnp.arange(n)

    def apply_group(e, j0, wcols: int):
        panel = lax.dynamic_slice(a_packed, (0, j0), (n, wcols))
        head = j0 + b + jnp.arange(wcols)  # head row of each column
        v = jnp.where(rows[:, None] > head[None, :], panel, 0)
        v = v + jnp.where(rows[:, None] == head[None, :], 1.0,
                          0).astype(e.dtype)
        tpg = lax.dynamic_slice(taus, (j0,), (wcols,))
        t = t_factor(v, tpg)
        w = jnp.matmul(ct(v), e, precision=matmul_precision())
        return e - jnp.matmul(v, jnp.matmul(t, w,
                                            precision=matmul_precision()),
                              precision=matmul_precision())

    # groups applied in reverse panel order: the (possibly ragged) tail
    # group first, then the uniform full-width groups in a fori_loop
    wt = npanels - (ngroups - 1) * pg
    e = apply_group(e_mat, (ngroups - 1) * pgb, wt * b)
    if ngroups > 1:
        e = lax.fori_loop(
            0, ngroups - 1,
            lambda k, e: apply_group(e, (ngroups - 2 - k) * pgb, pgb), e)
    return e
