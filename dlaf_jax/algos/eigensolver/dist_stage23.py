"""Device-resident distributed stages 2/3 and back-transformations.

Together with :mod:`dist_red2band` and :mod:`tridiag_dc_dist` these make
``eigh_dist`` run end-to-end on the devices — zero host transfers between
``from_global`` and the result (the reference keeps every stage distributed:
``band_to_tridiag/mc.h:990``, ``bt_band_to_tridiag/impl.h:177-535``,
``bt_reduction_to_band/impl.h:239``).

Data layouts between stages (all jax.Arrays, never gathered to host):
  - packed stage-1 output: canonical block-cyclic DistMatrix;
  - band: replicated strip storage, O(n*b) (the reference's 1-D band
    re-distribution analog, ``get_1d_block_size.h:19-21``);
  - stage-2 reflector record vs/taus: sweep-sharded over the flat device
    axis, O(n^2/D) per device;
  - eigenvector matrix: column-sharded (every reflector application is
    row-local, so both back-transformations run without communicating
    eigenvector data; only O(n*b)-sized reflector groups are broadcast).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ...comm.mesh import COL_AXIS, ROW_AXIS
from ...matrix.dist_matrix import DistMatrix
from ...ops.core import ct, matmul_precision
from ...ops.householder import t_factor
from .band_strips import STRIP_W, n_strips
from ...comm.panel import gather_col_panel

AXES = (ROW_AXIS, COL_AXIS)


# ---------------------------------------------------------------------------
# padding fix-up (device-side; no host gather)


def _pad_fix_shardfn(a4, *, nb, n, pm):
    a = a4[0, 0]
    p = lax.axis_index(ROW_AXIS)
    q = lax.axis_index(COL_AXIS)
    Pn = lax.axis_size(ROW_AXIS)
    Qn = lax.axis_size(COL_AXIS)
    lm, ln = a.shape
    grow = (jnp.arange(lm // nb) * Pn + p).repeat(nb) * nb + \
        jnp.tile(jnp.arange(nb), lm // nb)
    gcol = (jnp.arange(ln // nb) * Qn + q).repeat(nb) * nb + \
        jnp.tile(jnp.arange(nb), ln // nb)
    valid = (grow[:, None] < n) & (gcol[None, :] < n)
    gersh = lax.pmax(lax.pmax(
        jnp.max(jnp.where(valid, jnp.abs(a), 0)), ROW_AXIS), COL_AXIS)
    gersh = gersh * (n + 1)
    paddiag = (grow[:, None] == gcol[None, :]) & (grow[:, None] >= n)
    padvals = (gersh + 1.0 + (grow[:, None] - n)).astype(a.dtype)
    a = jnp.where(valid, a, 0)
    a = jnp.where(paddiag, padvals, a)
    return a[None, None]


@functools.partial(jax.jit, static_argnames=("nb", "n", "pm", "mesh"))
def _pad_fix(data, *, nb, n, pm, mesh):
    """Zero the padding region and put large, separated entries on the
    padding diagonal so padded eigenvalues decouple and sort last."""
    spec = P(ROW_AXIS, COL_AXIS, None, None)
    fn = jax.shard_map(functools.partial(_pad_fix_shardfn, nb=nb, n=n, pm=pm),
                       mesh=mesh, in_specs=(spec,), out_specs=spec)
    return fn(data)


# ---------------------------------------------------------------------------
# band extraction: packed DistMatrix -> replicated strip storage


def _strips_shardfn(a4, *, nb, band, nrt, ns_nb, ns):
    a = a4[0, 0]
    p = lax.axis_index(ROW_AXIS)
    q = lax.axis_index(COL_AXIS)
    Pn = lax.axis_size(ROW_AXIS)
    Qn = lax.axis_size(COL_AXIS)
    b = nb
    dt_ = a.dtype
    rl = jnp.arange(b)[:, None]
    cl = jnp.arange(b)[None, :]
    # band-only masks (band <= nb): reflectors live strictly below the band
    # inside the lower triangle and must not leak into stage 2
    diag_m = (rl >= cl) & (rl - cl <= band)
    sub_m = (cl >= rl) & (b + rl - cl <= band)

    def body(s, out):
        s = jnp.asarray(s, jnp.int32)   # fori index is int64 under x64
        # band row-block s: tril of tile (s, s) + triu of tile (s, s-1)
        diag = lax.dynamic_slice(a, ((s // Pn) * b, (s // Qn) * b), (b, b))
        diag = jnp.where((p == s % Pn) & (q == s % Qn) & diag_m, diag, 0)
        sm1 = jnp.maximum(s - 1, 0)
        sub = lax.dynamic_slice(a, ((s // Pn) * b, (sm1 // Qn) * b), (b, b))
        sub = jnp.where((p == s % Pn) & (q == sm1 % Qn) & (s > 0) & sub_m,
                        sub, 0)
        blk = jnp.concatenate(
            [jnp.zeros((b, 2 * b), dt_), sub, diag, jnp.zeros((b, b), dt_)],
            axis=1)
        return lax.dynamic_update_slice(out, blk[None], (s, jnp.int32(0),
                                                         jnp.int32(0)))

    out0 = jnp.zeros((ns_nb, b, STRIP_W * b), dt_)
    out = lax.fori_loop(0, nrt, body, out0)
    out = lax.psum(lax.psum(out, ROW_AXIS), COL_AXIS)
    if band != nb:
        from .band_strips import restripe
        out = restripe(out, nb, band, ns)
    return out


@functools.partial(jax.jit, static_argnames=("nb", "band", "nrt", "ns_nb",
                                             "ns", "mesh"))
def _strips_dist(data, *, nb, band, nrt, ns_nb, ns, mesh):
    spec = P(ROW_AXIS, COL_AXIS, None, None)
    fn = jax.shard_map(functools.partial(_strips_shardfn, nb=nb, band=band,
                                         nrt=nrt, ns_nb=ns_nb, ns=ns),
                       mesh=mesh, in_specs=(spec,), out_specs=P(),
                       check_vma=False)
    return fn(data)


def strips_from_packed_dist(packed: DistMatrix, band: int | None = None):
    """Replicated strip storage of the band held in a packed stage-1
    DistMatrix (band | block size). O(n*band) data, one psum (+ a replicated
    re-striping pass when band < nb — the reference's 1-D re-distribution,
    ``get_1d_block_size.h:19-21``)."""
    nb = packed.block_size
    band = band or nb
    pm = packed.dist.padded_size[0]
    nrt = pm // nb
    ns_nb = n_strips(pm, nb) + 3  # incl. 3 zero slack strips
    ns = n_strips(pm, band) + 3
    return _strips_dist(packed.data, nb=nb, band=band, nrt=nrt, ns_nb=ns_nb,
                        ns=ns, mesh=packed.grid.mesh)


# ---------------------------------------------------------------------------
# stage 2: replicated chasing, sweep-sharded reflector record


def _stage2_shardfn(strips, *, n_eff, b, chunk):
    from .band_strips import band_to_tridiag_strips
    p = lax.axis_index(ROW_AXIS)
    q = lax.axis_index(COL_AXIS)
    Qn = lax.axis_size(COL_AXIS)
    did = p * Qn + q
    return band_to_tridiag_strips(strips, n_eff, b, sweep_lo=did * chunk,
                                  sweep_chunk=chunk)


@functools.partial(jax.jit, static_argnames=("n_eff", "b", "chunk", "mesh"))
def _stage2_dist(strips, *, n_eff, b, chunk, mesh):
    fn = jax.shard_map(
        functools.partial(_stage2_shardfn, n_eff=n_eff, b=b, chunk=chunk),
        mesh=mesh, in_specs=(P(),),
        out_specs=(P(), P(), P(AXES, None, None), P(AXES, None)),
        check_vma=False)
    return fn(strips)


def band_to_tridiag_dist(strips, n_eff: int, b: int, mesh):
    """Stage 2 on replicated strips; every device chases the (cheap, O(n*b))
    band identically — like the reference, which runs stage 2 on a 1-D
    re-distribution because it does not scale in 2-D — but records only its
    own sweep chunk of the O(n^2) reflector set.

    Returns (d, e, vs, taus) with vs/taus sweep-sharded jax.Arrays of global
    leading dim D*ceil(nsweeps/D) (padded sweeps have tau == 0: no-ops).
    """
    from ...tune import get_tune_parameters

    if get_tune_parameters().band_to_tridiag_dist_mode == "pipelined":
        return band_to_tridiag_dist_pipelined(strips, n_eff, b, mesh)
    D = mesh.devices.size
    nsweeps = max(n_eff - 2, 1)
    chunk = -(-nsweeps // D)
    return _stage2_dist(strips, n_eff=n_eff, b=b, chunk=chunk, mesh=mesh)


# ---------------------------------------------------------------------------
# stage 2 (pipelined): compute-distributed chase over band-column segments
#
# The replicated path above chases the whole band on every device; this one
# pipelines the sweeps across devices (reference SweepWorkerDist handoff,
# ``band_to_tridiag/mc.h:568-661``): device d owns a contiguous segment of
# strips, each wavefront step t executes the t = 3s + c chases that fall in
# the local segment (band_strips.chase_wavefront_step), and segment-boundary
# state moves between neighbour devices as a 2-strip halo pull + additive write-back delta —
# per-device chase work shrinks ~D/2x while the result stays bit-identical
# to the sequential schedule.


def _shift_from_next(x, P_, Q_):
    """x_new[did] = x[did + 1] in flat row-major device order (zeros at the
    last device) — composed from per-axis ppermutes."""
    if P_ * Q_ == 1:
        return jnp.zeros_like(x)
    a = lax.ppermute(x, COL_AXIS, [(s, s - 1) for s in range(1, Q_)])
    if P_ > 1:
        w = lax.ppermute(x, COL_AXIS, [(0, Q_ - 1)])
        w = lax.ppermute(w, ROW_AXIS, [(s, s - 1) for s in range(1, P_)])
        a = a + w
    return a


def _shift_to_next(x, P_, Q_):
    """x_new[did] = x[did - 1] (zeros at device 0)."""
    if P_ * Q_ == 1:
        return jnp.zeros_like(x)
    a = lax.ppermute(x, COL_AXIS, [(s, s + 1) for s in range(Q_ - 1)])
    if P_ > 1:
        w = lax.ppermute(x, COL_AXIS, [(Q_ - 1, 0)])
        w = lax.ppermute(w, ROW_AXIS, [(s, s + 1) for s in range(P_ - 1)])
        a = a + w
    return a


def _stage2_pipe_shardfn(strips, *, n_eff, b, S, K, T, nrec, P_, Q_):
    from .band_strips import COL_BASE, STRIP_W, chase_wavefront_step

    p = lax.axis_index(ROW_AXIS).astype(jnp.int32)
    q = lax.axis_index(COL_AXIS).astype(jnp.int32)
    did = p * Q_ + q
    seg0 = did * S
    dt_ = strips.dtype
    loc = lax.dynamic_slice(strips, (seg0, jnp.int32(0), jnp.int32(0)),
                            (S, b, STRIP_W * b))
    vs = jnp.zeros((nrec + 1, S + 1, b), dt_)
    taus = jnp.zeros((nrec + 1, S + 1), dt_)

    def step(t, carry):
        loc, vs, taus = carry
        pre = loc[:2]
        halo = _shift_from_next(pre, P_, Q_)
        ext = jnp.concatenate([loc, halo], axis=0)
        ext, vs, taus = chase_wavefront_step(
            ext, vs, taus, t, n=n_eff, b=b, S=S, seg0=seg0, K=K)
        # merge-back is an exact OVERWRITE, not an additive delta: with
        # x + (y - x) != y in floating point, a delta merge injects eps
        # noise at every handoff which amplifies through the reflector
        # chain. Cells the left neighbor modified are exactly those whose
        # returned value differs bitwise from what we sent it (concurrent
        # windows are element-disjoint, so never both sides).
        back = _shift_to_next(ext[S:], P_, Q_)
        own = ext[:S]
        changed = (back != pre) & (did > 0)
        loc = own.at[:2].set(jnp.where(changed, back, own[:2]))
        return loc, vs, taus

    loc, vs, taus = lax.fori_loop(0, T, step, (loc, vs, taus))

    i = jnp.arange(b)
    dloc = loc[:, i, i + COL_BASE * b].reshape(S * b)
    eloc = loc[:, i, i + COL_BASE * b - 1].reshape(S * b)
    D = P_ * Q_
    z = jnp.zeros((D * S * b,), dt_)
    dfull = lax.psum(lax.psum(
        lax.dynamic_update_slice(z, dloc, (seg0 * b,)), ROW_AXIS), COL_AXIS)
    efull = lax.psum(lax.psum(
        lax.dynamic_update_slice(z, eloc, (seg0 * b,)), ROW_AXIS), COL_AXIS)
    return jnp.real(dfull[:n_eff]), efull[1:n_eff], vs, taus


def _record_reshard_shardfn(vs, taus, *, nsweeps, chunk, S, b, P_, Q_, ncmax):
    """Segment-local reflector record (all sweeps, local chase window) ->
    sweep-sharded record (my chunk of sweeps, all chases): one all_to_all
    over sweep chunks, then static placement of each segment's window at its
    per-sweep chase offset c_lo(s) = max(0, seg*S - (s+1)//b)."""
    D = P_ * Q_
    p = lax.axis_index(ROW_AXIS).astype(jnp.int32)
    q = lax.axis_index(COL_AXIS).astype(jnp.int32)
    did = p * Q_ + q
    CSEG = S + 1
    ncmax_pad = (D - 1) * S + CSEG
    dt_ = vs.dtype
    x = vs[:D * chunk].reshape(D, chunk, CSEG, b)
    xt = taus[:D * chunk].reshape(D, chunk, CSEG)
    got = lax.all_to_all(x, AXES, split_axis=0, concat_axis=0, tiled=True)
    gott = lax.all_to_all(xt, AXES, split_axis=0, concat_axis=0, tiled=True)

    out_v = jnp.zeros((chunk, ncmax_pad, b), dt_)
    out_t = jnp.zeros((chunk, ncmax_pad), dt_)
    s0g = did * chunk
    L = min(b, chunk)
    nf = chunk // b + 2
    for dpp in range(D):
        segv, segt = got[dpp], gott[dpp]

        def body(g, carry, segv=segv, segt=segt, dpp=dpp):
            ov, ot = carry
            f = (s0g + 1) // b + jnp.asarray(g, jnp.int32)
            start = f * b - 1 - s0g
            sl0 = jnp.clip(start, 0, chunk - L)
            rows = lax.dynamic_slice(segv, (sl0, jnp.int32(0), jnp.int32(0)),
                                     (L, CSEG, b))
            rowst = lax.dynamic_slice(segt, (sl0, jnp.int32(0)), (L, CSEG))
            sg = s0g + sl0 + jnp.arange(L, dtype=jnp.int32)
            m = ((sg + 1) // b == f) & (sg < nsweeps)
            c_off = jnp.clip(dpp * S - f, 0, ncmax_pad - CSEG)
            curv = lax.dynamic_slice(ov, (sl0, c_off, jnp.int32(0)),
                                     (L, CSEG, b))
            curt = lax.dynamic_slice(ot, (sl0, c_off), (L, CSEG))
            curv = curv + jnp.where(m[:, None, None], rows, 0)
            curt = curt + jnp.where(m[:, None], rowst, 0)
            ov = lax.dynamic_update_slice(ov, curv, (sl0, c_off, jnp.int32(0)))
            ot = lax.dynamic_update_slice(ot, curt, (sl0, c_off))
            return ov, ot

        out_v, out_t = lax.fori_loop(0, nf, body, (out_v, out_t))
    return out_v[:, :ncmax], out_t[:, :ncmax]


@functools.partial(jax.jit, static_argnames=("n_eff", "b", "S", "K", "T",
                                             "nrec", "chunk", "ncmax", "mesh"))
def _stage2_pipelined(strips, *, n_eff, b, S, K, T, nrec, chunk, ncmax, mesh):
    P_, Q_ = mesh.devices.shape
    nsweeps = max(n_eff - 2, 1)
    fn = jax.shard_map(
        functools.partial(_stage2_pipe_shardfn, n_eff=n_eff, b=b, S=S, K=K,
                          T=T, nrec=nrec, P_=P_, Q_=Q_),
        mesh=mesh, in_specs=(P(),),
        out_specs=(P(), P(), P(AXES, None, None), P(AXES, None)),
        check_vma=False)
    d, e, vs, taus = fn(strips)
    rs = jax.shard_map(
        functools.partial(_record_reshard_shardfn, nsweeps=nsweeps,
                          chunk=chunk, S=S, b=b, P_=P_, Q_=Q_, ncmax=ncmax),
        mesh=mesh, in_specs=(P(AXES, None, None), P(AXES, None)),
        out_specs=(P(AXES, None, None), P(AXES, None)),
        check_vma=False)
    vs, taus = rs(vs, taus)
    return d, e, vs, taus


def band_to_tridiag_dist_pipelined(strips, n_eff: int, b: int, mesh):
    """Compute-distributed stage 2 (see module comment above).  Same output
    contract as :func:`band_to_tridiag_dist` (sweep-sharded vs/taus of global
    leading dim D*ceil(nsweeps/D))."""
    from .band_strips import wavefront_k, wavefront_nsteps

    D = mesh.devices.size
    ns = strips.shape[0]
    S = -(-ns // D)
    strips = jnp.pad(strips, ((0, D * S - ns), (0, 0), (0, 0)))
    nsweeps = max(n_eff - 2, 1)
    chunk = -(-nsweeps // D)
    ncmax = -(-(n_eff - 1) // b)
    return _stage2_pipelined(
        strips, n_eff=n_eff, b=b, S=S, K=wavefront_k(S, b),
        T=wavefront_nsteps(n_eff, b), nrec=D * chunk, chunk=chunk,
        ncmax=ncmax, mesh=mesh)


# ---------------------------------------------------------------------------
# back-transformation: bulge-chase reflectors on column-sharded eigenvectors


def _bt_b2t_shardfn(qc, vs_loc, taus_loc, *, b, chunk, gsz, n_eff):
    from .bt import wy_group_vt, wy_select_tensor
    dt_ = qc.dtype
    D = lax.axis_size(ROW_AXIS) * lax.axis_size(COL_AXIS)
    did = lax.axis_index(ROW_AXIS) * lax.axis_size(COL_AXIS) + \
        lax.axis_index(COL_AXIS)
    ncmax = vs_loc.shape[1]
    m, ncols = qc.shape
    pad_rows = max(chunk * D + ncmax * b + gsz - m, 0)
    ep = jnp.concatenate([qc, jnp.zeros((pad_rows, ncols), dt_)], axis=0)
    ngroups = (chunk * D) // gsz
    sel = wy_select_tensor(gsz, b, dt_)
    win = b + gsz - 1

    def group_step(k, ep):
        g = ngroups - 1 - jnp.asarray(k, jnp.int32)
        s0 = g * gsz
        # Broadcast the group's reflectors (one psum of O(gsz * n) data).
        # A group may SPAN sweep-chunk owners (gsz > chunk): every device
        # gathers the sweeps it owns into the group buffer, masks the
        # rest, and the psum assembles the full group — so the group size
        # (the reference's hh_apply_group_size knob, tune.h:130) is not
        # capped by nsweeps/D, keeping the sequential round count and the
        # collective count independent of the device count.
        idx = s0 + jnp.arange(gsz, dtype=jnp.int32)      # global sweep ids
        loc = jnp.clip(idx - did * chunk, 0, chunk - 1)
        own = (idx >= did * chunk) & (idx < (did + 1) * chunk)
        vs_g = jnp.where(own[:, None, None], vs_loc[loc], 0)
        taus_g = jnp.where(own[:, None], taus_loc[loc], 0)
        vs_g = lax.psum(lax.psum(vs_g, ROW_AXIS), COL_AXIS)
        taus_g = lax.psum(lax.psum(taus_g, ROW_AXIS), COL_AXIS)

        # grouped compact-WY application, local to the column shard
        # (see bt.bt_band_to_tridiag for the ordering argument)
        def chase_step(c, ep):
            c = jnp.asarray(c, jnp.int32)
            v, t = wy_group_vt(
                lax.dynamic_slice(vs_g, (jnp.int32(0), c, jnp.int32(0)),
                                  (gsz, 1, b))[:, 0],
                lax.dynamic_slice(taus_g, (jnp.int32(0), c), (gsz, 1))[:, 0],
                sel)
            r0 = s0 + 1 + c * b
            blk = lax.dynamic_slice(ep, (r0, jnp.int32(0)), (win, ncols))
            w = jnp.matmul(ct(v), blk, precision=matmul_precision())
            blk = blk - jnp.matmul(
                v, jnp.matmul(ct(t), w, precision=matmul_precision()),
                precision=matmul_precision())
            return lax.dynamic_update_slice(ep, blk, (r0, jnp.int32(0)))

        return lax.fori_loop(0, ncmax, chase_step, ep)

    ep = lax.fori_loop(0, ngroups, group_step, ep)
    return ep[:m]


@functools.partial(jax.jit, static_argnames=("b", "chunk", "gsz", "n_eff",
                                             "mesh"))
def _bt_b2t_dist(qc, vs, taus, *, b, chunk, gsz, n_eff, mesh):
    fn = jax.shard_map(
        functools.partial(_bt_b2t_shardfn, b=b, chunk=chunk, gsz=gsz,
                          n_eff=n_eff),
        mesh=mesh,
        in_specs=(P(None, AXES), P(AXES, None, None), P(AXES, None)),
        out_specs=P(None, AXES), check_vma=False)
    return fn(qc, vs, taus)


def bt_band_to_tridiag_dist(qc, vs, taus, b: int, n_eff: int, mesh,
                            group_size: int = 64):
    """E <- Q_stage2 E on a column-sharded E with sweep-sharded reflectors.

    Reflector groups of ``group_size`` sweeps are broadcast (one psum each,
    O(group * n) data) and applied locally — eigenvector data never moves.
    """
    D = mesh.devices.size
    nsweeps_pad = vs.shape[0]
    chunk = nsweeps_pad // D
    # gsz must divide the padded sweep count but — unlike before — NOT the
    # per-device chunk: groups spanning owners are assembled by the psum.
    gsz = min(group_size, nsweeps_pad)
    while nsweeps_pad % gsz:
        gsz -= 1
    return _bt_b2t_dist(qc, vs, taus, b=b, chunk=chunk, gsz=gsz, n_eff=n_eff,
                        mesh=mesh)


# ---------------------------------------------------------------------------
# back-transformation: stage-1 panels on column-sharded eigenvectors


def _bt_r2b_shardfn(qc, a4, taus, *, nb, band, npanels, pm):
    a = a4[0, 0]
    dt_ = qc.dtype
    lmt = a.shape[0] // nb
    m, ncols = qc.shape
    rows = jnp.arange(pm)

    def panel_step(k, e):
        kk = npanels - 1 - jnp.asarray(k, jnp.int32)
        j0 = kk * band
        r0 = j0 + band
        panel = gather_col_panel(a, j0, band, nb, lmt).astype(dt_)  # (pm, band)
        head = r0 + jnp.arange(band)
        v = jnp.where(rows[:, None] > head[None, :], panel, 0)
        v = v + jnp.where(rows[:, None] == head[None, :], 1.0, 0).astype(dt_)
        tp = lax.dynamic_slice(taus, (j0,), (band,)).astype(dt_)
        t = t_factor(v, tp)
        etop = e[:pm]
        w = jnp.matmul(ct(v), etop, precision=matmul_precision())
        etop = etop - jnp.matmul(
            v, jnp.matmul(t, w, precision=matmul_precision()),
            precision=matmul_precision())
        return e.at[:pm].set(etop)

    return lax.fori_loop(0, npanels, panel_step, qc)


@functools.partial(jax.jit, static_argnames=("nb", "band", "npanels", "pm",
                                             "mesh"))
def _bt_r2b_dist(qc, data, taus, *, nb, band, npanels, pm, mesh):
    fn = jax.shard_map(
        functools.partial(_bt_r2b_shardfn, nb=nb, band=band, npanels=npanels,
                          pm=pm),
        mesh=mesh,
        in_specs=(P(None, AXES), P(ROW_AXIS, COL_AXIS, None, None), P()),
        out_specs=P(None, AXES), check_vma=False)
    return fn(qc, data, taus)


def bt_reduction_to_band_dist(qc, packed: DistMatrix, taus,
                              band: int | None = None):
    """E <- Q_stage1 E on a column-sharded E; panels are gathered from the
    packed DistMatrix with the same collectives stage 1 used (reference
    ``bt_reduction_to_band/impl.h:239``)."""
    nb = packed.block_size
    band = band or nb
    pm = packed.dist.padded_size[0]
    npanels = max(pm // band - 1, 0)
    return _bt_r2b_dist(qc, packed.data, taus, nb=nb, band=band,
                        npanels=npanels, pm=pm, mesh=packed.grid.mesh)


# ---------------------------------------------------------------------------
# final layout change: column shards -> canonical block-cyclic


def _c2c_shardfn(qc_loc, *, nb, pm, lmt, lnt):
    """Column shard (m, w) of the eigenvector matrix -> my canonical
    (1, 1, lm, ln) block-cyclic shard, via ONE uniform tile-granular
    all-to-all (the reference's hand-rolled all-to-all analog,
    ``permutations/general/impl.h:230-303``)."""
    p = lax.axis_index(ROW_AXIS)
    q = lax.axis_index(COL_AXIS)
    Pn = lax.axis_size(ROW_AXIS)
    Qn = lax.axis_size(COL_AXIS)
    D = Pn * Qn
    did = p * Qn + q
    m, w = qc_loc.shape
    wt = w // nb                     # my whole column tiles
    wq = -(-wt // Qn)                # padded tiles per target grid column
    lm = lmt * nb

    # rows < pm grouped by target grid row (global row tile t = l*P + p_t)
    rows = qc_loc[:pm].reshape(lmt, Pn, nb, w).transpose(1, 0, 2, 3) \
        .reshape(Pn, lm, w)
    # my col tile j (global T = did*wt + j) goes to grid col T % Q; for
    # target q_t the padded slots i take j = ((q_t - did*wt) mod Q) + i*Q
    q_t = jnp.arange(Qn, dtype=jnp.int32)[:, None]
    i = jnp.arange(wq, dtype=jnp.int32)[None, :]
    jsel = (q_t - did * wt) % Qn + i * Qn                # (Q, wq)
    valid = (jsel < wt).astype(qc_loc.dtype)
    rbuf4 = rows.reshape(Pn, lm, wt, nb)
    sb = jnp.take(rbuf4, jnp.minimum(jsel.reshape(-1), wt - 1), axis=2)
    sb = sb.reshape(Pn, lm, Qn, wq, nb) * valid.reshape(1, 1, Qn, wq, 1)
    sb = sb.transpose(0, 2, 1, 3, 4).reshape(D, lm, wq * nb)

    rcv = lax.all_to_all(sb, AXES, split_axis=0, concat_axis=0, tiled=True)

    # reassemble my lnt col tiles: global tile G = c*Q + q came from source
    # d_s = G // wt at its padded slot (j - j0) / Q
    G = jnp.arange(lnt, dtype=jnp.int32) * Qn + q
    d_s = G // wt
    j = G - d_s * wt
    j0 = (q - d_s * wt) % Qn
    slot = d_s * wq + (j - j0) // Qn                     # (lnt,)
    tiles = rcv.reshape(D, lm, wq, nb).transpose(0, 2, 1, 3) \
        .reshape(D * wq, lm, nb)
    out = jnp.take(tiles, slot, axis=0).transpose(1, 0, 2).reshape(lm, lnt * nb)
    return out[None, None]


@functools.partial(jax.jit, static_argnames=("nb", "pm", "lmt", "lnt", "mesh"))
def _c2c_dist(qc, *, nb, pm, lmt, lnt, mesh):
    fn = jax.shard_map(
        functools.partial(_c2c_shardfn, nb=nb, pm=pm, lmt=lmt, lnt=lnt),
        mesh=mesh, in_specs=(P(None, AXES),),
        out_specs=P(ROW_AXIS, COL_AXIS, None, None), check_vma=False)
    return fn(qc)


def cols_to_canonical(qc, *, dist, sharding):
    """(m, m) column-sharded eigenvector matrix -> canonical DistMatrix
    layout. Tile-aligned shards use one explicit uniform all-to-all inside
    shard_map; otherwise fall back to a GSPMD resharding constraint."""
    mesh = sharding.mesh
    D = mesh.devices.size
    m = qc.shape[1]
    nb = dist.block_size[0]
    if m % D == 0 and (m // D) % nb == 0:
        pm, pn = dist.padded_size
        lmt, lnt = dist.max_local_nr_tiles
        return _c2c_dist(qc, nb=nb, pm=pm, lmt=lmt, lnt=lnt, mesh=mesh)
    return _c2c_gspmd(qc, dist=dist, sharding=sharding)


@functools.partial(jax.jit, static_argnames=("dist", "sharding"))
def _c2c_gspmd(qc, *, dist, sharding):
    from ...dist import scatter_to_shards
    pm, pn = dist.padded_size
    q = qc[:pm, :pn]
    return jax.lax.with_sharding_constraint(scatter_to_shards(q, dist),
                                            sharding)
