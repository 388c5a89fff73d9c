"""Distributed tridiagonal divide & conquer.

Re-design of the reference's distributed D&C merge
(``eigensolver/tridiag_solver/merge.h:1810-1941`` ``mergeDistSubproblems``):
the eigenvector matrix — the O(n^2) object that dominates stage-3 memory and
flops — is explicitly partitioned over the (flattened) device mesh at every
level, inside one ``shard_map`` program:

 - deep levels (``nbatch >= D``): merges are *device-local* — batches are
   block-distributed so sibling subproblems always live on the same device;
 - top levels (``nbatch < D``): each merge's eigenvector block is
   *row-sharded* over its device group. The block-diagonal embedding
   [[Q1, 0], [0, Q2]] is a local no-op under this layout (device g of the
   merged group already holds exactly rows [g*rows_loc, (g+1)*rows_loc)),
   so eigenvector data NEVER moves between devices — only O(n) vectors are
   psum-replicated (z assembly, secular roots, zhat), the analog of the
   reference's z broadcast over the full communicator (merge.h:1240-1245);
 - the secular (laed4) solves are root-sharded over the merge's device group
   (reference: multi-threaded + distributed solveRank1ProblemDist);
 - the deflation Givens rotations, the sorted-d permutation and the final
   eigenvalue sort are all folded into the *chunked* construction of the
   rank-1 eigenvector factor, so the big GEMM runs column-permutation-free
   and no O(n^2) gather is ever issued;
 - the final layout change (row shards -> column shards for the
   back-transformations) is ONE ``lax.all_to_all`` over the flat axis
   (reference: permutations/general/impl.h:230-303 hand-rolled all-to-all).

Per-device peak memory is O(n^2 / D + n). Non-power-of-2 device counts run
the merge tree on the largest power-of-2 device subset D2 <= D (inactive
devices contribute masked zeros to every collective — the reference instead
supports ragged grids directly in ``mergeDistSubproblems``,
``merge.h:1810-1941``, exercised by its 6-rank fixture
``grids_6_ranks.h:25-70``); the final padded all-to-all then hands column
shards back to ALL D devices, so the back-transformations regain full D-way
parallelism. Only D > padded-size configurations are unsupported
(:func:`dc_dist_supported`).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ...comm.mesh import COL_AXIS, ROW_AXIS
from ...ops.core import matmul_precision
from .tridiag_dc import (LEAF, _jacobi_eigh, _merge, _merge_vectors,
                         argsort)

AXES = (ROW_AXIS, COL_AXIS)


def pow2_floor(ndev: int) -> int:
    """Largest power of two <= ndev (the active merge-tree subset size)."""
    return 1 << (max(ndev, 1).bit_length() - 1)


def merge_tree_idle_fraction(ndev: int) -> float:
    """Fraction of devices idle during the stage-3 merge tree.

    The merge tree runs on the largest power-of-2 subset D2 <= D (the
    reference instead supports ragged grids directly,
    ``eigensolver/tridiag_solver/merge.h:1810-1941``, exercised by its
    6-rank fixture ``test/include/dlaf_test/comm_grids/grids_6_ranks.h``);
    on 6 devices 2 sit idle through stage 3 (1/3), on power-of-2 counts
    none do. Stages 1/2/4/5 and the final all-to-all always use all D, so
    the END-TO-END idle share is this times stage 3's wall share
    (~25-30% of a distributed EVP — a <=11% device-seconds cap at D=6,
    surfaced by the one-time note in ``dist_driver.eigh_dist``)."""
    return (ndev - pow2_floor(ndev)) / ndev


def dc_dist_supported(n: int, ndev: int) -> bool:
    m = LEAF
    while m < n:
        m *= 2
    d2 = pow2_floor(ndev)
    return m % d2 == 0 and m // d2 >= 1


# ---------------------------------------------------------------------------
# deflation (replicated, per merge) — the scan part of tridiag_dc._merge


def _deflate(d, z, rho, tol_scale):
    """Sorted-d deflation analysis; all outputs replicated.

    Returns (ds, zmask, zs2, perm, deflated, rots, tol).
    """
    n = d.shape[0]
    dt = d.dtype
    eps = jnp.finfo(dt).eps
    perm = argsort(d)
    ds = d[perm]
    zs = z[perm]
    dspread = jnp.maximum(ds[-1] - ds[0], eps)
    tol = 8.0 * eps * jnp.maximum(tol_scale, dspread)
    zsmall = jnp.abs(rho * zs) <= tol

    def scan_fn(carry, i):
        zvec, prev = carry
        zi = zvec[i]
        zp = zvec[jnp.maximum(prev, 0)]
        close = (ds[i] - ds[jnp.maximum(prev, 0)]) <= tol
        can = (~zsmall[i]) & (prev >= 0) & close
        r = jnp.sqrt(zi * zi + zp * zp)
        rsafe = jnp.where(r > 0, r, 1.0)
        c = jnp.where(can, zp / rsafe, 1.0)
        s = jnp.where(can, zi / rsafe, 0.0)
        zvec = zvec.at[jnp.maximum(prev, 0)].set(jnp.where(can, r, zp))
        zvec = zvec.at[i].set(jnp.where(can, 0.0, zi))
        survives = (~zsmall[i]) & (~can)
        newprev = jnp.where(survives, i, prev)
        return (zvec, newprev), (c, s, jnp.where(can, prev, -1), i)

    (zs2, _), rots = lax.scan(scan_fn, (zs, jnp.int32(-1)),
                              jnp.arange(n, dtype=jnp.int32))
    deflated = (jnp.abs(rho * zs2) <= tol) | (zs2 == 0)
    zmask = jnp.where(deflated, 0.0, zs2)
    return ds, zmask, zs2, perm, deflated, rots, tol


# ---------------------------------------------------------------------------
# chunked secular solve (laed4) over a root range


def _secular_chunk(ds, zmask, rho, deflated, tol, lo, csz, laed4_iter):
    """Solve the secular equation for roots [lo, lo + csz) of one merge.

    All inputs replicated; returns chunk-local (anchor, sgn, troot).
    Mirrors tridiag_dc._merge's anchored laed4 exactly, restricted to a
    root chunk (reference: merge.h:798-974 multi-worker rank-1 solve).
    """
    n = ds.shape[0]
    dt = ds.dtype
    eps = jnp.finfo(dt).eps
    normz2 = jnp.sum(zmask * zmask)
    z2r = zmask * zmask
    tiny = jnp.finfo(dt).tiny * 1e4

    idx32 = jnp.arange(n, dtype=jnp.int32)
    masked_idx = jnp.where(deflated, jnp.int32(n), idx32)
    sufmin = lax.associative_scan(jnp.minimum, masked_idx[::-1])[::-1]
    next_idx = jnp.concatenate([sufmin[1:], jnp.full((1,), jnp.int32(n))])
    has_next_all = next_idx < n
    next_all = jnp.minimum(next_idx, n - 1)
    top_delta = rho * normz2 * (1 + 4 * eps) + tol
    delta_all = jnp.where(has_next_all, ds[next_all] - ds, top_delta)
    delta_all = jnp.maximum(delta_all, jnp.finfo(dt).tiny)

    cidx = lo + jnp.arange(csz, dtype=jnp.int32)          # my global roots
    ds_c = lax.dynamic_slice(ds, (lo,), (csz,))
    defl_c = lax.dynamic_slice(deflated, (lo,), (csz,))
    delta = lax.dynamic_slice(delta_all, (lo,), (csz,))
    has_next = lax.dynamic_slice(has_next_all, (lo,), (csz,))
    next_c = lax.dynamic_slice(next_all, (lo,), (csz,))

    dd_c = ds[None, :] - ds_c[:, None]                    # (csz, n)

    def fval(mu):
        den = dd_c - mu[:, None]
        safe = jnp.where(jnp.abs(den) < tiny,
                         jnp.where(den < 0, -tiny, tiny), den)
        return 1.0 + rho * jnp.sum(z2r[None, :] / safe, axis=1)

    right = (fval(0.5 * delta) < 0) & has_next
    anchor = jnp.where(right, next_c, cidx)
    sgn = jnp.where(right, -1.0, 1.0).astype(dt)
    dd_a = ds[None, :] - ds[anchor][:, None]
    w_own = z2r[anchor]
    own = anchor[:, None] == idx32[None, :]
    tmax = jnp.where(right, 0.5 * delta, jnp.where(has_next, 0.5 * delta, delta))

    def g_parts(t):
        den = dd_a - (sgn * t)[:, None]
        safe = jnp.where(jnp.abs(den) < tiny,
                         jnp.where(den < 0, -tiny, tiny), den)
        terms = z2r[None, :] / safe
        f = 1.0 + rho * jnp.sum(terms, axis=1)
        df = rho * jnp.sum(z2r[None, :] / (safe * safe), axis=1)
        s_no_own = 1.0 + rho * jnp.sum(jnp.where(own, 0.0, terms), axis=1)
        return sgn * f, df, s_no_own

    def iter_fn(carry):
        lo_, hi_, t, it = carry
        g, df, s_no_own = g_parts(t)
        lo_ = jnp.where(g < 0, t, lo_)
        hi_ = jnp.where(g < 0, hi_, t)
        newton = t - g / jnp.maximum(df, jnp.finfo(dt).tiny)
        fp_den = jnp.where(right, -s_no_own, s_no_own)
        fp = rho * w_own / jnp.where(fp_den > 0, fp_den, jnp.inf)

        def pick(cand, cur):
            ok = (cand > lo_) & (cand < hi_)
            return jnp.where(ok, cand, cur)

        mid = 0.5 * (lo_ + hi_)
        t = pick(fp, mid)
        t = pick(newton, t)
        return lo_, hi_, t, it + 1

    def iter_cond(carry):
        lo_, hi_, t, it = carry
        unresolved = jnp.any((hi_ - lo_) > 2 * eps * jnp.abs(t) + jnp.finfo(dt).tiny)
        return (it < laed4_iter) & unresolved

    lo0 = jnp.zeros((csz,), dt)
    _, _, troot, _ = lax.while_loop(iter_cond, iter_fn,
                                    (lo0, tmax, 0.5 * tmax, jnp.int32(0)))
    troot = jnp.where(defl_c, 0.0, troot)
    anchor = jnp.where(defl_c, cidx, anchor)
    sgn = jnp.where(defl_c, 1.0, sgn)
    return anchor, sgn, troot


def _zhat_chunk(ds, zs2, anchor, sgn, troot, deflated, lo, csz):
    """Gu/Eisenstat zhat for rows [lo, lo + csz) (replicated inputs)."""
    n = ds.shape[0]
    ds_c = lax.dynamic_slice(ds, (lo,), (csz,))
    defl_c = lax.dynamic_slice(deflated, (lo,), (csz,))
    zs2_c = lax.dynamic_slice(zs2, (lo,), (csz,))
    cidx = lo + jnp.arange(csz)
    lam_anchor = ds[anchor]                                # (n,)
    # right-anchored mu = lam - ds_i with the pole difference FIRST (as in
    # tridiag_dc._merge): rounding ds[anchor] - troot before subtracting
    # ds_i loses the small root offset and the eigenvectors' orthogonality
    mu_all = jnp.where((anchor != jnp.arange(n)) & (~deflated),
                       (lam_anchor - ds) + sgn * troot,
                       troot)
    # rows i in chunk, all j columns
    num = (lam_anchor[None, :] - ds_c[:, None]) + (sgn * troot)[None, :]
    dd = ds[None, :] - ds_c[:, None]
    offdiag = cidx[:, None] != jnp.arange(n)[None, :]
    safe_den = jnp.where(offdiag & (dd != 0), dd, 1.0)
    ratio = jnp.where(offdiag, num / safe_den, 1.0)
    ratio = jnp.where(offdiag & (dd == 0), 1.0, ratio)
    prod = jnp.prod(ratio, axis=1)
    mu_c = lax.dynamic_slice(mu_all, (lo,), (csz,))
    zhat2 = jnp.maximum(mu_c * prod, 0.0)
    zhat = jnp.sign(zs2_c) * jnp.sqrt(zhat2)
    return jnp.where(defl_c, 0.0, zhat)


# ---------------------------------------------------------------------------
# the distributed solver


def _dc_dist_shardfn(d, e, *, laed4_iter, levels, nblocks, D, cc):
    Z = jnp.int32(0)
    dtv = d.dtype
    m = d.shape[0]
    p = lax.axis_index(ROW_AXIS)
    q_ = lax.axis_index(COL_AXIS)
    Qn = lax.axis_size(COL_AXIS)
    did = p * Qn + q_
    # the merge tree runs on the largest power-of-2 device subset; inactive
    # devices (did >= D2) execute the same SPMD program on clamped duplicate
    # data and contribute masked ZEROS to every psum
    D2 = pow2_floor(D)
    act = did < D2

    # Cuppen tears at every leaf boundary (replicated diagonal-only mod)
    if nblocks > 1:
        bidx = jnp.arange(1, nblocks) * LEAF
        rho_all = jnp.abs(e[bidx - 1])
        dmod = d.at[bidx - 1].add(-rho_all).at[bidx].add(-rho_all)
    else:
        dmod = d
    dleaf = dmod.reshape(nblocks, LEAF)
    eleaf = e.reshape(nblocks, LEAF)[:, :-1]
    tmats = jax.vmap(lambda dv, ev: jnp.diag(dv) + jnp.diag(ev, 1) +
                     jnp.diag(ev, -1))(dleaf, eleaf)
    lam_all, q_leaf = jax.vmap(_jacobi_eigh)(tmats)        # replicated

    tol_scale = jnp.max(jnp.abs(d)) + 2 * jnp.max(jnp.abs(e))

    # ---- initial local layout -------------------------------------------
    # Eigenvector blocks are carried TRANSPOSED throughout (see
    # tridiag_dc._merge_vectors): column rotations/permutations become fast
    # contiguous major-dimension row ops. Mode A holds transposed (size, size)
    # batches; mode B holds qt_loc = Q^T[:, row-block] of shape
    # (size, rows_loc) — i.e. the device's row shard of Q, transposed.
    mode_a = nblocks >= D2
    if mode_a:
        nb_loc = nblocks // D2
        q_loc = jnp.swapaxes(
            lax.dynamic_slice(q_leaf, (did * nb_loc, Z, Z),
                              (nb_loc, LEAF, LEAF)), 1, 2)
        lam_loc = lax.dynamic_slice(lam_all, (did * nb_loc, Z), (nb_loc, LEAF))
    else:
        g0 = D2 // nblocks
        rows0 = LEAF // g0
        bi = did // g0
        gi = did % g0
        q_loc = lax.dynamic_slice(q_leaf, (bi, gi * rows0, Z),
                                  (1, rows0, LEAF))[0].T   # (LEAF, rows0)
        lam_loc = None

    size = LEAF
    nbatch = nblocks
    for _lvl in range(levels):
        nb_new = nbatch // 2
        if nb_new >= D2:
            # ---- mode A: device-local merges (existing batched path) ----
            lam1, lam2 = lam_loc[0::2], lam_loc[1::2]
            q1, q2 = q_loc[0::2], q_loc[1::2]
            nb_loc2 = lam1.shape[0]
            first_g = did * (nbatch // D2) // 2             # first new batch id
            bnd = (first_g + jnp.arange(nb_loc2)) * (2 * size) + size
            ecut = e[bnd - 1]
            rho = jnp.abs(ecut)
            theta = jnp.where(ecut >= 0, 1.0, -1.0).astype(dtv)
            dcat = jnp.concatenate([lam1, lam2], axis=1)
            zcat = jnp.concatenate([theta[:, None] * q1[:, :, -1],
                                    q2[:, :, 0]], axis=1)  # rows, transposed

            def do_merge(dv, zv, rv, q1v, q2v):
                lamv, zhat, ds, perm, mu, defl, rots = _merge(
                    dv, zv, rv, tol_scale, laed4_iter)
                return _merge_vectors(q1v, q2v, lamv, zhat, perm, mu, defl,
                                      rots, ds)

            lam_loc, q_loc = jax.vmap(do_merge)(dcat, zcat, rho, q1, q2)
        else:
            # ---- mode B: row-sharded merges over device groups ----------
            g_new = D2 // nb_new
            g_old = g_new // 2
            if lam_loc is not None:
                # transition A -> B (here nbatch == D, one batch per device):
                # replicate the eigenvalues; the transposed (size, size) batch
                # is already qt_loc with rows_loc == size
                buf = jnp.zeros((nbatch, size), dtv)
                buf = lax.dynamic_update_slice(
                    buf, jnp.where(act, lam_loc[0], 0)[None], (did, Z))
                lam_all = lax.psum(lax.psum(buf, ROW_AXIS), COL_AXIS)
                lam_loc = None
                rows_loc = size
                q_loc = q_loc[0]
            else:
                rows_loc = q_loc.shape[1]
            ob = did // max(g_old, 1)                       # old batch id
            half = ob % 2
            gi_old = did % max(g_old, 1)
            j = ob // 2                                    # new batch id
            gi_new = did % g_new                           # position in group

            # z assembly: one psum of (nb_new, 2*size)
            bnd = (jnp.arange(nb_new)) * (2 * size) + size
            ecut = e[bnd - 1]
            rho_all = jnp.abs(ecut)
            theta = jnp.where(ecut >= 0, 1.0, -1.0).astype(dtv)
            zbuf = jnp.zeros((nb_new, 2 * size), dtv)
            own_last = (half == 0) & (gi_old == max(g_old, 1) - 1)
            own_first = (half == 1) & (gi_old == 0)
            zrow = jnp.where(own_last, theta[j] * q_loc[:, -1], 0.0)
            zrow2 = jnp.where(own_first, q_loc[:, 0], 0.0)
            contrib = jnp.where(act, jnp.concatenate([zrow, zrow2]), 0)
            zbuf = lax.dynamic_update_slice(zbuf, contrib[None], (j, Z))
            z_all = lax.psum(lax.psum(zbuf, ROW_AXIS), COL_AXIS)

            dcat_all = lam_all.reshape(nb_new, 2 * size)

            # replicated per-batch deflation (vmapped scan, O(m) total)
            ds_a, zmask_a, zs2_a, perm_a, defl_a, rots_a, tol_a = jax.vmap(
                lambda dv, zv, rv: _deflate(dv, zv, rv, tol_scale)
            )(dcat_all, z_all, rho_all)

            # my batch's replicated vectors
            take = functools.partial(jax.tree_util.tree_map,
                                     lambda x: lax.dynamic_slice(
                                         x, (j,) + (Z,) * (x.ndim - 1),
                                         (1,) + x.shape[1:])[0])
            ds, zmask, zs2, perm, defl = take((ds_a, zmask_a, zs2_a, perm_a,
                                               defl_a))
            rots = take(rots_a)
            tolj = take(tol_a)
            rho = rho_all[j]

            # root-sharded secular solve + zhat, gathered by one psum each
            csz = (2 * size) // g_new
            lo = gi_new * csz
            anch_c, sgn_c, troot_c = _secular_chunk(
                ds, zmask, rho, defl, tolj, lo, csz, laed4_iter)
            # gather roots (zhat needs all anchors/troots): one psum
            rbuf = jnp.zeros((nb_new, 3, 2 * size), dtv)
            rpack = jnp.where(
                act, jnp.stack([anch_c.astype(dtv), sgn_c, troot_c]), 0)
            rbuf = lax.dynamic_update_slice(rbuf, rpack[None], (j, Z, lo))
            rall = lax.psum(lax.psum(rbuf, ROW_AXIS), COL_AXIS)
            anchor_a = rall[:, 0].astype(jnp.int32)
            sgn_a = rall[:, 1]
            troot_a = rall[:, 2]
            anchor = anchor_a[j]
            sgn = sgn_a[j]
            troot = troot_a[j]

            zhat_c = _zhat_chunk(ds, zs2, anchor, sgn, troot, defl, lo, csz)
            zbuf2 = jnp.zeros((nb_new, 2 * size), dtv)
            zbuf2 = lax.dynamic_update_slice(
                zbuf2, jnp.where(act, zhat_c, 0)[None], (j, lo))
            zhat_a = lax.psum(lax.psum(zbuf2, ROW_AXIS), COL_AXIS)
            zhat = zhat_a[j]

            lam_sortedd = ds[anchor] + sgn * troot         # in sorted-d order
            order = argsort(lam_sortedd)
            lam_new = lam_sortedd[order]

            # update the replicated eigenvalues: psum of my batch's row from
            # one representative device per group
            lbuf = jnp.zeros((nb_new, 2 * size), dtv)
            lbuf = lax.dynamic_update_slice(
                lbuf, jnp.where(act & (gi_new == 0), lam_new, 0.0)[None],
                (j, Z))
            lam_all = lax.psum(lax.psum(lbuf, ROW_AXIS), COL_AXIS)

            # ---- local eigenvector update (zero communication) ----------
            # embed [[Q1, 0], [0, Q2]] — a no-op on row shards; in the
            # transposed storage the embedding stacks along axis 0
            zeros = jnp.zeros_like(q_loc)
            q_emb = jnp.where(half == 0,
                              jnp.concatenate([q_loc, zeros], axis=0),
                              jnp.concatenate([zeros, q_loc], axis=0))
            # deflation Givens rotations on columns of Q = rows of Q^T,
            # translated to pre-perm column indices; valid rotations are
            # stable-sorted first and applied with a dynamic-trip while_loop
            # (deflation is sparse — see tridiag_dc._merge_vectors)
            rc, rs, rpi, ri = rots
            validm = rpi >= 0
            order_r = argsort(jnp.where(validm, 0, 1))
            rc, rs, rpi, ri = rc[order_r], rs[order_r], rpi[order_r], ri[order_r]
            nvalid = jnp.sum(validm.astype(jnp.int32))
            zero = jnp.zeros((), ri.dtype)

            def rot_body(carry):
                qm, kk = carry
                pi_o = perm[jnp.maximum(rpi[kk], 0)].astype(jnp.int32)
                i_o = perm[ri[kk]].astype(jnp.int32)
                rowp = lax.dynamic_slice(qm, (pi_o, zero), (1, rows_loc))
                rowi = lax.dynamic_slice(qm, (i_o, zero), (1, rows_loc))
                newp = rc[kk] * rowp + rs[kk] * rowi
                newi = -rs[kk] * rowp + rc[kk] * rowi
                qm = lax.dynamic_update_slice(qm, newp, (pi_o, zero))
                qm = lax.dynamic_update_slice(qm, newi, (i_o, zero))
                return qm, kk + 1

            q_emb, _ = lax.while_loop(lambda ca: ca[1] < nvalid, rot_body,
                                      (q_emb, jnp.int32(0)))

            # chunked rank-1 eigenvector factor, with BOTH the sorted-d
            # permutation (rows) and the eigenvalue sort (columns) folded in:
            #   qv[c, i] = zhat[rank_c] / (ds[rank_c] - lam_new[i])
            # where rank_c = position of original column c in sorted-d order.
            rank = argsort(perm)                       # invperm
            anchor_s = anchor[order]
            sgn_s = sgn[order]
            troot_s = troot[order]
            defl_s = defl[order]
            ord_pos = argsort(order)                   # sorted-d -> final
            eps = jnp.finfo(dtv).eps

            def qv_chunk(c0):
                ridx = rank[c0 + jnp.arange(csz)]          # (csz,)
                # den[c, i] = ds[rank_c] - lam_i via anchored representation
                # (same orientation as tridiag_dc._merge_vectors)
                den = (ds[ridx][:, None] - ds[anchor_s][None, :]) \
                    - (sgn_s * troot_s)[None, :]
                safe = jnp.where(den == 0, eps, den)
                qv = zhat[ridx][:, None] / safe
                # deflated eigenvector i is e_{sorted-d index} -> indicator
                qv = jnp.where(defl_s[None, :],
                               (ridx[:, None] == order[None, :]).astype(dtv),
                               qv)
                return qv

            # acc^T[i, r] = sum_c qv[c, i] q_emb^T[c, r]: contract the leading
            # dims in one GEMM, keeping the transposed storage throughout
            acc = jnp.zeros((2 * size, rows_loc), dtv)
            nrm = jnp.zeros((2 * size, 1), dtv)

            def gemm_step(k, carry):
                acc, nrm = carry
                c0 = k * csz
                qv = qv_chunk(c0)
                acc = acc + lax.dot_general(
                    qv, lax.dynamic_slice(q_emb, (c0, 0), (csz, rows_loc)),
                    (((0,), (0,)), ((), ())), precision=matmul_precision())
                nrm = nrm + jnp.sum(qv * qv, axis=0)[:, None]
                return acc, nrm

            acc, nrm = lax.fori_loop(0, g_new, gemm_step, (acc, nrm))
            nrm = jnp.sqrt(nrm)
            q_loc = acc / jnp.where(nrm > 0, nrm, 1.0)

        size *= 2
        nbatch = nb_new

    if lam_loc is not None:     # never entered mode B (D2 == 1 or tiny)
        lam_all = lam_loc
        q_fin = q_loc[0]        # transposed (m, m)
    else:
        q_fin = q_loc           # qt_loc (m, rows_loc)
    # Row shards (held by the D2 active devices) -> Q column shards over ALL
    # D devices: one all-to-all over the flat axis splitting the column index
    # (axis 0 of the transposed storage, zero-padded to cc*D) plus a LOCAL
    # transpose. Device d receives qt[d*cc:(d+1)*cc, :] from every source —
    # the first D2*rows_loc = m received columns are Q's rows, the rest are
    # the inactive devices' zeroed shards — so its transpose is exactly
    # Q[:, d*cc:(d+1)*cc] (zero columns past m).
    if D > 1:
        if D2 != D:
            q_fin = jnp.where(act, q_fin, 0)
        if cc * D != m:
            q_fin = jnp.concatenate(
                [q_fin, jnp.zeros((cc * D - m, q_fin.shape[1]), dtv)], axis=0)
        q_cols = lax.all_to_all(q_fin, AXES, split_axis=0, concat_axis=1,
                                tiled=True)[:, :m].T
    else:
        q_cols = q_fin.T
    return lam_all.reshape(m), q_cols


@functools.partial(jax.jit, static_argnames=("laed4_iter", "mesh",
                                             "col_align"))
def _tridiag_dc_dist_padded(d, e, laed4_iter, mesh, col_align):
    m = d.shape[0]
    nblocks = m // LEAF
    levels = 0
    size = LEAF
    while size < m:
        size *= 2
        levels += 1
    D = mesh.devices.size
    # per-device column chunk of the final exchange: ceil(m / D) rounded up
    # to col_align (= the caller's tile size, keeping the downstream
    # cols->canonical all-to-all on its tile-aligned fast path)
    cc = m if D == 1 else col_align * (-(-m // (D * col_align)))
    fn = jax.shard_map(
        functools.partial(_dc_dist_shardfn, laed4_iter=laed4_iter,
                          levels=levels, nblocks=nblocks, D=D, cc=cc),
        mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P(None, AXES)),
        check_vma=False)
    return fn(d, e)


def tridiag_eigh_dist(d, e, mesh, laed4_iter: int = 120,
                      col_align: int = 1):
    """Distributed eigendecomposition of the symmetric tridiagonal (d, e).

    Returns (lam (n,) replicated, q column-sharded over the flattened mesh,
    m) where m is the padded D&C size; q has m rows and >= m columns (extra
    zero columns only when the device count does not divide m; real columns
    are always the leading m); q[:n, :n] is the eigenvector matrix and the
    padding block is decoupled identity. ``col_align`` rounds the per-device
    column chunk up to a tile size. Caller must check
    :func:`dc_dist_supported` first.
    """
    from .tridiag_dc import laed4_iter_cap
    d = jnp.asarray(d)
    e = jnp.asarray(e)
    laed4_iter = laed4_iter_cap(d.dtype, laed4_iter)
    n = d.shape[0]
    dt = d.dtype
    m = LEAF
    while m < n:
        m *= 2
    emax = jnp.max(jnp.abs(e)) if n > 1 else jnp.zeros((), dt)
    gersh = jnp.max(jnp.abs(d)) + 2 * emax
    padvals = gersh + 1.0 + jnp.arange(m - n, dtype=dt)
    dp = jnp.concatenate([d, padvals])
    ep = jnp.zeros((m,), dt)
    if n > 1:
        ep = ep.at[: n - 1].set(e)
    lam, q = _tridiag_dc_dist_padded(dp, ep, laed4_iter, mesh,
                                     col_align)
    return lam, q, m
