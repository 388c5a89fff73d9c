"""Stage 3: symmetric tridiagonal eigensolver — Cuppen divide & conquer.

Re-design of the reference's tridiagonal D&C
(``eigensolver/tridiag_solver/impl.h`` + ``merge.h``): the same mathematical
pipeline — Cuppen decomposition, leaf solves, rank-one merge with deflation,
vectorized secular-equation solves, Gu/Eisenstat z-recomputation, eigenvector
GEMM — organized as a *level-synchronous batched* computation: all leaves are
solved with one vmapped kernel, then each merge level processes all pairs with
one vmapped merge, so every level is a handful of large batched GEMM-friendly
ops instead of a dynamic task graph.

Mappings to the reference:
  - cuppensDecomposition (impl.h:100-120)    -> rank-one tears at all block
    boundaries applied up front (diagonal-only modification, equivalent)
  - stedc leaf solve (impl.h:115-140)        -> batched cyclic Jacobi
  - deflation + Givens (merge.h:306-658)     -> vectorized z-threshold
    deflation + sequential scan of close-eigenvalue rotations
  - laed4 rank-1 solve (merge.h:798-974)     -> one vectorized
    bisection/Newton hybrid over all roots
  - multiplyEigenvectors (merge.h:974-1077)  -> batched GEMM per level

Everything is static-shape: n is padded to LEAF * 2^L with decoupled,
well-separated diagonal padding entries that deflate trivially.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ...ops.core import matmul_precision

LEAF = 32
# sweep budget: MIN is the fixed floor (sufficient for well-behaved
# leaves); the convergence check in _jacobi_eigh only EXTENDS the loop
# toward MAX while the off-diagonal mass is still far above its initial
# level (pathological clustering — the case a fixed count under-serves)
JACOBI_MIN_SWEEPS = 10
JACOBI_MAX_SWEEPS = 30
# a top-level merge of at least J_CHUNK_MIN rows streams its rank-one
# eigenvector table in J_CHUNK-row chunks (see _merge_vectors)
J_CHUNK_MIN = 16384
J_CHUNK = 2048


def argsort(x):
    """Indices stably sorting the 1-D ``x`` ascending, as int32.

    ``jnp.argsort`` sorts an int64 iota when x64 is enabled; XLA:GPU's
    permutation-sort simplifier then emits a scatter whose s32 reducer does
    not match the s64 operand, and the HLO verifier rejects the program
    ("accumulator shape ... s32[] vs s64[]"). Integer keys and the iota are
    kept int32, so no int64 enters the sort."""
    if jnp.issubdtype(x.dtype, jnp.integer):
        x = x.astype(jnp.int32)
    idx = lax.iota(jnp.int32, x.shape[0])
    return lax.sort((x, idx), num_keys=1, is_stable=True)[1]


# ---------------------------------------------------------------------------
# leaf solver: cyclic Jacobi on small dense symmetric matrices


import numpy as _np


def _round_robin_schedule(n):
    """Static circle-method tournament: n-1 rounds of n/2 disjoint pairs."""
    assert n % 2 == 0
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        partner = [0] * n
        for k in range(n // 2):
            i, j = players[k], players[n - 1 - k]
            partner[i] = j
            partner[j] = i
        rounds.append(partner)
        players = [players[0]] + [players[-1]] + players[1:-1]
    return rounds


def _jacobi_eigh(a):
    """Eigendecomposition of a small dense symmetric matrix by cyclic
    (sequential-rotation) Jacobi. Element access and updates are expressed
    through one-hot mask contractions instead of gathers/scatters; the
    mask form vectorizes over the leaf batch. The contractions run at
    HIGHEST precision: a one-hot product must be exact, and a default-
    precision f32 product may run in TF32 on the GPU. Cyclic ordering keeps
    the classical global-convergence guarantee (a parallel round-robin
    variant was tried and cycles on clustered tridiagonals).
    """
    n = a.shape[0]
    dt = a.dtype
    v0 = jnp.eye(n, dtype=dt)
    idx = jnp.arange(n)
    dot = functools.partial(jnp.dot, precision=lax.Precision.HIGHEST)

    def rotate(carry, pq):
        a, v = carry
        p, q = pq[0], pq[1]
        isp = (idx == p).astype(dt)
        isq = (idx == q).astype(dt)
        rp = dot(isp, a)
        rq = dot(isq, a)
        app = dot(rp, isp)
        aqq = dot(rq, isq)
        apq = dot(rp, isq)
        theta = (aqq - app) / (2 * jnp.where(apq == 0, 1.0, apq))
        # range-safe tangent: clamp |theta| before squaring so theta^2
        # cannot overflow; past the clamp the rotation angle is < eps and
        # the rotation is skipped outright
        at = jnp.minimum(jnp.abs(theta), 1e15)
        t = jnp.sign(theta) / (at + jnp.sqrt(at * at + 1))
        t = jnp.where(jnp.abs(theta) > 1e15, 0.0, t)
        t = jnp.where(theta == 0, 1.0, t)      # theta == 0 -> 45 degrees
        t = jnp.where(apq == 0, 0.0, t)
        c = 1.0 / jnp.sqrt(t * t + 1)
        s = t * c
        a = a + jnp.outer(isp, (c - 1) * rp - s * rq) \
              + jnp.outer(isq, s * rp + (c - 1) * rq)
        cp = dot(a, isp)
        cq = dot(a, isq)
        a = a + jnp.outer((c - 1) * cp - s * cq, isp) \
              + jnp.outer(s * cp + (c - 1) * cq, isq)
        vp = dot(v, isp)
        vq = dot(v, isq)
        v = v + jnp.outer((c - 1) * vp - s * vq, isp) \
              + jnp.outer(s * vp + (c - 1) * vq, isq)
        return (a, v), None

    pqs = jnp.array([(p, q) for p in range(n - 1) for q in range(p + 1, n)],
                    dtype=jnp.int32)

    offmask = (1.0 - jnp.eye(n)).astype(dt)

    def off_norm_sq(a):
        # masked, cancellation-free: sum(a^2) - sum(diag^2) reads 0 under
        # the huge D&C padding diagonal long before the off mass is gone
        m = a * offmask
        return jnp.sum(m * m)

    # Convergence policy: JACOBI_MIN_SWEEPS is the proven-sufficient budget
    # for well-behaved leaves (quadratic convergence lands at the rounding
    # floor by sweep ~6-7); the check only EXTENDS the loop — up to
    # JACOBI_MAX_SWEEPS — while the off-diagonal mass is still far above
    # its starting level's rounding floor (pathologically clustered
    # spectra, the case a fixed count silently under-served). The
    # threshold is relative to the INITIAL off mass, so it is scale-free
    # and immune to the huge decoupled padding diagonal.
    eps = jnp.finfo(dt).eps
    off_tol = (8 * eps) ** 2 * off_norm_sq(a)

    def cond(carry):
        a, _, it = carry
        return (it < JACOBI_MAX_SWEEPS) & \
            ((it < JACOBI_MIN_SWEEPS) | (off_norm_sq(a) > off_tol))

    def sweep(carry):
        a, v, it = carry
        (a, v), _ = lax.scan(rotate, (a, v), pqs)
        return a, v, it + 1

    a, v, _ = lax.while_loop(cond, sweep, (a, v0, jnp.int32(0)))
    w = jnp.diagonal(a)
    order = argsort(w)
    return w[order], v[:, order]


# ---------------------------------------------------------------------------
# merge: deflation + secular solve + eigenvector update


def _merge(d, z, rho, tol_scale, laed4_iter):
    """Eigen-analysis of diag(d) + rho z z^T (rho >= 0) with deflation.

    Returns (lam, zhat, dsort, perm, mu, deflated, rots); eigenvalues are
    lam = dsort + mu in d-sorted order (NOT resorted yet). All O(n^2)
    pole-difference tables are expressed as outer differences of ``dsort``
    so XLA fuses them into their reductions instead of materializing an
    (n, n) buffer at the top-level merge.
    """
    n = d.shape[0]
    dt = d.dtype
    eps = jnp.finfo(dt).eps

    perm = argsort(d)
    ds = d[perm]
    zs = z[perm]

    normz2 = jnp.sum(zs * zs)
    dspread = jnp.maximum(ds[-1] - ds[0], eps)
    tol = 8.0 * eps * jnp.maximum(tol_scale, dspread)

    # 1) z-threshold deflation (reference merge.h deflation tolerance)
    zsmall = jnp.abs(rho * zs) <= tol

    # 2) close-eigenvalue rotation deflation: sequential scan carrying the
    #    previous surviving index; each rotation zeroes z_i against z_prev
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

    # 3) secular roots: f(lam) = 1 + rho sum_j zmask_j^2/(ds_j - lam), one
    #    root per survivor i in (ds_i, ds_next_i). LAPACK-laed4 style: decide
    #    which interval endpoint the root is closer to, anchor the root there
    #    and solve for the offset t, so roots within O(eps * gap) of either
    #    pole are represented exactly: lam_i = ds[anchor_i] + sign_i * t_i.
    idx32 = jnp.arange(n, dtype=jnp.int32)
    masked_idx = jnp.where(deflated, jnp.int32(n), idx32)
    sufmin = lax.associative_scan(jnp.minimum, masked_idx[::-1])[::-1]
    next_idx = jnp.concatenate([sufmin[1:], jnp.full((1,), jnp.int32(n))])
    has_next = next_idx < n
    next_i = jnp.minimum(next_idx, n - 1)
    top_delta = rho * normz2 * (1 + 4 * eps) + tol
    delta = jnp.where(has_next, ds[next_i] - ds, top_delta)
    delta = jnp.maximum(delta, jnp.finfo(dt).tiny)

    z2r = zmask * zmask
    tiny = jnp.finfo(dt).tiny * 1e4

    def fval(mu):
        """f at lam = ds_i + mu (mu-based; only used for the side decision).
        Pole differences FIRST (LAPACK dlaed4 style): rounding (ds_i + mu_i)
        before subtracting would lose the pole gap for clustered spectra
        with large |ds| and could flip the root-side decision."""
        den = (ds[None, :] - ds[:, None]) - mu[:, None]   # (ds_j - ds_i) - mu
        safe = jnp.where(jnp.abs(den) < tiny,
                         jnp.where(den < 0, -tiny, tiny), den)
        return 1.0 + rho * jnp.sum(z2r[None, :] / safe, axis=1)

    # side decision at the midpoint (fixed for the rest of the solve)
    right = (fval(0.5 * delta) < 0) & has_next
    anchor = jnp.where(right, next_i, idx32)
    sgn = jnp.where(right, -1.0, 1.0).astype(dt)
    # dd_a[i, j] = ds_j - ds[anchor_i]
    dd_a = ds[None, :] - ds[anchor][:, None]
    w_own = z2r[anchor]                     # weight of the anchor's own pole
    own = anchor[:, None] == idx32[None, :]
    tmax = jnp.where(right, 0.5 * delta, jnp.where(has_next, 0.5 * delta, delta))

    def g_parts(t):
        """g(t) = sign * f(ds_anchor + sign t): increasing in t; plus parts."""
        den = dd_a - (sgn * t)[:, None]
        safe = jnp.where(jnp.abs(den) < tiny,
                         jnp.where(den < 0, -tiny, tiny), den)
        terms = z2r[None, :] / safe
        f = 1.0 + rho * jnp.sum(terms, axis=1)
        df = rho * jnp.sum(z2r[None, :] / (safe * safe), axis=1)
        s_no_own = 1.0 + rho * jnp.sum(jnp.where(own, 0.0, terms), axis=1)
        return sgn * f, df, s_no_own

    def iter_fn(carry):
        lo, hi, t, it = carry
        g, df, s_no_own = g_parts(t)
        lo = jnp.where(g < 0, t, lo)        # g increasing: g<0 -> root right
        hi = jnp.where(g < 0, hi, t)
        newton = t - g / jnp.maximum(df, jnp.finfo(dt).tiny)
        # fixed point absorbing the anchor's own pole:
        # left:  f = s_no_own - rho w/t = 0      -> t =  rho w / s_no_own
        # right: f = s_no_own + rho w/t = 0      -> t = -rho w / s_no_own
        fp_den = jnp.where(right, -s_no_own, s_no_own)
        fp = rho * w_own / jnp.where(fp_den > 0, fp_den, jnp.inf)
        def pick(cand, cur, lo, hi):
            ok = (cand > lo) & (cand < hi)
            return jnp.where(ok, cand, cur)
        mid = 0.5 * (lo + hi)
        t = pick(fp, mid, lo, hi)
        t = pick(newton, t, lo, hi)
        return lo, hi, t, it + 1

    def iter_cond(carry):
        lo, hi, t, it = carry
        # stop when every bracket is resolved to relative machine precision
        unresolved = jnp.any((hi - lo) > 2 * eps * jnp.abs(t) + jnp.finfo(dt).tiny)
        return (it < laed4_iter) & unresolved

    lo0 = jnp.zeros((n,), dt)
    lo_, hi_, troot, _ = lax.while_loop(
        iter_cond, iter_fn, (lo0, tmax, 0.5 * tmax, jnp.int32(0)))
    troot = jnp.where(deflated, 0.0, troot)
    anchor = jnp.where(deflated, idx32, anchor)
    sgn = jnp.where(deflated, 1.0, sgn)
    lam = ds[anchor] + sgn * troot
    # mu := lam - ds_i, exact when left-anchored (= troot)
    mu = jnp.where(right & (~deflated), delta - troot, troot)

    # 4) Gu/Eisenstat zhat so eigenvectors are numerically orthogonal:
    #    zhat_i^2 = mu_i * prod_{j != i} (lam_j - ds_i)/(ds_j - ds_i);
    #    deflated j (lam_j = ds_j) contribute ratio 1 automatically.
    #    lam_j - ds_i is formed through the anchored representation so the
    #    j whose root sits within eps of ds_i keeps full relative accuracy.
    idxs = jnp.arange(n)
    offdiag = idxs[:, None] != idxs[None, :]
    num = (ds[anchor][None, :] - ds[:, None]) + (sgn * troot)[None, :]
    dd = ds[None, :] - ds[:, None]          # dd[i, j] = ds_j - ds_i (fused)
    safe_den = jnp.where(offdiag & (dd != 0), dd, 1.0)
    ratio = jnp.where(offdiag, num / safe_den, 1.0)
    ratio = jnp.where(offdiag & (dd == 0), 1.0, ratio)
    prod = jnp.prod(ratio, axis=1)         # over j != i of ratio[i, j]
    zhat2 = jnp.maximum(mu * prod, 0.0)
    zhat = jnp.sign(zs2) * jnp.sqrt(zhat2)
    zhat = jnp.where(deflated, 0.0, zhat)

    root = (anchor, sgn, troot)
    return lam, zhat, ds, perm, root, deflated, rots


def _merge_vectors(qleft_t, qright_t, lam, zhat, perm, root, deflated, rots,
                   ds, j_chunk: int | None = None):
    """Assemble eigenvectors after a merge and sort ascending.

    The eigenvector matrix is carried TRANSPOSED (qT[j, r] = q[r, j]):
    deflation rotations and permutations act on *columns* of q, the minor
    (strided) dimension — in transposed storage they become contiguous
    major-dimension row slices/gathers, and the final GEMM consumes qT
    directly via dot_general (no materialized transpose).

    With ``j_chunk`` (static; huge top-level merges only) the rank-one
    eigenvector table qv is never materialized: the contraction runs as a
    fori_loop over j-chunks with the qv chunk fused from (zhat, ds, root)
    inside each step, cutting the merge's peak memory from qt+qv+qnew
    (3 n^2) to qt+qnew (2 n^2).
    """
    n = lam.shape[0]
    dt = lam.dtype
    n1 = qleft_t.shape[0]
    # build qt directly at permuted positions (scatter) instead of building
    # then gathering with qt[perm] — avoids a second transient (n, n) buffer
    inv = argsort(perm)             # inv[j] = destination row of source j
    qt = jnp.zeros((n, n), dt)
    qt = qt.at[inv[:n1], :n1].set(qleft_t)
    qt = qt.at[inv[n1:], n1:].set(qright_t)

    # deflation is sparse for generic spectra, so most rotations are no-ops:
    # stable-sort the valid ones to the front (preserving their order) and
    # run a dynamic-trip while_loop over just those, instead of an n-step
    # scan of mostly-dead iterations
    c_a, s_a, pi_a, i_a = rots
    validm = pi_a >= 0
    order_r = argsort(jnp.where(validm, 0, 1))
    c_a, s_a, pi_a, i_a = (c_a[order_r], s_a[order_r],
                           pi_a[order_r], i_a[order_r])
    nvalid = jnp.sum(validm.astype(jnp.int32))
    zero = jnp.zeros((), i_a.dtype)

    def rot_body(carry):
        qt, k = carry
        c = c_a[k]
        s = s_a[k]
        pi_ = jnp.maximum(pi_a[k], 0)
        i = i_a[k]
        rowp = lax.dynamic_slice(qt, (pi_, zero), (1, n))
        rowi = lax.dynamic_slice(qt, (i, zero), (1, n))
        newp = c * rowp + s * rowi
        newi = -s * rowp + c * rowi
        qt = lax.dynamic_update_slice(qt, newp, (pi_, zero))
        qt = lax.dynamic_update_slice(qt, newi, (i, zero))
        return qt, k + 1

    qt, _ = lax.while_loop(lambda ca: ca[1] < nvalid, rot_body,
                           (qt, jnp.int32(0)))

    # rank-one eigenvectors: qv[j, i] = zhat_j / (ds_j - lam_i), with the
    # denominator formed through the anchored root representation
    # den[j, i] = ds_j - lam_i = (ds_j - ds_anchor_i) - sgn_i * troot_i
    # (exact differences of sorted-d entries; deflated columns are identity)
    anchor, sgn, troot = root
    eps = jnp.finfo(dt).eps
    ds_anchor = ds[anchor]
    st = sgn * troot
    idx = jnp.arange(n)

    def qv_rows(j0, cj):
        """Unnormalized qv rows [j0, j0 + cj) fused from vectors."""
        dsj = lax.dynamic_slice(ds, (j0,), (cj,))
        zj = lax.dynamic_slice(zhat, (j0,), (cj,))
        den = (dsj[:, None] - ds_anchor[None, :]) - st[None, :]
        safe = jnp.where(den == 0, eps, den)
        qv = zj[:, None] / safe
        eye_blk = ((j0 + jnp.arange(cj))[:, None] == idx[None, :]).astype(dt)
        return jnp.where(deflated[None, :], eye_blk, qv)

    # qnew[r, i] = sum_j q[r, j] qv[j, i]  ->  transposed result directly:
    # qnewT[i, r] = sum_j qv[j, i] qT[j, r]  (contract leading dims in one GEMM);
    # column normalization applied as a row scaling of qnewT afterwards
    if j_chunk is None:
        qv = qv_rows(0, n)
        ssq = jnp.sum(qv * qv, axis=0)
        qnew_t = lax.dot_general(qv, qt, (((0,), (0,)), ((), ())),
                                 precision=matmul_precision())
    else:
        assert n % j_chunk == 0, (n, j_chunk)

        def chunk_step(k, carry):
            qnew_t, ssq = carry
            j0 = k * j_chunk
            qv = qv_rows(j0, j_chunk)
            qt_j = lax.dynamic_slice(qt, (j0, 0), (j_chunk, n))
            qnew_t = qnew_t + lax.dot_general(
                qv, qt_j, (((0,), (0,)), ((), ())),
                precision=matmul_precision())
            return qnew_t, ssq + jnp.sum(qv * qv, axis=0)

        qnew_t, ssq = lax.fori_loop(
            0, n // j_chunk, chunk_step,
            (jnp.zeros((n, n), dt), jnp.zeros((n,), dt)))
    norm = jnp.sqrt(ssq)
    qnew_t = qnew_t / jnp.where(norm > 0, norm, 1.0)[:, None]
    order = argsort(lam)
    return lam[order], qnew_t[order, :]


# ---------------------------------------------------------------------------
# driver


@functools.partial(jax.jit, static_argnames=("laed4_iter", "mesh"))
def _tridiag_dc_padded(d, e, laed4_iter, mesh=None):
    m = d.shape[0]
    dt = d.dtype
    levels = 0
    size = LEAF
    while size < m:
        size *= 2
        levels += 1
    assert size == m, (m, LEAF)

    def constrain(lam, q):
        """Distribute the level-synchronous batches over the mesh: deep
        levels shard the merge batch, top levels shard the eigenvector rows
        (reference: distributed mergeDistSubproblems, merge.h:1810-1941)."""
        if mesh is None:
            return lam, q
        from jax.sharding import NamedSharding, PartitionSpec as P
        axes = tuple(mesh.axis_names)
        ndev = mesh.devices.size
        nb_ = q.shape[0]
        if nb_ % ndev == 0:
            spec = P(axes, None, None)
        elif q.shape[1] % ndev == 0:
            spec = P(None, axes, None)
        else:
            return lam, q
        q = jax.lax.with_sharding_constraint(q, NamedSharding(mesh, spec))
        return lam, q

    # Cuppen tears at every leaf boundary, applied up front (diagonal-only)
    nblocks = m // LEAF
    if nblocks > 1:
        bidx = jnp.arange(1, nblocks) * LEAF
        rho_all = jnp.abs(e[bidx - 1])
        dmod = d.at[bidx - 1].add(-rho_all).at[bidx].add(-rho_all)
    else:
        dmod = d

    dleaf = dmod.reshape(nblocks, LEAF)
    eleaf = e.reshape(nblocks, LEAF)[:, :-1]

    def leaf_dense(dv, ev):
        return jnp.diag(dv) + jnp.diag(ev, 1) + jnp.diag(ev, -1)

    tmats = jax.vmap(leaf_dense)(dleaf, eleaf)
    lam, q = jax.vmap(_jacobi_eigh)(tmats)
    q = jnp.swapaxes(q, 1, 2)           # transposed storage (see _merge_vectors)
    lam, q = constrain(lam, q)

    tol_scale = jnp.max(jnp.abs(d)) + 2 * jnp.max(jnp.abs(e))

    size = LEAF
    for _lvl in range(levels):
        nb2 = lam.shape[0] // 2
        lam1, lam2 = lam[0::2], lam[1::2]
        q1, q2 = q[0::2], q[1::2]
        bnd = jnp.arange(nb2) * (2 * size) + size
        ecut = e[bnd - 1]
        rho = jnp.abs(ecut)
        theta = jnp.where(ecut >= 0, 1.0, -1.0).astype(dt)

        dcat = jnp.concatenate([lam1, lam2], axis=1)
        z1 = theta[:, None] * q1[:, :, -1]   # last row of q1 (transposed)
        z2 = q2[:, :, 0]                     # first row of q2 (transposed)
        zcat = jnp.concatenate([z1, z2], axis=1)

        def do_merge(dv, zv, rv, q1v, q2v, j_chunk=None):
            lamv, zhat, ds, perm, mu, defl, rots = _merge(  # mu = root repr
                dv, zv, rv, tol_scale, laed4_iter)
            return _merge_vectors(q1v, q2v, lamv, zhat, perm, mu, defl, rots,
                                  ds, j_chunk=j_chunk)

        # a huge top merge streams the rank-one table in j-chunks: peak
        # memory is qt+qnew instead of qt+qv+qnew (see _merge_vectors)
        mn = dcat.shape[1]
        jc = J_CHUNK if nb2 == 1 and mn >= J_CHUNK_MIN and \
            mn % J_CHUNK == 0 else None
        lam, q = jax.vmap(functools.partial(do_merge, j_chunk=jc))(
            dcat, zcat, rho, q1, q2)
        lam, q = constrain(lam, q)
        size *= 2

    return lam[0], q[0].T


def laed4_iter_cap(dtype, laed4_iter: int) -> int:
    """Bisection-resolution cap by dtype: a bracket resolves in ~mantissa
    bits worth of halvings, so f32 never needs the f64-sized budget (stuck
    brackets otherwise oscillate to the cap at identical eigenvalues)."""
    return min(laed4_iter, 48) if jnp.dtype(dtype) == jnp.float32 \
        else laed4_iter


def tridiag_eigh(d, e, laed4_iter: int = 120, mesh=None):
    """Full eigendecomposition of the symmetric tridiagonal (d, e).

    Reference: ``dlaf::eigensolver::internal::TridiagSolver``
    (``tridiag_solver/impl.h:198``). Returns (eigenvalues ascending,
    eigenvectors as columns), dtype-generic over f32/f64. With ``mesh`` the
    level-synchronous batches are sharded over the device grid.
    """
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
    lam, q = _tridiag_dc_padded(dp, ep, laed4_iter, mesh)
    return lam[:n], q[:n, :n]
