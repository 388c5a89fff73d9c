"""Distributed matrix in canonical block-cyclic shard layout.

Analog of the reference's ``Matrix<T, Device>``
(``matrix/matrix.h:58``): a ``jax.Array`` of shape (P, Q, lm, ln) sharded so
device (p, q) holds its packed local matrix (see
:mod:`dlaf_jax.dist.layout`), plus the ``Distribution`` metadata. Tile
pipelines/senders have no equivalent: inside ``shard_map`` the local shard is
a dense array and XLA orders all accesses by dataflow.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..comm.mesh import Grid
from ..dist import Distribution, gather_from_shards, scatter_to_shards


@dataclasses.dataclass
class DistMatrix:
    data: jax.Array            # (P, Q, lm, ln), sharded over the grid
    dist: Distribution
    grid: Grid

    @classmethod
    def from_global(cls, a, nb: int, grid: Grid, pad_identity: bool = False):
        """Scatter a host/global (m, n) array onto the grid.

        ``pad_identity`` puts an identity block on the padded diagonal
        (needed so triangular/SPD algorithms can run on the padded shape).

        Works in multi-process (multi-host) runtimes too: every process
        passes the SAME global array (the reference's replicated-input
        convention for its sync C API) and only the shards addressable by
        this process are materialized, via :meth:`from_callback`.
        """
        m, n = a.shape
        if jax.process_count() > 1:
            import numpy as np

            an = np.asarray(a)
            return cls.from_callback(lambda idx: an[idx], (m, n), nb, grid,
                                     an.dtype, pad_identity=pad_identity)
        d = Distribution((m, n), (nb, nb), grid.grid_size)
        pm, pn = d.padded_size
        ap = jnp.pad(a, ((0, pm - m), (0, pn - n)))
        if pad_identity:
            k = min(pm, pn)
            eye = jnp.eye(k, dtype=a.dtype)
            mask = jnp.pad(jnp.ones((m, n), jnp.bool_), ((0, pm - m), (0, pn - n)))
            ap = jnp.where(mask, ap, jnp.pad(eye, ((0, pm - k), (0, pn - k))))
        shards = scatter_to_shards(ap, d)
        data = jax.device_put(shards, grid.canonical_sharding())
        return cls(data, d, grid)

    @classmethod
    def from_callback(cls, cb, size, nb: int, grid: Grid, dtype,
                      pad_identity: bool = False):
        """Build a DistMatrix without ever materializing the global array:
        ``cb((row_slice, col_slice)) -> ndarray`` is called once per needed
        global region, only for shards addressable by THIS process — the
        multi-host construction path (each host fills only its devices'
        shards; the reference reads user/ScaLAPACK-owned local memory the
        same way, ``src/c_api/utils.cpp:68``). Out-of-range (padding)
        regions are requested clamped and zero-filled here;
        ``pad_identity`` puts ones on the padded diagonal (same contract
        as :meth:`from_global`).
        """
        import numpy as np

        m, n = size
        d = Distribution((m, n), (nb, nb), grid.grid_size)
        pm, pn = d.padded_size
        Pg, Qg = grid.grid_size
        lmt, lnt = d.max_local_nr_tiles
        lm, ln = lmt * nb, lnt * nb

        def shard_cb(index):
            # index: the (P, Q, lm, ln) global-array slices of this shard
            p = index[0].start or 0
            q = index[1].start or 0
            out = np.zeros((1, 1, lm, ln), dtype)
            for lt in range(lmt):
                gr = (lt * Pg + p) * nb
                if gr >= m:
                    continue
                for ct in range(lnt):
                    gc = (ct * Qg + q) * nb
                    if gc >= n:
                        continue
                    blk = np.asarray(cb((slice(gr, min(gr + nb, m)),
                                         slice(gc, min(gc + nb, n)))))
                    out[0, 0, lt * nb:lt * nb + blk.shape[0],
                        ct * nb:ct * nb + blk.shape[1]] = blk
            if pad_identity:
                for g in range(min(m, n), min(pm, pn)):
                    t = g // nb
                    if t % Pg == p and t % Qg == q:
                        out[0, 0, (t // Pg) * nb + g % nb,
                            (t // Qg) * nb + g % nb] = 1
            return out

        data = jax.make_array_from_callback(
            (Pg, Qg, lm, ln), grid.canonical_sharding(), shard_cb)
        return cls(data, d, grid)

    def to_global(self):
        """Gather to a single (m, n) array (unpadded).

        In multi-process runtimes the shard array is first replicated with
        a jitted identity (an ``all_gather`` over the mesh), so every
        process can read the whole result process-locally.
        """
        data = self.data
        if jax.process_count() > 1:
            from jax.sharding import NamedSharding, PartitionSpec

            data = jax.jit(
                lambda x: x,
                out_shardings=NamedSharding(self.grid.mesh,
                                            PartitionSpec()))(data)
        full = gather_from_shards(jax.device_get(data), self.dist)
        m, n = self.dist.size
        return full[:m, :n]

    def diagonal(self) -> jax.Array:
        """Replicated (min(m, n),) diagonal, extracted device-side with one
        masked pass per shard + psum (no host gather)."""
        nb = self.dist.block_size[0]
        pm = self.dist.padded_size[0]
        d = _dist_diagonal(self.data, nb=nb, pm=pm, mesh=self.grid.mesh)
        return d[: min(self.dist.size)]

    def transpose(self, conj: bool = True) -> "DistMatrix":
        """Distributed (conjugate) transpose, fully device-resident.

        On square grids this is a pure axis swap of the canonical layout
        (shard (p,q) -> (q,p), local shards transposed) — XLA lowers the
        resharding to a collective permute. Non-square grids run
        ONE uniform tile-granular ``lax.all_to_all`` inside shard_map
        (per-device transient memory O(n^2/D); reference analog: the
        transposed-Panel + hand-rolled all-to-all machinery,
        ``matrix/panel.h:483``, ``permutations/general/impl.h:230-303``).
        """
        from ..dist import Distribution

        P, Q = self.grid.grid_size
        m, n = self.dist.size
        if P == Q:
            newdist = Distribution((n, m), self.dist.block_size[::-1],
                                   self.grid.grid_size, self.src_rank_t())
            data = self.data.transpose(1, 0, 3, 2)
            if conj:
                data = jnp.conj(data)
            data = jax.device_put(data, self.grid.canonical_sharding())
            return DistMatrix(data, newdist, self.grid)
        assert self.dist.src_rank == (0, 0) and \
            self.dist.block_size[0] == self.dist.block_size[1]
        newdist = Distribution((n, m), self.dist.block_size[::-1],
                               self.grid.grid_size)
        data = _transpose_a2a(self.data, nb=self.dist.block_size[0],
                              grid_size=self.grid.grid_size,
                              lmt2=newdist.max_local_nr_tiles[0],
                              lnt2=newdist.max_local_nr_tiles[1],
                              conj=conj, mesh=self.grid.mesh)
        return DistMatrix(data, newdist, self.grid)

    def symmetrize(self, lower: bool = True) -> "DistMatrix":
        """Fill the other triangle from the stored one, device-resident:
        A <- tril(A) + tril(A,-1)^H for ``lower`` (the transpose runs the
        tile-granular all-to-all / axis-swap path; the triangle merge is a
        local masked combine per shard)."""
        # the combine computes global indices assuming origin ownership;
        # a sub-distribution view must be materialized (sub_matrix) first
        assert self.dist.src_rank == (0, 0), \
            "symmetrize needs src_rank (0, 0); take sub_matrix() first"
        t = self.transpose(conj=True)
        data = _symmetrize_combine(self.data, t.data,
                                   nb=self.dist.block_size[0], lower=lower,
                                   mesh=self.grid.mesh)
        return DistMatrix(data, self.dist, self.grid)

    def retiled(self, tile_size) -> "DistMatrix":
        """Finer-tiled metadata view of the same device buffers (reference
        ``retiledSubPipeline``, ``matrix/matrix.h:377-432``): no data movement,
        only ``dist.tile`` changes."""
        return DistMatrix(self.data, self.dist.retiled(tile_size), self.grid)

    def sub_matrix(self, tile_offset, size, pad_identity: bool = False) -> "DistMatrix":
        """Device-resident extraction of the tile-aligned sub-matrix starting
        at global tile ``tile_offset`` with element ``size`` into a fresh
        canonical DistMatrix with src rank (0, 0).

        Analog of the reference's ``MatrixRef``
        (``matrix/matrix_ref.h:34``): because block-cyclic ownership of the
        sub-matrix is the parent's shifted by a *constant* rank offset per
        axis, the reshard is one ``lax.ppermute`` per mesh axis plus a
        device-local dynamic slice — no host gather, O(sub size / D) per
        device.  ``pad_identity`` fills the canonical padding with an identity
        block (required before running SPD/triangular algorithms on the view).
        """
        oti, otj = tile_offset
        m2, n2 = size
        nb = self.dist.block_size[0]
        assert self.dist.block_size[0] == self.dist.block_size[1]
        assert self.dist.src_rank == (0, 0)
        newdist = Distribution((m2, n2), self.dist.block_size,
                               self.grid.grid_size)
        lmt2, lnt2 = newdist.max_local_nr_tiles
        data = _sub_matrix_extract(
            self.data, oti=oti, otj=otj, m2=m2, n2=n2, nb=nb,
            lmt2=lmt2, lnt2=lnt2, grid_size=self.grid.grid_size,
            pad_identity=pad_identity, mesh=self.grid.mesh)
        return DistMatrix(data, newdist, self.grid)

    def set_sub_matrix(self, sub: "DistMatrix", tile_offset) -> "DistMatrix":
        """Write ``sub``'s true (m2, n2) region back into this matrix at global
        tile ``tile_offset`` (inverse of :meth:`sub_matrix`), device-resident.
        Returns the updated matrix; padding regions of ``sub`` are ignored."""
        oti, otj = tile_offset
        m2, n2 = sub.dist.size
        nb = self.dist.block_size[0]
        assert sub.dist.block_size == self.dist.block_size
        assert self.dist.src_rank == (0, 0) and sub.dist.src_rank == (0, 0)
        data = _sub_matrix_insert(
            self.data, sub.data, oti=oti, otj=otj, m2=m2, n2=n2, nb=nb,
            grid_size=self.grid.grid_size, mesh=self.grid.mesh)
        return DistMatrix(data, self.dist, self.grid)

    def src_rank_t(self):
        return (self.dist.src_rank[1] % self.grid.grid_size[0],
                self.dist.src_rank[0] % self.grid.grid_size[1])

    @property
    def block_size(self) -> int:
        return self.dist.block_size[0]

    @property
    def local_shape(self):
        return self.data.shape[-2:]


def _transpose_a2a_shardfn(a4, *, nb, P, Q, lmt2, lnt2, conj):
    """Tile-granular distributed transpose on a non-square (P, Q) grid.

    A's tile (i, j) lives on rank (i % P, j % Q); A^T's tile (j, i) must land
    on rank (j % P, i % Q). With g = gcd(P, Q), the tiles a source sends to
    one destination form ONE residue class mod lcm(P, Q) per dimension (CRT),
    so the exchange is a single uniform ``lax.all_to_all`` over padded slot
    buffers — the reference's hand-rolled per-partner all-to-all
    (``permutations/general/impl.h:230-303``) without the variable-size
    messages. Per-device transient memory: O(local size * g^2): destinations
    in an incompatible residue class get zero-filled slots of the same
    (uniform) size. g == 1 for coprime grids like (2, 3); the worst common
    case (2, 4) pays 4x on the exchange buffer — still O(n^2/D), never the
    O(n^2) global view this path replaces.
    """
    import math

    from jax import lax

    from ..comm.mesh import COL_AXIS, ROW_AXIS
    a = a4[0, 0]
    p = lax.axis_index(ROW_AXIS).astype(jnp.int32)
    q = lax.axis_index(COL_AXIS).astype(jnp.int32)
    lm, ln = a.shape
    lmt, lnt = lm // nb, ln // nb
    D = P * Q
    g = math.gcd(P, Q)
    qg, pg = Q // g, P // g                   # row/col residue periods
    inv_p = pow(P // g, -1, qg) if qg > 1 else 0   # static modular inverses
    inv_q = pow(Q // g, -1, pg) if pg > 1 else 0
    sr = -(-lmt // qg)                        # row-tile slots per destination
    sc = -(-lnt // pg)                        # col-tile slots per destination
    tiles = a.reshape(lmt, nb, lnt, nb)

    # ---- send: for each destination (p2, q2), my row tiles t with
    # t*P + p == q2 (mod Q) are t == t0 (mod Q/g); cols analogously
    sbs = []
    for p2 in range(P):
        for q2 in range(Q):
            t0 = (((q2 - p) // g) * inv_p) % qg
            u0 = (((p2 - q) // g) * inv_q) % pg
            ts = t0 + jnp.arange(sr, dtype=jnp.int32) * qg
            us = u0 + jnp.arange(sc, dtype=jnp.int32) * pg
            blk = jnp.take(tiles, jnp.minimum(ts, lmt - 1), axis=0)
            blk = jnp.take(blk, jnp.minimum(us, lnt - 1), axis=2)
            valid = (ts < lmt)[:, None, None, None] & \
                (us < lnt)[None, None, :, None]
            sbs.append(jnp.where(valid, blk, 0))
    sb = jnp.stack(sbs).reshape(D, sr * nb, sc * nb)

    rcv = lax.all_to_all(sb, (ROW_AXIS, COL_AXIS), split_axis=0,
                         concat_axis=0, tiled=True)
    # (D, sr, nb, sc, nb) -> flat slot-major tile array (D*sr*sc, nb, nb)
    rtiles = rcv.reshape(D, sr, nb, sc, nb).transpose(0, 1, 3, 2, 4) \
        .reshape(D * sr * sc, nb, nb)

    # ---- reassemble MY A^T tile (t2, u2) = global (i2, j2): it is A's tile
    # (j2, i2) from source (j2 % P, i2 % Q), at that source's slot
    # ((j2//P - t0_s) / qg, (i2//Q - u0_s) / pg) for destination (p, q)
    t2 = jnp.arange(lmt2, dtype=jnp.int32)
    u2 = jnp.arange(lnt2, dtype=jnp.int32)
    i2 = (t2 * P + p)[:, None]                # A^T global row tile
    j2 = (u2 * Q + q)[None, :]                # A^T global col tile
    p_s = j2 % P
    q_s = i2 % Q
    t_s = j2 // P
    u_s = i2 // Q
    t0_s = (((q - p_s) // g) * inv_p) % qg
    u0_s = (((p - q_s) // g) * inv_q) % pg
    r = (t_s - t0_s) // qg
    c = (u_s - u0_s) // pg
    ok = (t_s < lmt) & (u_s < lnt)
    idx = (p_s * Q + q_s) * (sr * sc) + r * sc + c
    got = jnp.take(rtiles, jnp.clip(idx, 0, D * sr * sc - 1).reshape(-1),
                   axis=0).reshape(lmt2, lnt2, nb, nb)
    got = jnp.where(ok[:, :, None, None], got, 0)
    got = jnp.conj(got) if conj else got
    # transpose each tile and lay out as the (lm2, ln2) local block
    out = got.transpose(0, 3, 1, 2).reshape(lmt2 * nb, lnt2 * nb)
    return out[None, None]


@functools.partial(jax.jit, static_argnames=("nb", "grid_size", "lmt2",
                                             "lnt2", "conj", "mesh"))
def _transpose_a2a(data, *, nb, grid_size, lmt2, lnt2, conj, mesh):
    from jax.sharding import PartitionSpec as P
    from ..comm.mesh import COL_AXIS, ROW_AXIS
    fn = jax.shard_map(
        functools.partial(_transpose_a2a_shardfn, nb=nb, P=grid_size[0],
                          Q=grid_size[1], lmt2=lmt2, lnt2=lnt2, conj=conj),
        mesh=mesh, in_specs=(P(ROW_AXIS, COL_AXIS, None, None),),
        out_specs=P(ROW_AXIS, COL_AXIS, None, None))
    return fn(data)


def _global_rows(lmt, nb, grid, r):
    """Global element rows covered by this rank's ``lmt`` local tiles."""
    return (jnp.arange(lmt) * grid + r).repeat(nb) * nb + \
        jnp.tile(jnp.arange(nb), lmt)


def _sub_extract_shardfn(a4, *, oti, otj, m2, n2, nb, lmt2, lnt2, P, Q,
                         pad_identity):
    from jax import lax

    from ..comm.mesh import COL_AXIS, ROW_AXIS
    a = a4[0, 0]
    p = lax.axis_index(ROW_AXIS).astype(jnp.int32)
    q = lax.axis_index(COL_AXIS).astype(jnp.int32)
    # sub tile (i2, j2) is parent tile (i2+oti, j2+otj): ownership shifts by a
    # constant rank offset, so one ppermute per axis brings the right shard
    if oti % P:
        a = lax.ppermute(a, ROW_AXIS, [(s, (s - oti) % P) for s in range(P)])
    if otj % Q:
        a = lax.ppermute(a, COL_AXIS, [(s, (s - otj) % Q) for s in range(Q)])
    lm, ln = a.shape
    pad_r = max(0, ((P - 1 + oti) // P + lmt2) * nb - lm)
    pad_c = max(0, ((Q - 1 + otj) // Q + lnt2) * nb - ln)
    a = jnp.pad(a, ((0, pad_r), (0, pad_c)))
    # ... and the local tile index shifts by the rank-dependent constant
    # (p+oti)//P (global (t2*P+p)+oti = (t2 + (p+oti)//P)*P + (p+oti)%P)
    roff = (p + oti) // P * nb
    coff = (q + otj) // Q * nb
    out = lax.dynamic_slice(a, (roff, coff), (lmt2 * nb, lnt2 * nb))
    grow = _global_rows(lmt2, nb, P, p)
    gcol = _global_rows(lnt2, nb, Q, q)
    valid = (grow < m2)[:, None] & (gcol < n2)[None, :]
    out = jnp.where(valid, out, 0)
    if pad_identity:
        eye = (grow[:, None] == gcol[None, :]) & ~valid
        out = jnp.where(eye, jnp.ones((), out.dtype), out)
    return out[None, None]


@functools.partial(jax.jit, static_argnames=("oti", "otj", "m2", "n2", "nb",
                                             "lmt2", "lnt2", "grid_size",
                                             "pad_identity", "mesh"))
def _sub_matrix_extract(data, *, oti, otj, m2, n2, nb, lmt2, lnt2, grid_size,
                        pad_identity, mesh):
    from jax.sharding import PartitionSpec as P
    from ..comm.mesh import COL_AXIS, ROW_AXIS
    fn = jax.shard_map(
        functools.partial(_sub_extract_shardfn, oti=oti, otj=otj, m2=m2, n2=n2,
                          nb=nb, lmt2=lmt2, lnt2=lnt2, P=grid_size[0],
                          Q=grid_size[1], pad_identity=pad_identity),
        mesh=mesh, in_specs=(P(ROW_AXIS, COL_AXIS, None, None),),
        out_specs=P(ROW_AXIS, COL_AXIS, None, None))
    return fn(data)


def _sub_insert_shardfn(a4, s4, *, oti, otj, m2, n2, nb, P, Q):
    from jax import lax

    from ..comm.mesh import COL_AXIS, ROW_AXIS
    a, s = a4[0, 0], s4[0, 0]
    p = lax.axis_index(ROW_AXIS).astype(jnp.int32)
    q = lax.axis_index(COL_AXIS).astype(jnp.int32)
    lm, ln = a.shape
    lmt2, lnt2 = s.shape[0] // nb, s.shape[1] // nb
    grow = _global_rows(lmt2, nb, P, p)
    gcol = _global_rows(lnt2, nb, Q, q)
    valid = (grow < m2)[:, None] & (gcol < n2)[None, :]
    # stage into a parent-shaped buffer at the (rank-dependent) local offset,
    # THEN permute to the owner — the offset is known on the source rank
    pad_r = max(0, ((P - 1 + oti) // P + lmt2) * nb - lm)
    pad_c = max(0, ((Q - 1 + otj) // Q + lnt2) * nb - ln)
    buf = jnp.zeros((lm + pad_r, ln + pad_c), a.dtype)
    msk = jnp.zeros((lm + pad_r, ln + pad_c), jnp.bool_)
    roff = (p + oti) // P * nb
    coff = (q + otj) // Q * nb
    buf = lax.dynamic_update_slice(buf, jnp.where(valid, s, 0), (roff, coff))
    msk = lax.dynamic_update_slice(msk, valid, (roff, coff))
    if oti % P:
        perm = [(r, (r + oti) % P) for r in range(P)]
        buf = lax.ppermute(buf, ROW_AXIS, perm)
        msk = lax.ppermute(msk, ROW_AXIS, perm)
    if otj % Q:
        perm = [(r, (r + otj) % Q) for r in range(Q)]
        buf = lax.ppermute(buf, COL_AXIS, perm)
        msk = lax.ppermute(msk, COL_AXIS, perm)
    out = jnp.where(msk[:lm, :ln], buf[:lm, :ln], a)
    return out[None, None]


@functools.partial(jax.jit, static_argnames=("oti", "otj", "m2", "n2", "nb",
                                             "grid_size", "mesh"))
def _sub_matrix_insert(data, sub, *, oti, otj, m2, n2, nb, grid_size, mesh):
    from jax.sharding import PartitionSpec as P
    from ..comm.mesh import COL_AXIS, ROW_AXIS
    spec = P(ROW_AXIS, COL_AXIS, None, None)
    fn = jax.shard_map(
        functools.partial(_sub_insert_shardfn, oti=oti, otj=otj, m2=m2, n2=n2,
                          nb=nb, P=grid_size[0], Q=grid_size[1]),
        mesh=mesh, in_specs=(spec, spec), out_specs=spec)
    return fn(data, sub)


def _symmetrize_shardfn(a4, t4, *, nb, lower):
    from jax import lax

    from ..comm.mesh import COL_AXIS, ROW_AXIS
    a, t = a4[0, 0], t4[0, 0]
    p = lax.axis_index(ROW_AXIS)
    q = lax.axis_index(COL_AXIS)
    Pn = lax.axis_size(ROW_AXIS)
    Qn = lax.axis_size(COL_AXIS)
    lm, ln = a.shape
    grow = (jnp.arange(lm // nb) * Pn + p).repeat(nb) * nb + \
        jnp.tile(jnp.arange(nb), lm // nb)
    gcol = (jnp.arange(ln // nb) * Qn + q).repeat(nb) * nb + \
        jnp.tile(jnp.arange(nb), ln // nb)
    keep = grow[:, None] >= gcol[None, :] if lower else \
        grow[:, None] <= gcol[None, :]
    return jnp.where(keep, a, t)[None, None]


@functools.partial(jax.jit, static_argnames=("nb", "lower", "mesh"))
def _symmetrize_combine(data, tdata, *, nb, lower, mesh):
    from jax.sharding import PartitionSpec as P
    from ..comm.mesh import COL_AXIS, ROW_AXIS
    spec = P(ROW_AXIS, COL_AXIS, None, None)
    fn = jax.shard_map(
        functools.partial(_symmetrize_shardfn, nb=nb, lower=lower),
        mesh=mesh, in_specs=(spec, spec), out_specs=spec)
    return fn(data, tdata)


def _diag_shardfn(a4, *, nb, pm):
    import jax.numpy as jnp
    from jax import lax
    from ..comm.mesh import COL_AXIS, ROW_AXIS
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
    eq = grow[:, None] == gcol[None, :]
    loc = jnp.sum(jnp.where(eq, a, 0), axis=1)
    owned = jnp.any(eq, axis=1)
    out = jnp.zeros((pm,), a.dtype)
    out = out.at[jnp.minimum(grow, pm - 1)].add(
        jnp.where(owned & (grow < pm), loc, 0))
    return lax.psum(lax.psum(out, ROW_AXIS), COL_AXIS)


@functools.partial(jax.jit, static_argnames=("nb", "pm", "mesh"))
def _dist_diagonal(data, *, nb, pm, mesh):
    from jax.sharding import PartitionSpec as P
    from ..comm.mesh import COL_AXIS, ROW_AXIS
    fn = jax.shard_map(
        functools.partial(_diag_shardfn, nb=nb, pm=pm),
        mesh=mesh, in_specs=(P(ROW_AXIS, COL_AXIS, None, None),),
        out_specs=P())
    return fn(data)


jax.tree_util.register_pytree_node(
    DistMatrix,
    lambda dm: ((dm.data,), (dm.dist, dm.grid)),
    lambda aux, children: DistMatrix(children[0], aux[0], aux[1]),
)
