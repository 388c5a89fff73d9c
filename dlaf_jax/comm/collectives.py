"""Mesh collectives used inside shard_map SPMD programs.

The reference's MPI tile collectives (``communication/kernels/*.h``:
``schedule_bcast_send/recv``, ``scheduleAllReduce``, P2P sends) map here to
XLA collectives over mesh axes: broadcast = masked ``psum``, reduce = ``psum``,
ring = ``ppermute``, redistribution = ``all_gather``/``all_to_all``. Ordering,
tags, and communicator pipelines disappear — XLA's dataflow gives a total
order per channel.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def axis_id(axis: str):
    return lax.axis_index(axis)


def bcast(x, owner, axis: str):
    """Broadcast ``x`` from the rank with coordinate ``owner`` along ``axis``
    (reference ``schedule_bcast_send/recv``, ``kernels/broadcast.h:39``).

    Size-1 axes skip the mask select (axis size is static at trace time):
    the psum itself folds to a no-op copy, but the ``where`` against a
    dynamic ``owner`` would survive as an O(elements) select per broadcast.
    The psum is KEPT so the
    varying->invariant axis typing of the result is unchanged."""
    if lax.axis_size(axis) == 1:
        return lax.psum(x, axis)
    mine = lax.axis_index(axis) == owner
    contrib = jnp.where(mine, x, jnp.zeros_like(x))
    return lax.psum(contrib, axis)


def bcast2d(x, owner_rc, axes=("r", "c")):
    """Broadcast from a single (p, q) rank to the whole grid (degenerate
    axes skip their mask, see ``bcast``)."""
    p, q = owner_rc
    if lax.axis_size(axes[0]) == 1:
        return lax.psum(bcast(x, q, axes[1]), axes[0])
    if lax.axis_size(axes[1]) == 1:
        return lax.psum(bcast(x, p, axes[0]), axes[1])
    mine = (lax.axis_index(axes[0]) == p) & (lax.axis_index(axes[1]) == q)
    contrib = jnp.where(mine, x, jnp.zeros_like(x))
    return lax.psum(lax.psum(contrib, axes[0]), axes[1])


def allreduce_sum(x, axis: str):
    """reference ``scheduleAllReduce`` / ``schedule_all_reduce_in_place``."""
    return lax.psum(x, axis)


def allgather_tiles(x, axis: str):
    """Gather shards along ``axis`` -> leading axis of size |axis|."""
    return lax.all_gather(x, axis)


def ring_shift(x, axis: str, shift: int = 1):
    """Cyclic shift along ``axis`` (reference P2P ring in band_to_tridiag,
    ``band_to_tridiag/mc.h:438-662``) via ``ppermute``."""
    n = lax.axis_size(axis)
    perm = [(i, (i + shift) % n) for i in range(n)]
    return lax.ppermute(x, axis, perm)
