"""Global dense <-> canonical block-cyclic shard layout conversions.

Replacement for the reference's ``matrix/layout_info.h`` +
``matrix/copy.h``: instead of describing strided local memory for MPI
datatypes, we define ONE canonical device layout and convert with pure
reshapes/transposes (cheap, XLA-fusable, and valid for both numpy and
jax arrays):

    canonical shards: shape (P, Q, lm, ln)
      shard [p, q] is rank (p, q)'s packed local matrix: local tile (i, j)
      lives at [p, q, i*mb:(i+1)*mb, j*nb:(j+1)*nb] and corresponds to global
      tile (i*P + p, j*Q + q)   (block-cyclic, src rank (0, 0)).

The global array must be padded to ``Distribution.padded_size`` first.
"""
from __future__ import annotations

from .distribution import Distribution


def scatter_to_shards(a, dist: Distribution):
    """(pm, pn) padded global array -> (P, Q, lm, ln) canonical shards."""
    P, Q = dist.grid_size
    mb, nb = dist.block_size
    lmt, lnt = dist.max_local_nr_tiles
    pm, pn = dist.padded_size
    assert a.shape[-2:] == (pm, pn), (a.shape, dist)
    lead = a.shape[:-2]
    a = a.reshape(lead + (lmt, P, mb, lnt, Q, nb))
    nl = len(lead)
    perm = tuple(range(nl)) + tuple(nl + k for k in (1, 4, 0, 2, 3, 5))
    a = a.transpose(perm)
    return a.reshape(lead + (P, Q, lmt * mb, lnt * nb))


def gather_from_shards(shards, dist: Distribution):
    """(P, Q, lm, ln) canonical shards -> (pm, pn) padded global array."""
    P, Q = dist.grid_size
    mb, nb = dist.block_size
    lmt, lnt = dist.max_local_nr_tiles
    lead = shards.shape[:-4]
    assert shards.shape[-4:] == (P, Q, lmt * mb, lnt * nb), (shards.shape, dist)
    a = shards.reshape(lead + (P, Q, lmt, mb, lnt, nb))
    nl = len(lead)
    perm = tuple(range(nl)) + tuple(nl + k for k in (2, 0, 3, 4, 1, 5))
    a = a.transpose(perm)
    return a.reshape(lead + dist.padded_size)
