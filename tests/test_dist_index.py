"""Unit tests for 1-D/2-D block-cyclic index math.

Port of the reference's test strategy for ``matrix/util_distribution.h`` and
``matrix/distribution.h`` (test/unit/matrix/test_distribution.cpp): check the
conversion surface against a brute-force model.
"""
import numpy as np
import pytest

from dlaf_jax.dist import Distribution, index as ix


def brute_force_owner(num_tiles, grid, src):
    return [(t + src) % grid for t in range(num_tiles)]


@pytest.mark.parametrize("grid,src", [(1, 0), (2, 0), (3, 1), (4, 3)])
def test_1d_roundtrip(grid, src):
    num_tiles = 17
    owners = brute_force_owner(num_tiles, grid, src)
    local_count = {r: 0 for r in range(grid)}
    for gt in range(num_tiles):
        r = owners[gt]
        assert ix.rank_global_tile(gt, grid, src) == r
        lt = ix.local_tile_from_global_tile(gt, grid)
        assert lt == local_count[r]
        assert ix.global_tile_from_local_tile(lt, grid, r, src) == gt
        local_count[r] += 1
    for r in range(grid):
        assert ix.local_num_tiles(num_tiles, grid, r, src) == local_count[r]
        # next_local_tile: number of owned tiles before gt
        for gt in range(num_tiles + 1):
            expected = sum(1 for t in range(gt) if owners[t] == r)
            assert ix.next_local_tile_from_global_tile(gt, grid, r, src) == expected


@pytest.mark.parametrize("size,nb,grid", [(65, 8, 3), (64, 8, 2), (1, 4, 4), (0, 4, 2), (100, 7, 5)])
def test_local_size_numroc(size, nb, grid):
    for src in range(grid):
        total = 0
        for r in range(grid):
            ls = int(ix.local_size(size, nb, grid, r, src))
            # brute force: count elements whose tile is owned by r
            expected = sum(1 for el in range(size)
                           if (el // nb + src) % grid == r)
            assert ls == expected, (size, nb, grid, r, src)
            total += ls
        assert total == size


def test_element_conversions():
    nb, grid, src = 8, 3, 1
    for el in range(100):
        gt = ix.tile_from_element(el, nb)
        r = ix.rank_global_element(el, nb, grid, src)
        assert r == (gt + src) % grid
        lel = ix.local_element_from_global_element(el, nb, grid)
        assert ix.global_element_from_local_element(lel, nb, grid, r, src) == el


def test_distribution_2d():
    d = Distribution(size=(65, 33), block_size=(8, 8), grid_size=(3, 2), src_rank=(1, 0))
    assert d.nr_tiles == (9, 5)
    assert d.tile_size_of((8, 4)) == (1, 1)
    assert d.tile_size_of((0, 0)) == (8, 8)
    # ownership and local indexing round-trip
    for i in range(9):
        for j in range(5):
            r = d.rank_global_tile((i, j))
            lt = d.local_tile_index((i, j))
            assert d.global_tile_from_local(lt, r) == (i, j)
    # local sizes sum to global
    tot = 0
    for p in range(3):
        for q in range(2):
            lm, ln = d.local_size((p, q))
            tot += lm * ln
    assert tot == 65 * 33


def test_padded_layout_roundtrip():
    d = Distribution(size=(64, 48), block_size=(8, 8), grid_size=(2, 3))
    from dlaf_jax.dist import gather_from_shards, scatter_to_shards
    pm, pn = d.padded_size
    a = np.arange(pm * pn, dtype=np.float64).reshape(pm, pn)
    shards = scatter_to_shards(a, d)
    assert shards.shape == (2, 3, pm // 2, pn // 3)
    back = gather_from_shards(shards, d)
    np.testing.assert_array_equal(a, back)
    # spot-check block-cyclic placement: global tile (i,j) -> shard (i%P, j%Q)
    i, j = 3, 4
    tile = a[i * 8:(i + 1) * 8, j * 8:(j + 1) * 8]
    li, lj = i // 2, j // 3
    np.testing.assert_array_equal(
        shards[i % 2, j % 3, li * 8:(li + 1) * 8, lj * 8:(lj + 1) * 8], tile)


def test_sub_distribution():
    d = Distribution(size=(64, 64), block_size=(8, 8), grid_size=(2, 3))
    s = d.sub_distribution((16, 24), (32, 32))
    assert s.size == (32, 32)
    # tile (0,0) of sub == tile (2,3) of parent: same owner
    assert s.rank_global_tile((0, 0)) == d.rank_global_tile((2, 3))
    with pytest.raises(ValueError):
        d.sub_distribution((3, 0), (8, 8))


def test_block_ne_tile_1d_bruteforce():
    """Block != tile 1-D conversions vs explicit enumeration (reference
    util_distribution.h with tiles_per_block > 1)."""
    for grid in (1, 2, 3):
        for src in range(grid):
            for tpb in (1, 2, 4):
                nt = 23
                # enumerate: tile t belongs to block t//tpb, owner cyclic
                owner = [((t // tpb) + src) % grid for t in range(nt)]
                local = {}
                counts = [0] * grid
                for t in range(nt):
                    r = owner[t]
                    local[t] = counts[r]
                    counts[r] += 1
                for t in range(nt):
                    r = ix.rank_global_tile_b(t, tpb, grid, src)
                    assert r == owner[t], (t, tpb, grid, src)
                    lt = ix.local_tile_from_global_tile_b(t, tpb, grid)
                    assert lt == local[t], (t, tpb, grid, src, lt, local[t])
                    assert ix.global_tile_from_local_tile_b(
                        lt, tpb, grid, r, src) == t
                    for rank in range(grid):
                        want = sum(1 for u in range(t) if owner[u] == rank)
                        got = ix.next_local_tile_from_global_tile_b(
                            t, tpb, grid, rank, src)
                        assert got == want, (t, tpb, grid, src, rank)
                for rank in range(grid):
                    assert ix.local_num_tiles_b(nt, tpb, grid, rank, src) == \
                        counts[rank]


def test_distribution_block_ne_tile():
    """2-D Distribution with multi-tile blocks (reference
    matrix/distribution.h:59-63): ownership by block, tiling finer."""
    d = Distribution(size=(65, 33), block_size=(16, 8), grid_size=(3, 2),
                     src_rank=(1, 0), tile_size=(4, 4))
    assert d.tiles_per_block == (4, 2)
    assert d.nr_tiles == (17, 9)
    assert d.nr_blocks == (5, 5)
    # tiles inside one block share an owner
    assert d.rank_global_tile((0, 0)) == d.rank_global_tile((3, 1))
    assert d.rank_global_tile((4, 0)) != d.rank_global_tile((3, 0)) or 3 % 3 == 0
    for i in range(17):
        for j in range(9):
            r = d.rank_global_tile((i, j))
            lt = d.local_tile_index((i, j))
            assert d.global_tile_from_local(lt, r) == (i, j)
    tot = 0
    for p in range(3):
        for q in range(2):
            lm, ln = d.local_size((p, q))
            tot += lm * ln
    assert tot == 65 * 33
    # retiled view keeps layout/ownership, changes tiling only
    r = d.retiled((16, 8))
    assert r.tile == (16, 8) and r.tile_size is None
    assert r.padded_size == d.padded_size
    assert r.max_local_nr_tiles == d.max_local_nr_tiles
    r2 = r.retiled((4, 4))
    assert r2 == d
