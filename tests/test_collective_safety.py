"""Static collective-schedule safety across distributed entry points.

The reference runs sanitizer lanes in CI for its mutable-tile task graph
(SURVEY.md §5 race detection). dlaf_jax's SPMD programs cannot data-race,
but a collective under rank-divergent control flow deadlocks; dlaf_jax.debug
statically extracts each program's collective schedule and flags the two
divergence patterns (collective in a lax.cond branch / lax.while body).
These tests (a) prove the detector catches seeded divergences and (b) sweep
every distributed algorithm entry point — trace-only, nothing executes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dlaf_jax.debug import (assert_same_schedule, check_collective_safety,
                            collective_schedule)
from dlaf_jax.comm.mesh import Grid
from dlaf_jax.matrix import generators as gen
from dlaf_jax.matrix.dist_matrix import DistMatrix


def _mesh22():
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("r", "c"))


# --- detector self-tests (seeded divergences) ------------------------------

def test_detects_cond_divergent_collective():
    mesh = _mesh22()
    from jax.sharding import PartitionSpec as P

    def body(x):
        return jax.lax.cond(jnp.sum(x) > 0,
                            lambda v: v + jax.lax.psum(jnp.sum(v), "c"),
                            lambda v: v, x)

    fn = jax.shard_map(body, mesh=mesh, in_specs=P("r", "c"),
                       out_specs=P("r", "c"))
    x = jnp.ones((4, 4))
    findings = check_collective_safety(fn, x)
    assert any("cond-divergent" in f for f in findings), findings


def test_detects_while_collective():
    mesh = _mesh22()
    from jax.sharding import PartitionSpec as P

    def body(x):
        def w_cond(c):
            return jnp.sum(c) < 100.0

        def w_body(c):
            return c + jax.lax.psum(jnp.sum(c), "r")

        return jax.lax.while_loop(w_cond, w_body, x)

    fn = jax.shard_map(body, mesh=mesh, in_specs=P("r", "c"),
                       out_specs=P("r", "c"))
    findings = check_collective_safety(fn, jnp.ones((4, 4)))
    assert any("while-collective" in f for f in findings), findings


def test_identical_branches_pass():
    mesh = _mesh22()
    from jax.sharding import PartitionSpec as P

    def body(x):
        return jax.lax.cond(jnp.sum(x) > 0,
                            lambda v: jax.lax.psum(v, "r"),
                            lambda v: jax.lax.psum(v * 2, "r"), x)

    fn = jax.shard_map(body, mesh=mesh, in_specs=P("r", "c"),
                       out_specs=P(None, "c"))
    assert check_collective_safety(fn, jnp.ones((4, 4))) == []


def test_schedule_through_scan():
    mesh = _mesh22()
    from jax.sharding import PartitionSpec as P

    def body(x):
        def f(c, _):
            return jax.lax.ppermute(c, "c",
                                    [(i, (i + 1) % 2) for i in range(2)]), None
        y, _ = jax.lax.scan(f, x, None, length=3)
        return jax.lax.psum(y, "r")

    fn = jax.shard_map(body, mesh=mesh, in_specs=P("r", "c"),
                       out_specs=P(None, "c"))
    sched = collective_schedule(fn, jnp.ones((4, 4)))
    # psum lowers to psum_invariant on an unvarying output spec
    assert [op.prim for op in sched] == ["ppermute", "psum_invariant"]
    assert sched[0].path.endswith("scan/")


# --- every distributed algorithm entry point is statically safe ------------

def _fixtures(grid_size=(2, 2), n=64, nb=16):
    g = Grid(grid_size)
    a = gen.random_hermitian_positive_definite(jax.random.PRNGKey(0), n,
                                               np.dtype("float32"))
    b = jax.random.normal(jax.random.PRNGKey(1), (n, n), jnp.float32)
    da = DistMatrix.from_global(a, nb, g, pad_identity=True)
    db = DistMatrix.from_global(b, nb, g)
    return g, da, db


@pytest.mark.parametrize("grid_size", [(2, 2), (2, 3)])
def test_dist_cholesky_statically_safe(grid_size):
    from dlaf_jax.algos.cholesky import cholesky
    g, da, _ = _fixtures(grid_size)
    for uplo in ("L", "U"):
        fn = (lambda u: lambda x:
              cholesky(DistMatrix(x, da.dist, g), uplo=u).data)(uplo)
        assert check_collective_safety(fn, da.data) == []
        assert len(collective_schedule(fn, da.data)) > 0


def test_dist_trsm_gemm_statically_safe():
    from dlaf_jax.algos.triangular import triangular_solver
    from dlaf_jax.algos.general import general_multiplication
    g, da, db = _fixtures()

    def trsm(x, y):
        return triangular_solver(DistMatrix(x, da.dist, g),
                                 DistMatrix(y, db.dist, g)).data

    def gemm(x, y):
        return general_multiplication(DistMatrix(x, da.dist, g),
                                      DistMatrix(y, db.dist, g)).data

    assert check_collective_safety(trsm, da.data, db.data) == []
    assert check_collective_safety(gemm, da.data, db.data) == []


def test_dist_eigh_statically_safe():
    from dlaf_jax.algos.eigensolver.dist_driver import eigh_dist
    g, da, _ = _fixtures()

    def fe(x):
        return eigh_dist(DistMatrix(x, da.dist, g))[1].data

    assert check_collective_safety(fe, da.data) == []


def test_dist_gen_to_std_statically_safe():
    from dlaf_jax.algos.cholesky import cholesky
    from dlaf_jax.algos.gen_to_std import generalized_to_standard_dist
    g, da, db = _fixtures()
    l = cholesky(da)

    def fn(x, y):
        return generalized_to_standard_dist(
            DistMatrix(x, da.dist, g), DistMatrix(y, da.dist, g)).data

    assert check_collective_safety(fn, da.data, l.data) == []


def test_schedule_stable_across_grids():
    """The same algorithm lowers to the same collective schedule shape on
    different grids of the same topology rank — a rank-count change cannot
    introduce a divergent schedule (assert_same_schedule smoke)."""
    from dlaf_jax.algos.cholesky import cholesky

    def run(grid_size):
        g, da, _ = _fixtures(grid_size)
        return lambda x: cholesky(DistMatrix(x, da.dist, g)).data, da.data

    f1, x1 = run((2, 2))
    sched = assert_same_schedule(f1, [(x1,)])
    assert len(sched) > 0
