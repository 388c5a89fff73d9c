"""Communication miniapp (reference ``miniapp/miniapp_communication.cpp``):
times the mesh collectives used by the algorithms (psum-broadcast,
all_gather, ppermute ring) over the device grid."""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from dlaf_jax.comm import collectives as coll
from dlaf_jax.comm.mesh import COL_AXIS, ROW_AXIS, Grid

from . import options


def main(argv=None):
    args = options.parser("miniapp_communication").parse_args(argv)
    grid = Grid((args.grid_rows, args.grid_cols))
    n = args.matrix_size
    nd = args.grid_rows * args.grid_cols
    x = jnp.ones((nd, n, n), options.dtype_of(args))
    x = jax.device_put(x, jax.sharding.NamedSharding(
        grid.mesh, P((ROW_AXIS, COL_AXIS), None, None)))

    def bench(name, op):
        fn = jax.jit(jax.shard_map(op, mesh=grid.mesh,
                                   in_specs=P((ROW_AXIS, COL_AXIS), None, None),
                                   out_specs=P((ROW_AXIS, COL_AXIS), None, None)))
        options.sync(fn(x))
        t0 = time.perf_counter()
        for _ in range(args.nruns):
            out = fn(x)
        options.sync(out)
        t = (time.perf_counter() - t0) / args.nruns
        gb = x.nbytes / nd / 1e9
        print(f"{name}: {t*1e3:.3f} ms  ({gb / t:.2f} GB/s per-shard payload)")

    bench("psum_row", lambda v: lax.psum(v, ROW_AXIS) / grid.nr_rows)
    bench("psum_col", lambda v: lax.psum(v, COL_AXIS) / grid.nr_cols)
    bench("ring_row", lambda v: coll.ring_shift(v, ROW_AXIS))
    bench("allgather_row", lambda v: jnp.sum(lax.all_gather(v, ROW_AXIS), axis=0))


if __name__ == "__main__":
    main()
