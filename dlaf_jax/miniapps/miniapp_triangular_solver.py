"""Triangular solver miniapp (reference ``miniapp/miniapp_triangular_solver.cpp``).

GFlop/s with add = mul = m^2 n / 2 (m = order of A, n = RHS columns).
"""
from __future__ import annotations

import functools

import jax
import numpy as np

import dlaf_jax as dt
from dlaf_jax.matrix import generators as gen
from dlaf_jax.types import eps, total_ops

from . import options


def main(argv=None):
    args = options.parser("miniapp_triangular_solver").parse_args(argv)
    m, nb = args.matrix_size, args.block_size
    n = args.m or m // 2 or 1
    dtype = options.dtype_of(args)
    a = gen.random_triangular(jax.random.PRNGKey(0), m, dtype,
                              lower=(args.uplo == "L"))
    b = gen.random_general(jax.random.PRNGKey(1), (m, n), dtype)

    if args.grid_rows * args.grid_cols > 1:
        from dlaf_jax.algos.triangular import triangular_solver
        from dlaf_jax.comm.mesh import Grid
        from dlaf_jax.matrix.dist_matrix import DistMatrix
        grid = Grid((args.grid_rows, args.grid_cols))
        da = DistMatrix.from_global(a, nb, grid, pad_identity=True)
        db = DistMatrix.from_global(b, nb, grid)
        fn = functools.partial(triangular_solver, da, db, uplo=args.uplo)
        get = lambda out: np.asarray(out.to_global())
    else:
        jfn = jax.jit(lambda aa, bb: dt.trsm(aa, bb, uplo=args.uplo, nb=min(nb, 512)))
        fn = functools.partial(jfn, a, b)
        get = np.asarray

    flops = total_ops(dtype, m * m * n / 2, m * m * n / 2)

    def check(out):
        x = get(out)
        res = np.max(np.abs(np.asarray(a) @ x - np.asarray(b)))
        return res <= 500 * m * eps(dtype), f"residual {res:.2e}"

    options.run_timed(args, fn, flops, check_fn=check)


if __name__ == "__main__":
    main()
