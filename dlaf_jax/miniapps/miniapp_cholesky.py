"""Cholesky miniapp (reference ``miniapp/miniapp_cholesky.cpp``).

GFlop/s = total_ops(n^3/6 add, n^3/6 mul)/t; optional ||A - L L^H|| check.
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
    args = options.parser("miniapp_cholesky").parse_args(argv)
    n, nb = args.matrix_size, args.block_size
    dtype = options.dtype_of(args)
    a = gen.random_hermitian_positive_definite(jax.random.PRNGKey(0), n, dtype)

    distributed = args.grid_rows * args.grid_cols > 1
    if distributed:
        from dlaf_jax.algos.cholesky import cholesky
        from dlaf_jax.comm.mesh import Grid
        from dlaf_jax.matrix.dist_matrix import DistMatrix
        grid = Grid((args.grid_rows, args.grid_cols))
        dm = DistMatrix.from_global(a, nb, grid, pad_identity=True)
        fn = functools.partial(cholesky, dm)
        get = lambda out: np.tril(np.asarray(out.to_global()))
    else:
        jfn = jax.jit(lambda x: dt.potrf(x, uplo=args.uplo, nb=min(nb, 512)))
        fn = functools.partial(jfn, a)
        get = lambda out: np.asarray(out)

    flops = total_ops(dtype, n**3 / 6, n**3 / 6)

    def check(out):
        l = get(out)
        an = np.asarray(a)
        rec = l @ l.conj().T if args.uplo == "L" else l.conj().T @ l
        res = np.max(np.abs(rec - an)) / max(n, 1)
        return res <= 100 * n * eps(dtype), f"residual {res:.2e}"

    options.run_timed(args, fn, flops, check_fn=check)


if __name__ == "__main__":
    main()
