"""Tridiagonal D&C miniapp (reference ``miniapp/miniapp_tridiag_solver.cpp``)."""
from __future__ import annotations

import functools

import jax
import numpy as np

from dlaf_jax.algos.eigensolver.tridiag_dc import tridiag_eigh
from dlaf_jax.matrix import generators as gen
from dlaf_jax.types import eps

from . import options


def main(argv=None):
    p = options.parser("miniapp_tridiag_solver")
    p.set_defaults(input_dataset="/tridiag")  # reference default dataset
    args = p.parse_args(argv)
    dtype = options.dtype_of(args)
    if args.input_file:
        # reference layout (miniapp_tridiag_solver.cpp:109): an (n, 2) real
        # matrix, column 0 = diagonal, column 1 = off-diagonal (last unused)
        import jax.numpy as jnp

        from dlaf_jax.matrix.io import MatrixFile
        td = np.asarray(MatrixFile(args.input_file).read(args.input_dataset))
        args.matrix_size = td.shape[0]
        d = jnp.asarray(td[:, 0], dtype)
        e = jnp.asarray(td[:-1, 1], dtype)
    else:
        d = gen.random_general(jax.random.PRNGKey(0), (args.matrix_size,),
                               dtype)
        e = gen.random_general(jax.random.PRNGKey(1),
                               (max(args.matrix_size - 1, 1),),
                               dtype)[: args.matrix_size - 1]
    n = args.matrix_size

    grid = options.grid_of(args)
    if grid is not None:
        from dlaf_jax.algos.eigensolver.tridiag_dc_dist import (
            dc_dist_supported, tridiag_eigh_dist)
        ndev = grid.mesh.devices.size
        if dc_dist_supported(n, ndev):
            fn = functools.partial(tridiag_eigh_dist, d, e, grid.mesh)
            get = lambda out: (np.asarray(out[0])[:n],
                               np.asarray(out[1])[:n, :n])
        else:
            fn = functools.partial(tridiag_eigh, d, e, mesh=grid.mesh)
            get = lambda out: (np.asarray(out[0]), np.asarray(out[1]))
    else:
        fn = functools.partial(tridiag_eigh, d, e)
        get = lambda out: (np.asarray(out[0]), np.asarray(out[1]))

    def check(out):
        lam, q = get(out)
        t = np.diag(np.asarray(d)) + np.diag(np.asarray(e), 1) + np.diag(np.asarray(e), -1)
        orth = np.max(np.abs(q.T @ q - np.eye(n)))
        res = np.max(np.abs(t @ q - q * lam[None, :]))
        ok = orth <= 500 * n * eps(dtype) and res <= 500 * n * eps(dtype)
        return ok, f"orth {orth:.2e} res {res:.2e}"

    options.run_timed(args, fn, 0, check_fn=check)


if __name__ == "__main__":
    main()
