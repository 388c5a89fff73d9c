"""Eigensolver miniapp (reference ``miniapp/miniapp_eigensolver.cpp``):
wall time per solve + correctness gates (orthonormality and residual)."""
from __future__ import annotations

import functools

import jax
import numpy as np

import dlaf_jax as dt
from dlaf_jax.matrix import generators as gen
from dlaf_jax.types import eps

from . import options


def main(argv=None):
    args = options.parser("miniapp_eigensolver").parse_args(argv)
    dtype = options.dtype_of(args)
    a = options.load_input(args, lambda: gen.random_hermitian(
        jax.random.PRNGKey(0), args.matrix_size, dtype))
    n = args.matrix_size
    band = args.band_size

    grid = options.grid_of(args)
    if grid is not None:
        from dlaf_jax.algos.eigensolver.dist_driver import eigh_dist
        from dlaf_jax.matrix.dist_matrix import DistMatrix
        dm = DistMatrix.from_global(a, args.block_size, grid)
        fn = functools.partial(eigh_dist, dm)
        get = lambda out: (np.asarray(out[0]), np.asarray(out[1].to_global()))
    else:
        fn = functools.partial(dt.eigh, a, uplo=args.uplo, band=band)
        get = lambda out: (np.asarray(out[0]), np.asarray(out[1]))

    def check(out):
        w, v = get(out)
        an = np.asarray(a)
        c = max(np.max(np.abs(an)), 1.0)
        orth = np.max(np.abs(v.conj().T @ v - np.eye(n)))
        res = np.max(np.abs(an @ v - v * w[None, :]))
        ok = orth <= 500 * n * eps(dtype) and res <= 1000 * n * eps(dtype) * c
        return ok, f"orth {orth:.2e} res {res:.2e}"

    out = options.run_timed(args, fn, 0, check_fn=check)
    if args.output_file:
        # reference --output-file contract (miniapp_eigensolver.cpp:169-180):
        # the input matrix under --input-dataset plus /evals and /evecs
        from dlaf_jax.matrix.io import MatrixFile
        w, v = get(out)
        MatrixFile(args.output_file).write(**{args.input_dataset: np.asarray(a),
                                              "/evals": w, "/evecs": v})
        print(f"output: {args.output_file}")


if __name__ == "__main__":
    main()
