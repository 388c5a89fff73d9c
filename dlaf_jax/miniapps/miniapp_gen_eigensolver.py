"""Generalized eigensolver miniapp (reference ``miniapp/miniapp_gen_eigensolver.cpp``)."""
from __future__ import annotations

import functools

import jax
import numpy as np

import dlaf_jax as dt
from dlaf_jax.matrix import generators as gen
from dlaf_jax.types import eps

from . import options


def main(argv=None):
    p = options.parser("miniapp_gen_eigensolver")
    # reference miniapp_gen_eigensolver.cpp:279-280 dataset names
    p.add_argument("--input-dataset-a", default="/input-a")
    p.add_argument("--input-dataset-b", default="/input-b")
    args = p.parse_args(argv)
    dtype = options.dtype_of(args)
    if args.input_file:
        import jax.numpy as jnp

        from dlaf_jax.matrix.io import MatrixFile
        f = MatrixFile(args.input_file)
        a = jnp.asarray(f.read(args.input_dataset_a), dtype)
        b = jnp.asarray(f.read(args.input_dataset_b), dtype)
        args.matrix_size = a.shape[0]
    else:
        a = gen.random_hermitian(jax.random.PRNGKey(0), args.matrix_size,
                                 dtype)
        b = gen.random_hermitian_positive_definite(jax.random.PRNGKey(1),
                                                   args.matrix_size, dtype)
    n = args.matrix_size

    grid = options.grid_of(args)
    if grid is not None:
        from dlaf_jax.algos.eigensolver.dist_driver import eigh_gen_dist
        from dlaf_jax.matrix.dist_matrix import DistMatrix
        da = DistMatrix.from_global(a, args.block_size, grid)
        db = DistMatrix.from_global(b, args.block_size, grid, pad_identity=True)
        fn = functools.partial(eigh_gen_dist, da, db)
        get = lambda out: (np.asarray(out[0]), np.asarray(out[1].to_global()))
    else:
        fn = functools.partial(dt.eigh_gen, a, b, uplo=args.uplo)
        get = lambda out: (np.asarray(out[0]), np.asarray(out[1]))

    def check(out):
        w, x = get(out)
        an, bn = np.asarray(a), np.asarray(b)
        c = max(np.max(np.abs(an)), 1.0)
        res = np.max(np.abs(an @ x - bn @ x * w[None, :]))
        borth = np.max(np.abs(x.conj().T @ bn @ x - np.eye(n)))
        ok = res <= 2000 * n * eps(dtype) * c and borth <= 2000 * n * eps(dtype)
        return ok, f"res {res:.2e} B-orth {borth:.2e}"

    out = options.run_timed(args, fn, 0, check_fn=check)
    if args.output_file:
        # reference contract (miniapp_gen_eigensolver.cpp:208-211)
        from dlaf_jax.matrix.io import MatrixFile
        w, x = get(out)
        MatrixFile(args.output_file).write(
            **{args.input_dataset_a: np.asarray(a),
               args.input_dataset_b: np.asarray(b),
               "/evals": w, "/evecs": x})
        print(f"output: {args.output_file}")


if __name__ == "__main__":
    main()
