"""Reduction-to-band miniapp (reference ``miniapp/miniapp_reduction_to_band.cpp``):
GFlop/s with add = mul ~= 2 n^3 / 3 (band << n)."""
from __future__ import annotations

import functools

import jax
import numpy as np

from dlaf_jax.algos.eigensolver.red2band import extract_band, reduction_to_band
from dlaf_jax.matrix import generators as gen
from dlaf_jax.types import eps, total_ops

from . import options


def main(argv=None):
    args = options.parser("miniapp_reduction_to_band").parse_args(argv)
    dtype = options.dtype_of(args)
    a = options.load_input(args, lambda: gen.random_hermitian(
        jax.random.PRNGKey(0), args.matrix_size, dtype))
    n = args.matrix_size
    band = args.band_size or min(args.block_size, 128)
    if n % band:
        raise SystemExit("matrix-size must be a multiple of band-size")

    grid = options.grid_of(args)
    if grid is not None:
        # distributed stage 1 uses band == distribution block size
        from dlaf_jax.algos.eigensolver.dist_red2band import reduction_to_band_dist
        from dlaf_jax.matrix.dist_matrix import DistMatrix
        dm = DistMatrix.from_global(a, band, grid)
        fn = functools.partial(reduction_to_band_dist, dm)
        get_packed = lambda out: np.asarray(out[0].to_global())
    else:
        fn = functools.partial(reduction_to_band, a, band)
        get_packed = lambda out: np.asarray(out[0])
    flops = total_ops(dtype, 2 * n**3 / 3, 2 * n**3 / 3)

    def check(out):
        packed = get_packed(out)
        bandm = np.asarray(extract_band(packed, band))
        ev = np.linalg.eigvalsh(bandm)
        ref = np.linalg.eigvalsh(np.asarray(a))
        err = np.max(np.abs(ev - ref)) / max(np.max(np.abs(ref)), 1)
        return err <= 500 * n * eps(dtype), f"eig err {err:.2e}"

    out = options.run_timed(args, fn, flops, check_fn=check)
    if args.output_file:
        # reference contract (miniapp_reduction_to_band.cpp:184-185): the
        # input matrix plus the reduced (band + reflectors) matrix
        from dlaf_jax.matrix.io import MatrixFile
        MatrixFile(args.output_file).write(
            **{args.input_dataset: np.asarray(a), "/band": get_packed(out)})
        print(f"output: {args.output_file}")


if __name__ == "__main__":
    main()
