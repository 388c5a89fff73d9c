"""Back-transform (reduction->band) miniapp
(reference ``miniapp/miniapp_bt_reduction_to_band.cpp``)."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from dlaf_jax.algos.eigensolver.bt import bt_reduction_to_band
from dlaf_jax.algos.eigensolver.red2band import reduction_to_band
from dlaf_jax.matrix import generators as gen
from dlaf_jax.types import total_ops

from . import options


def main(argv=None):
    args = options.parser("miniapp_bt_reduction_to_band").parse_args(argv)
    n = args.matrix_size
    band = args.band_size or min(args.block_size, 128)
    if n % band:
        raise SystemExit("matrix-size must be a multiple of band-size")
    dtype = options.dtype_of(args)
    a = gen.random_hermitian(jax.random.PRNGKey(0), n, dtype)
    emat = gen.random_general(jax.random.PRNGKey(1), (n, n), dtype)

    grid = options.grid_of(args)
    if grid is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from dlaf_jax.algos.eigensolver.dist_red2band import reduction_to_band_dist
        from dlaf_jax.algos.eigensolver.dist_stage23 import bt_reduction_to_band_dist
        from dlaf_jax.comm.mesh import COL_AXIS, ROW_AXIS
        from dlaf_jax.matrix.dist_matrix import DistMatrix
        dm = DistMatrix.from_global(a, band, grid)
        packed, taus = reduction_to_band_dist(dm)
        pm = packed.dist.padded_size[0]
        qc = jnp.pad(emat, ((0, pm - n), (0, pm - n)))
        qc = jax.device_put(qc, NamedSharding(
            grid.mesh, P(None, (ROW_AXIS, COL_AXIS))))
        fn = functools.partial(bt_reduction_to_band_dist, qc, packed, taus)
    else:
        packed, taus = reduction_to_band(a, band)
        fn = functools.partial(bt_reduction_to_band, emat, packed, taus, band)

    check_fn = None
    if args.check and grid is None:
        import numpy as np
        from dlaf_jax.algos.eigensolver.red2band import extract_band
        from dlaf_jax.types import eps

        def check_fn(out):
            # Q satisfies A = Q B Q^H (B = band form), hence A (Q E) = Q (B E):
            # compare the timed result against the back-transform of B E.
            bmat = extract_band(packed, band)
            # explicit f32 precision: the check's own matmuls would
            # otherwise run at default precision (TF32 on the GPU) and
            # swamp the bound
            lhs = np.asarray(jnp.matmul(
                jnp.tril(a) + jnp.tril(a, -1).conj().T, out,
                precision="float32"))
            rhs = np.asarray(bt_reduction_to_band(
                jnp.matmul(bmat, emat, precision="float32"),
                packed, taus, band))
            scale = max(float(jnp.max(jnp.abs(a))), 1.0) * \
                max(float(jnp.max(jnp.abs(emat))), 1.0)
            err = float(np.max(np.abs(lhs - rhs)))
            tol = 200 * n * eps(dtype) * scale
            return err <= tol, f"commutation err {err:.2e} tol {tol:.2e}"

    flops = total_ops(dtype, 2 * n**3, 2 * n**3)  # ~4 n^2 nev with nev = n
    options.run_timed(args, fn, flops, check_fn=check_fn)


if __name__ == "__main__":
    main()
