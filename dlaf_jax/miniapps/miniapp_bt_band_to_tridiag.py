"""Back-transform (band->tridiag) miniapp
(reference ``miniapp/miniapp_bt_band_to_tridiag.cpp``)."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from dlaf_jax.algos.eigensolver.band2tridiag import band_to_tridiag
from dlaf_jax.algos.eigensolver.bt import bt_band_to_tridiag
from dlaf_jax.matrix import generators as gen
from . import options


def main(argv=None):
    args = options.parser("miniapp_bt_band_to_tridiag").parse_args(argv)
    n = args.matrix_size
    band = args.band_size or min(args.block_size, 128)
    dtype = options.dtype_of(args)
    a = gen.random_hermitian(jax.random.PRNGKey(0), n, dtype)
    rows = jnp.arange(n)
    bandm = jnp.where(jnp.abs(rows[:, None] - rows[None, :]) <= band, a, 0)
    emat = gen.random_general(jax.random.PRNGKey(1), (n, n), dtype)

    grid = options.grid_of(args)
    if grid is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from dlaf_jax.algos.eigensolver.band_strips import band_to_strips
        from dlaf_jax.algos.eigensolver.dist_stage23 import (
            band_to_tridiag_dist, bt_band_to_tridiag_dist)
        from dlaf_jax.comm.mesh import COL_AXIS, ROW_AXIS
        strips = jnp.pad(band_to_strips(bandm, band), ((0, 3), (0, 0), (0, 0)))
        _, _, vs, taus = band_to_tridiag_dist(strips, n, band, grid.mesh)
        qc = jax.device_put(emat, NamedSharding(
            grid.mesh, P(None, (ROW_AXIS, COL_AXIS))))
        fn = functools.partial(bt_band_to_tridiag_dist, qc, vs, taus, band,
                               n, grid.mesh)
    else:
        d, e, vs, taus = band_to_tridiag(bandm, band)
        fn = functools.partial(bt_band_to_tridiag, emat, vs, taus, band)

    check_fn = None
    if args.check and grid is None:
        import numpy as np
        from dlaf_jax.types import eps

        def check_fn(out):
            # Q2 satisfies band = Q2 T Q2^H, hence band (Q2 E) = Q2 (T E):
            # compare the timed result against the back-transform of T E.
            tmat = jnp.diag(d.astype(dtype)) + jnp.diag(e, -1) + \
                jnp.diag(jnp.conj(e), 1)
            # explicit f32 precision: the check's own matmuls would
            # otherwise run at default precision (TF32 on the GPU) and
            # swamp the bound
            lhs = np.asarray(jnp.matmul(bandm, out, precision="float32"))
            rhs = np.asarray(bt_band_to_tridiag(
                jnp.matmul(tmat, emat, precision="float32"),
                vs, taus, band))
            scale = max(float(jnp.max(jnp.abs(bandm))), 1.0) * \
                max(float(jnp.max(jnp.abs(emat))), 1.0)
            err = float(np.max(np.abs(lhs - rhs)))
            tol = 200 * n * eps(dtype) * scale
            return err <= tol, f"commutation err {err:.2e} tol {tol:.2e}"

    # 2 * 2 * n * nev flops per reflector row-block application ~ 4 n^2 nev / b
    options.run_timed(args, fn, 0, check_fn=check_fn)


if __name__ == "__main__":
    main()
