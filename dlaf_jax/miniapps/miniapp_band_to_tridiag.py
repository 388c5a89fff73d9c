"""Band-to-tridiagonal miniapp (reference ``miniapp/miniapp_band_to_tridiag.cpp``)."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dlaf_jax.algos.eigensolver.band2tridiag import band_to_tridiag
from dlaf_jax.matrix import generators as gen
from dlaf_jax.types import eps

from . import options


def main(argv=None):
    args = options.parser("miniapp_band_to_tridiag").parse_args(argv)
    n = args.matrix_size
    band = args.band_size or min(args.block_size, 128)
    dtype = options.dtype_of(args)
    a = gen.random_hermitian(jax.random.PRNGKey(0), n, dtype)
    rows = jnp.arange(n)
    mask = jnp.abs(rows[:, None] - rows[None, :]) <= band
    bandm = jnp.where(mask, a, 0)

    grid = options.grid_of(args)
    if grid is not None:
        from dlaf_jax.algos.eigensolver.band_strips import band_to_strips
        from dlaf_jax.algos.eigensolver.dist_stage23 import band_to_tridiag_dist
        strips = band_to_strips(bandm, band)
        # 3 trailing zero slack strips (strips_from_packed_dist layout)
        strips = jnp.pad(strips, ((0, 3), (0, 0), (0, 0)))
        fn = functools.partial(band_to_tridiag_dist, strips, n, band, grid.mesh)
    else:
        fn = functools.partial(band_to_tridiag, bandm, band)

    def check(out):
        d, e, _, _ = out
        t = np.diag(np.asarray(d)) + np.diag(np.asarray(e), 1) + np.diag(np.asarray(e), -1)
        ev = np.linalg.eigvalsh(t)
        ref = np.linalg.eigvalsh(np.asarray(bandm))
        err = np.max(np.abs(ev - ref)) / max(np.max(np.abs(ref)), 1)
        return err <= 500 * n * eps(dtype), f"eig err {err:.2e}"

    options.run_timed(args, fn, 0, check_fn=check)


if __name__ == "__main__":
    main()
