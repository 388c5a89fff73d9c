"""Gen-to-std miniapp (reference ``miniapp/miniapp_gen_to_std.cpp``).

GFlop/s with add = mul = n^3/2.
"""
from __future__ import annotations

import functools

import jax
import numpy as np

import dlaf_jax as dt
from dlaf_jax.algos.gen_to_std import generalized_to_standard
from dlaf_jax.matrix import generators as gen
from dlaf_jax.types import eps, total_ops

from . import options


def main(argv=None):
    args = options.parser("miniapp_gen_to_std").parse_args(argv)
    n, nb = args.matrix_size, args.block_size
    dtype = options.dtype_of(args)
    a = gen.random_hermitian(jax.random.PRNGKey(0), n, dtype)
    b = gen.random_hermitian_positive_definite(jax.random.PRNGKey(1), n, dtype)
    l = dt.potrf(b, nb=min(nb, 512))

    grid = options.grid_of(args)
    if grid is not None:
        from dlaf_jax.algos.gen_to_std import generalized_to_standard_dist
        from dlaf_jax.matrix.dist_matrix import DistMatrix
        da = DistMatrix.from_global(a, nb, grid)
        dl = DistMatrix.from_global(np.tril(np.asarray(l)), nb, grid,
                                    pad_identity=True)
        fn = functools.partial(generalized_to_standard_dist, da, dl)
        get = lambda out: np.asarray(out.to_global())
    else:
        jfn = jax.jit(lambda aa, ll: generalized_to_standard(aa, ll, nb=min(nb, 512)))
        fn = functools.partial(jfn, a, l)
        get = np.asarray
    flops = total_ops(dtype, n**3 / 2, n**3 / 2)

    def check(out):
        ln = np.tril(np.asarray(l))
        linv = np.linalg.inv(ln)
        ref = linv @ np.asarray(a) @ linv.conj().T
        got = get(out)
        res = np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1)
        return res <= 1000 * n * eps(dtype), f"residual {res:.2e}"

    options.run_timed(args, fn, flops, check_fn=check)


if __name__ == "__main__":
    main()
