"""Single-tile kernel micro-benchmark.

The analog of the reference's KernelRunner micro-bench harness
(``miniapp/include/dlaf/miniapp/kernel_runner.h``,
``miniapp/kernel/miniapp_laset.cpp``): times one tile kernel over a batch of
independent tiles, reporting per-call latency and throughput. A batch of
tiles is one vmapped kernel launch — the idiomatic equivalent of the
reference's stream-parallel kernel sweep.

Kernels: potrf (tile Cholesky), trsm (tile triangular solve), gemm
(single-tile matmul), laset (set constant), lacpy (tile copy), add (masked
alpha-add).
"""
from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp

from ..ops.leaf import potrf_leaf, trsm_leaf
from ..ops.core import mm, set_tri
from . import options


def _batch(key, count, nb, dtype):
    return jax.random.normal(key, (count, nb, nb), dtype)


def main(argv=None):
    p = argparse.ArgumentParser(prog="kernel_runner")
    p.add_argument("--kernel", choices=["potrf", "trsm", "gemm", "laset",
                                        "lacpy", "add"],
                   default="gemm")
    p.add_argument("--block-size", "-b", type=int, default=512)
    p.add_argument("--count", type=int, default=64, help="tiles per launch")
    p.add_argument("--nruns", type=int, default=3)
    p.add_argument("--nwarmups", type=int, default=1)
    p.add_argument("--type", choices=["s", "d"], default="s")
    args = p.parse_args(argv)

    nb, count = args.block_size, args.count
    dtype = jnp.float64 if args.type == "d" else jnp.float32
    if args.type == "d":
        jax.config.update("jax_enable_x64", True)
    key = jax.random.PRNGKey(0)
    tiles = _batch(key, count, nb, dtype)
    spd = jnp.einsum("bij,bkj->bik", tiles, tiles) \
        + 4 * nb * jnp.eye(nb, dtype=dtype)[None]
    tri = jnp.tril(tiles) + 4 * jnp.eye(nb, dtype=dtype)[None]

    # (fn, args, flops-per-tile)
    kernels = {
        "potrf": (jax.vmap(potrf_leaf), (spd,), nb**3 / 3),
        "trsm": (jax.vmap(lambda a, b: trsm_leaf(
            a, b, left=True, lower=True, trans="N", unit=False)),
            (tri, tiles), nb**3),
        "gemm": (jax.vmap(lambda a, b: mm(a, b)), (tiles, tiles), 2 * nb**3),
        "laset": (jax.vmap(lambda a: jnp.full_like(a, 0.5)), (tiles,), 0),
        "lacpy": (jax.vmap(lambda a: a + 0.0), (tiles,), 0),
        "add": (jax.vmap(lambda a, b: set_tri(b, b + 0.5 * a, True)),
                (tiles, spd), 0),
    }
    fn, fargs, flops = kernels[args.kernel]
    jfn = jax.jit(fn)

    backend = jax.default_backend()
    for r in range(args.nwarmups + args.nruns):
        t0 = time.perf_counter()
        out = jfn(*fargs)
        options.sync(out)
        t = time.perf_counter() - t0
        if r < args.nwarmups:
            continue
        per = t / count
        gflops = flops / per / 1e9 if flops else 0.0
        print(f"[{r - args.nwarmups}] {args.kernel} b={nb} x{count}: "
              f"{per*1e6:.1f} us/tile {gflops:.2f}GFlop/s {backend}")


if __name__ == "__main__":
    main()
