"""Shared miniapp CLI options, timing and output contract.

Mirrors the reference miniapp framework
(``miniapp/include/dlaf/miniapp/options.h``, ``dispatch.h``): common flags
(--matrix-size, --block-size, --grid-rows/cols, --nruns, --nwarmups, --check,
--type), warmup-excluded timing between full synchronization fences, and the
parseable ``CSVData-2`` output row (``miniapp/miniapp_cholesky.cpp:165-189``)
so the reference's postprocessing/plot scripts carry over.
"""
from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp


def parser(name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=name)
    p.add_argument("--matrix-size", "-n", type=int, default=2048)
    p.add_argument("--block-size", "-b", type=int, default=256)
    p.add_argument("--m", type=int, default=None, help="rows of B (solver/mult)")
    p.add_argument("--grid-rows", type=int, default=1)
    p.add_argument("--grid-cols", type=int, default=1)
    p.add_argument("--nruns", type=int, default=3)
    p.add_argument("--nwarmups", type=int, default=1)
    p.add_argument("--check", action="store_true")
    p.add_argument("--type", choices=["s", "d", "c", "z"], default="s",
                   help="s=float32, d=float64, c=complex64, z=complex128 "
                        "(reference dispatch.h:17-60 dispatches all four)")
    p.add_argument("--uplo", choices=["L", "U"], default="L")
    p.add_argument("--band-size", type=int, default=None)
    p.add_argument("--csv", action="store_true", default=True)
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a JAX profiler trace of the timed runs to "
                        "DIR (view with tensorboard / xprof; the analog of "
                        "the reference's per-run timing instrumentation)")
    p.add_argument("--input-file", default=None, metavar="FILE",
                   help="load the input matrix from FILE instead of "
                        "generating it (.h5/.hdf5 in the reference's HDF5 "
                        "layout, else .npz; reference "
                        "miniapp_eigensolver.cpp --input-file)")
    p.add_argument("--input-dataset", default="/input",
                   help="dataset name inside --input-file (default /input)")
    p.add_argument("--output-file", default=None, metavar="FILE",
                   help="write the input matrix and results of the last "
                        "run to FILE (reference --output-file contract: "
                        "input dataset + /evals + /evecs)")
    return p


def load_input(args, default_gen):
    """Input matrix: --input-file dataset if given (cast to --type, size
    overridden by the file), else ``default_gen()``. Returns the array and
    updates ``args.matrix_size`` to match."""
    if not args.input_file:
        return default_gen()
    from ..matrix.io import MatrixFile
    a = MatrixFile(args.input_file).read(args.input_dataset)
    args.matrix_size = a.shape[0]
    return jnp.asarray(a, dtype_of(args))


def dtype_of(args):
    if args.type in ("d", "z"):
        jax.config.update("jax_enable_x64", True)
    return {"s": jnp.float32, "d": jnp.float64,
            "c": jnp.complex64, "z": jnp.complex128}[args.type]


def grid_of(args):
    """Device grid when --grid-rows/cols request a distributed run, else
    None (reference miniapps dispatch local vs distributed on the grid)."""
    if args.grid_rows * args.grid_cols > 1:
        from ..comm.mesh import Grid
        return Grid((args.grid_rows, args.grid_cols))
    return None


def sync(x):
    """Fence: wait for every array of ``x`` (the analog of
    waitLocalTiles() + MPI_Barrier in the reference timing discipline)."""
    jax.block_until_ready(x)


def run_timed(args, fn, flop_count, extra=(), check_fn=None):
    """Warmups + timed runs; prints per-run line + CSVData-2 row."""
    backend = jax.default_backend()
    assert args.nwarmups + args.nruns >= 1, "need at least one run"
    out = None
    tracing = False
    for r in range(args.nwarmups + args.nruns):
        if getattr(args, "trace", None) and r == args.nwarmups and not tracing:
            jax.profiler.start_trace(args.trace)
            tracing = True
        t0 = time.perf_counter()
        out = fn()
        sync(out)
        t = time.perf_counter() - t0
        if r < args.nwarmups:
            continue
        run = r - args.nwarmups
        gflops = flop_count / t / 1e9 if flop_count else 0.0
        print(f"[{run}] {t:.6f}s {gflops:.2f}GFlop/s "
              f"({args.matrix_size}, {args.block_size}) "
              f"({args.grid_rows}, {args.grid_cols}) {backend}")
        if args.csv:
            row = ["CSVData-2", str(run), f"{t:.6f}", f"{gflops:.2f}",
                   args.type, args.uplo, str(args.matrix_size),
                   str(args.block_size), str(args.grid_rows),
                   str(args.grid_cols), "1", backend, *map(str, extra)]
            print(", ".join(row))
    if tracing:
        jax.profiler.stop_trace()
        print(f"trace: {args.trace}")
    if args.check and check_fn is not None:
        ok, msg = check_fn(out)
        print(f"check: {'PASSED' if ok else 'FAILED'} ({msg})")
        if not ok:
            raise SystemExit(1)
    return out
