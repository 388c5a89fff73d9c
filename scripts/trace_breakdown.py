"""Device-time breakdown of one entry point from a JAX profiler trace.

    python scripts/trace_breakdown.py potrf [-n 20480] [--nb 512]
    python scripts/trace_breakdown.py trsm  [-n 20480] [--nb 512] [--nrhs 2048]
    python scripts/trace_breakdown.py eigh  [-n 10240]

Compiles and runs the entry point once, then runs it again under
``jax.profiler`` with a perfetto trace, and sums the device kernel time by
class (Cholesky leaf, triangular solve, GEMM, other) and by kernel. The
per-kernel table goes to ``--out`` (default ``chiprun_out/``).
"""
import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys
import tempfile

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dlaf_jax as dt  # noqa: E402
from dlaf_jax.cache import configure_compilation_cache  # noqa: E402
from dlaf_jax.matrix import generators as gen  # noqa: E402

CLASSES = (("cholesky leaf", re.compile(r"potrf|chol", re.I)),
           ("triangular solve", re.compile(r"trsm|triangular", re.I)),
           ("gemm", re.compile(r"gemm|dot|cutlass|xmma|sm90|sm80", re.I)))


def _entry(args):
    dtype = jnp.float64
    if args.what in ("potrf", "trsm"):
        a = gen.random_hermitian_positive_definite(jax.random.PRNGKey(1),
                                                   args.n, dtype)
        if args.what == "potrf":
            return lambda: dt.potrf(a, uplo="L", nb=args.nb)
        l = dt.potrf(a, uplo="L", nb=args.nb)
        b = gen.random_general(jax.random.PRNGKey(2), (args.n, args.nrhs),
                               dtype)
        return lambda: dt.trsm(l, b, side="L", uplo="L", trans="N",
                               nb=args.nb)
    a = gen.random_hermitian(jax.random.PRNGKey(3), args.n, dtype)
    eigh = jax.jit(dt.eigh)
    return lambda: eigh(a)


def device_events(trace_dir):
    """(kernel name, hlo op, microseconds) of every device event."""
    path = glob.glob(os.path.join(trace_dir, "**", "perfetto_trace.json.gz"),
                     recursive=True)[0]
    with gzip.open(path) as f:
        tr = json.load(f)
    ev = tr["traceEvents"] if isinstance(tr, dict) else tr
    pids = {e["pid"]: e["args"]["name"] for e in ev
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    for e in ev:
        if e.get("ph") == "X" and "/device:" in pids.get(e["pid"], ""):
            args = e.get("args", {})
            yield e["name"], str(args.get("hlo_op", "")), float(e.get("dur", 0))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("what", choices=["potrf", "trsm", "eigh"])
    p.add_argument("-n", type=int, default=20480)
    p.add_argument("--nb", type=int, default=512)
    p.add_argument("--nrhs", type=int, default=2048)
    p.add_argument("--out", default="chiprun_out")
    args = p.parse_args(argv)
    jax.config.update("jax_enable_x64", True)
    configure_compilation_cache()

    fn = _entry(args)
    jax.block_until_ready(fn())
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d, create_perfetto_trace=True):
            jax.block_until_ready(fn())
        events = list(device_events(d))

    total = sum(t for _, _, t in events)
    by_class = collections.Counter()
    by_kernel = collections.Counter()
    for name, op, t in events:
        cls = next((c for c, rx in CLASSES if rx.search(name + " " + op)),
                   "other")
        by_class[cls] += t
        by_kernel[(cls, name[:100], op)] += t
    print(f"{args.what} n={args.n} nb={args.nb}: device time "
          f"{total / 1e3:.3f} ms over {len(events)} kernels")
    for cls, t in by_class.most_common():
        print(f"  {cls:18s} {t / 1e3:10.3f} ms  {t / max(total, 1):6.1%}")
    os.makedirs(args.out, exist_ok=True)
    table = os.path.join(args.out, f"trace_{args.what}_n{args.n}.txt")
    with open(table, "w") as f:
        for (cls, name, op), t in by_kernel.most_common():
            f.write(f"{t / 1e3:10.3f} ms  {cls:18s} {op:24s} {name}\n")
    print(f"kernel table: {table}")


if __name__ == "__main__":
    main()
