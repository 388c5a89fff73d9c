"""POTRF timing on one GPU (a stand-in until the benchmark is rebuilt).

    python bench.py [-n 20480] [--nb 512] [--nruns 3]

Factors one random f64 hermitian positive definite matrix with
``dlaf_jax.potrf`` (lower), checks the residual on the device, and prints
the card (name and power limit from nvidia-smi), then one JSON line with
the median wall time of the warm runs. Runs in one process and exits
non-zero without a GPU.
"""
import argparse
import json
import statistics
import sys
import time

import jax
import jax.numpy as jnp

import chip_smoke
import dlaf_jax as dt
from dlaf_jax.cache import configure_compilation_cache
from dlaf_jax.matrix import generators as gen


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-n", type=int, default=20480)
    p.add_argument("--nb", type=int, default=512)
    p.add_argument("--nruns", type=int, default=3)
    args = p.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU found (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    configure_compilation_cache()
    card = chip_smoke.card_line()
    print(card, flush=True)

    a = gen.random_hermitian_positive_definite(jax.random.PRNGKey(1), args.n,
                                               jnp.float64)
    fn = dt.potrf.lower(a, uplo="L", nb=args.nb).compile()
    times = []
    for _ in range(args.nruns + 1):
        t0 = time.perf_counter()
        f = jax.block_until_ready(fn(a))
        times.append(time.perf_counter() - t0)
    gate = chip_smoke.chol_gates(a, f, "L")[0]
    t = statistics.median(times[1:])
    print(json.dumps({
        "metric": f"potrf_f64_n{args.n}_nb{args.nb}_wall_s", "value": t,
        "unit": "s", "tflops": args.n ** 3 / 3 / t / 1e12,
        "residual": gate.value, "bound": gate.bound, "ok": gate.ok,
        "card": card, "device_kind": dev.device_kind}), flush=True)
    return 0 if gate.ok else 1


if __name__ == "__main__":
    sys.exit(main())
